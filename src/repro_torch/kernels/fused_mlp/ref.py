"""Plain PyTorch oracle for the fused SwiGLU MLP kernel (the semantics
of ``repro.kernels.fused_mlp.ref.fused_mlp_ref``): h in fp32, rounded to
x.dtype before the W2 product, fp32 accumulation."""
import torch.nn.functional as F


def fused_mlp_ref(x, w1, w3, w2):
    """x [M, K]; w1/w3 [K, F]; w2 [F, K] -> [M, K] in x.dtype."""
    x32 = x.float()
    h = F.silu(x32 @ w1.float()) * (x32 @ w3.float())
    y = h.to(x.dtype).float() @ w2.float()
    return y.to(x.dtype)
