"""Plain PyTorch oracle for the fused SwiGLU MLP kernel (the semantics
of ``repro.kernels.fused_mlp.ref.fused_mlp_ref``): h in fp32 (float64
for float64 inputs), rounded to x.dtype before the W2 product, fp32
accumulation."""
import torch
import torch.nn.functional as F


def fused_mlp_ref(x, w1, w3, w2):
    """x [M, K]; w1/w3 [K, F]; w2 [F, K] -> [M, K] in x.dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(acc)
    h = F.silu(x32 @ w1.to(acc)) * (x32 @ w3.to(acc))
    y = h.to(x.dtype).to(acc) @ w2.to(acc)
    return y.to(x.dtype)
