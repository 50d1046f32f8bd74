"""Plain PyTorch version of the Mamba-2 chain's kernels: the port's torch
chain around the SSD scan (``models.ssm._block``), as it ran before the
kernels, op for op. On the card it rounds to the working dtype after
every op; the kernels (``ops``) sum in fp32 and round once.

The JAX reference runs the same chain as plain jnp
(``repro.models.ssm.mamba2_block``); no Pallas kernel stands behind it.
"""
import torch
import torch.nn.functional as F

from ...models.common import rmsnorm


def causal_dw_conv(x, w):
    """Depthwise causal 1D conv. x [B,S,W], w [K,W]. The reference's sum
    of shifted products, so bf16 rounds at the same places."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i:i + s, :] * w[i] for i in range(k))


def conv_silu_ref(xin, bm, cm, wx, wb, wc, dt, dt_bias, a_log):
    """Before the scan: SiLU of the causal depthwise conv of the x, B and C
    projections xin [B,S,W], bm/cm [B,S,G*N] with weights wx [K,W], wb/wc
    [K,G*N]; softplus(dt + dt_bias) of dt [B,S,H] in fp32; A =
    -exp(A_log). Returns (xc, Bc, Cc, dt, A)."""
    xc = F.silu(causal_dw_conv(xin, wx))
    bc = F.silu(causal_dw_conv(bm, wb))
    cc = F.silu(causal_dw_conv(cm, wc))
    dt = F.softplus(dt.float() + dt_bias)
    return xc, bc, cc, dt, -torch.exp(a_log)


def gated_rmsnorm_ref(y, xc, z, d, gn_scale):
    """After the scan: the D skip, the SiLU gate and the gated RMSNorm of
    the scan's y [B,S,H,P] with xc and z [B,S,H*P]; d [H] and gn_scale
    [H*P] (fp32 leaves). Returns rmsnorm((y + D xc) silu(z)) * gn_scale
    as [B,S,H*P] in y's dtype."""
    b, s, h, p = y.shape
    y = y + d.to(y.dtype)[:, None] * xc.reshape(b, s, h, p)
    y = y.reshape(b, s, h * p)
    return rmsnorm(y * F.silu(z), gn_scale)
