"""Float8 matrix products for the control: the reference computed one
precision below the configurations' bfloat16.

Each operand is scaled so its largest magnitude maps to e4m3's largest
finite value (448), rounded to ``torch.float8_e4m3fn``, and widened
back; the product of the rounded operands is summed in float32, as a
float8 tensor-core product with per-tensor scales sums. Under autograd
the backward's products round their operands (the incoming gradient
included) the same way.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, in float32."""
    t = t.float()
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, dy):
        qa, qb = ctx.saved_tensors
        qd = round_fp8(dy)
        da = torch.matmul(qd, qb.transpose(-1, -2))
        db = torch.matmul(qa.transpose(-1, -2), qd)
        # broadcast operands (a 2-D weight against batched rows) sum back
        while da.dim() > qa.dim():
            da = da.sum(0)
        while db.dim() > qb.dim():
            db = db.sum(0)
        return da, db


def fp8_matmul(a, b):
    """``a @ b`` (broadcasting as ``torch.matmul``) with float8 operands."""
    return _Fp8MatMul.apply(a, b)
