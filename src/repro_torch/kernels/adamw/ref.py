"""Plain PyTorch version of AdamW's two kernels: the port's torch update
(``train.optimizer``) as it ran before the kernels, op for op. The CPU
runs it, and on the card it is what the kernels (``ops``) are held to.

The JAX reference's AdamW is plain jnp as well
(``repro.train.optimizer.adamw_update``); no Pallas kernel stands behind
it.
"""
import torch


def sumsq_ref(leaves):
    """The sum of the squares of every leaf, in fp32 (a tensor; a partial
    DTensor for DTensor leaves)."""
    return sum(torch.sum(torch.square(g.float())) for g in leaves)


def clip_scale_ref(norm: torch.Tensor, clip: float) -> torch.Tensor:
    """The clip's factor: min(clip / max(norm, 1e-9), 1)."""
    return torch.clamp(clip / torch.clamp(norm, min=1e-9), max=1.0)


def adamw_step_ref(cfg, p, g, m, v, scale, lr, bc1, bc2) -> None:
    """One leaf's AdamW arithmetic on plain tensors, in place: the moments
    ``m``, ``v`` (fp32) and ``p`` (in its dtype, from fp32 values). ``cfg``
    gives b1, b2, eps and weight_decay; ``scale`` (the clip's), ``lr`` and
    the bias corrections ``bc1``, ``bc2`` are fp32 scalars."""
    g = g.float() * scale              # clipped, one leaf at a time
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
    u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    p32 = p.float()
    u.add_(cfg.weight_decay * p32)
    p.copy_(p32 - lr * u)
