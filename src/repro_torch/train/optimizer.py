"""AdamW + cosine schedule + global-norm clipping, with the optimizer
state in fp32, and the top-k gradient-compression hook.

PyTorch counterpart of ``repro.train.optimizer``: the same fields,
defaults and arithmetic (``lr_schedule`` in fp32; decoupled weight decay
on every leaf, norm scales included). Trees are nested dicts of tensors.
Unlike the reference, whose arrays are immutable, ``adamw_update``
updates the params and the moments in place and returns them (the
reference's trainer donates them to the same effect), so full-width
training holds one copy of each. On a mesh the params and moments are
DTensors, the moments placed by the ZeRO specs
(``launch.sharding.opt_state_specs``): each gradient is reduced to its
moment's placements, the update runs on those shards, and the new
values are redistributed to the param's placements and copied in.

The update runs in two passes (``kernels.adamw``): the clip's norm, then
one read-modify-write of p, g, m and v a leaf. On plain CUDA leaves each
pass is a hand-written kernel, and the norm and the clip's factor stay
on the card; on DTensor leaves the norm is the mesh's reduction
(``global_norm``) and each local shard takes the step op; on the CPU
both are the plain torch versions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor import zeros as dtensor_zeros

from ..kernels.adamw import (adamw_step, adamw_sumsq, clip_scale_ref,
                             sumsq_ref)
from ..models.common import tree_get, tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine decay to ``min_lr_frac * lr``
    at ``total_steps``; ``step`` (int or integer tensor) in, an fp32
    scalar out, computed in fp32 as the reference does."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: PyTree,
                   placements: Optional[Dict] = None) -> Dict:
    """{"mu", "nu"}: fp32 zeros shaped like the params, on their devices;
    "step": an int32 scalar (a plain tensor, also on a mesh). For DTensor
    params, ``placements`` ({"mu": tree, "nu": tree} of placements, the
    ZeRO specs' of ``launch.sharding.opt_state_specs``) makes the moments
    DTensors on the params' mesh, each rank allocating its shard only."""
    device = next(tree_leaves(params)).device
    return {"mu": fp32_zeros(params, placements and placements["mu"]),
            "nu": fp32_zeros(params, placements and placements["nu"]),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def fp32_zeros(params: PyTree, placements: Optional[PyTree] = None
               ) -> PyTree:
    """fp32 zeros shaped like the params, on their devices; for DTensor
    params, DTensors of ``placements`` (a tree of placements) on the
    params' mesh, each rank allocating its shard only."""
    def one(path, p):
        if placements is None:
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return dtensor_zeros(p.shape, dtype=torch.float32,
                             device_mesh=p.device_mesh,
                             placements=tree_get(placements, path))
    return tree_map(one, params)


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32; over every
    shard of DTensor leaves (a plain scalar, the same on every rank)."""
    norm = torch.sqrt(sumsq_ref(tree_leaves(tree)))
    return norm.full_tensor() if isinstance(norm, DTensor) else norm


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    """(grads scaled so their global norm is at most ``max_norm``, as
    new fp32 tensors; the norm before clipping)."""
    norm = global_norm(grads)
    scale = clip_scale_ref(norm, max_norm)
    return tree_map(lambda _, g: g.float() * scale, grads), norm


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: PyTree, grads: PyTree,
                 state: Dict) -> Tuple[PyTree, Dict, Dict]:
    """One AdamW step (``repro/train/optimizer.py:adamw_update``): clip
    by the global norm, fp32 moments with bias correction, decoupled
    weight decay on every leaf; params and moments are updated in place
    and returned. ``grads`` mirrors ``params``; a ``None`` leaf is a zero
    gradient. Returns (params, state, {"grad_norm", "lr"})."""
    def zero_if_none(path, g):
        # A leaf autograd left without a gradient (None) has a zero
        # gradient: JAX gives such leaves (olmo's unread norm scales)
        # zeros, and they still decay.
        if g is not None:
            return g
        return torch.zeros_like(tree_get(params, path), dtype=torch.float32)

    def where_moments_live(path, g):
        # on a mesh: reduce each gradient to its moment's placements (a
        # partial sum over "data" becomes a reduce-scatter under ZeRO)
        m = tree_get(state["mu"], path)
        if isinstance(m, DTensor):
            return g.redistribute(m.device_mesh, m.placements)
        return g

    grads = tree_map(where_moments_live, tree_map(zero_if_none, grads))
    if any(isinstance(g, DTensor) for g in tree_leaves(grads)):
        gnorm = global_norm(grads)          # the mesh's reduction
        scale = clip_scale_ref(gnorm, cfg.clip_norm)
    else:
        gnorm, scale = adamw_sumsq(tree_leaves(grads), cfg.clip_norm)
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    t = step.to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, t)
    bc2 = 1 - torch.pow(cfg.b2, t)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["mu"]),
                          tree_leaves(state["nu"])):
        if not isinstance(m, DTensor):
            adamw_step(cfg, p, g, m, v, scale, lr, bc1, bc2)
            continue
        # ZeRO: update the shard that the moments hold (a contiguous copy
        # where the redistribution left a strided view), then bring the
        # new values back to the param's placements
        mesh, where = m.device_mesh, m.placements
        shard = p.redistribute(mesh, where).to_local().contiguous()
        adamw_step(cfg, shard, g.to_local().contiguous(), m.to_local(),
                   v.to_local(), scale, lr, bc1, bc2)
        new = DTensor.from_local(shard, mesh, where, run_check=False)
        p.to_local().copy_(new.redistribute(mesh, p.placements).to_local())
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def topk_compress(g: torch.Tensor, frac: float = 0.1) -> torch.Tensor:
    """Keep the top ``frac`` magnitudes of a gradient leaf (at least one):
    every element at or above the k-th largest magnitude survives, ties
    included, as with the reference's ``lax.top_k`` threshold."""
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(flat.abs() >= thresh, flat,
                       torch.zeros_like(flat)).reshape(g.shape)
