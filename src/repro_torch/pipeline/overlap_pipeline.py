"""Overlap-scheduled pipeline parallelism (paper technique at mesh level).

PyTorch counterpart of ``repro.pipeline.overlap_pipeline``. PIM channels
holding consecutive layers map to pipeline stages on a mesh axis; the
paper's computational overlap (layer n+1 starts on the data spaces layer
n has finished) becomes a microbatch wavefront: stage s processes
microbatch m at tick t = m + s, and activations hop one stage a tick
around the ring s -> s+1 mod n over ``torch.distributed`` point-to-point
ops (``batch_isend_irecv``). A tick's sends are waited for only at the
end of the next tick, so they overlap its compute, as the reference's
``ppermute`` lets XLA overlap them.

The paper's *transformation* (re-sort data spaces by ready time) maps to
the microbatch emission order: ``overlap_schedule`` returns the
ascending ready-time order the wavefront uses (identity for uniform
arrivals).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models.common import tree_leaves, tree_map


def overlap_schedule(ready_times, step_ns: float = 1.0) -> np.ndarray:
    """Microbatch emission order from the paper's transformation: process
    in ascending input-ready order (stable). ``step_ns`` is the
    reference's argument, which its result does not depend on either."""
    return np.argsort(np.asarray(ready_times, np.float64), kind="stable")


def _stage_params(stage_params, sid: int):
    """This stage's slice of a tree with a leading [n_stages] axis: the
    local shard of a DTensor sharded on the stage axis, or row ``sid``
    of a full tensor."""
    def one(_, a):
        return a.to_local()[0] if isinstance(a, DTensor) else a[sid]
    return tree_map(one, stage_params)


def pipeline_forward(stage_fn: Callable, stage_params, x, mesh,
                     axis: str = "stage",
                     order: Optional[np.ndarray] = None):
    """Run ``n_micro`` microbatches through the stages of mesh axis
    ``axis``, one stage a rank.

    stage_fn(params_one_stage, act) -> act (same shape), applied by every
    rank to the microbatch resident on its stage; x [n_micro, ...]
    microbatches, the same on every rank; stage_params a tree with a
    leading [n_stages] axis (full tensors, or DTensors sharded on
    ``axis``). Returns [n_micro, ...], the last stage's outputs, on every
    rank. With one stage the hop is the identity.
    """
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    sid = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    n_micro = x.shape[0]
    if order is not None:
        x = x[torch.as_tensor(np.asarray(order), device=x.device)]
    p_one = _stage_params(stage_params, sid)
    nxt = dist.get_global_rank(group, (sid + 1) % n_stages)
    prv = dist.get_global_rank(group, (sid - 1) % n_stages)

    state = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    sends = []
    for t in range(n_micro + n_stages - 1):
        midx = t - sid                       # microbatch at this stage
        if 0 <= midx < n_micro:
            act = stage_fn(p_one, x[midx] if sid == 0 else state)
            if sid == n_stages - 1:
                outs[midx] = act
        else:
            act = state
        if n_stages == 1:
            state = act
            continue
        recv = torch.empty_like(act)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, act.contiguous(), nxt, group),
            dist.P2POp(dist.irecv, recv, prv, group)])
        for r in sends:                      # last tick's sends
            r.wait()
        *sends, recv_req = reqs
        recv_req.wait()
        state = recv
    for r in sends:
        r.wait()
    if n_stages > 1:
        # only the last stage holds real outputs; share them (the others
        # add zeros, so the sum is exact)
        if sid != n_stages - 1:
            outs.zero_()
        dist.all_reduce(outs, group=group)
    if order is not None:
        inv = np.empty_like(np.asarray(order))
        inv[np.asarray(order)] = np.arange(len(order))
        outs = outs[torch.as_tensor(inv, device=outs.device)]
    return outs


def sequential_reference(stage_fn: Callable, stage_params, x):
    """Oracle: apply all stages in order to every microbatch."""
    n_stages = next(tree_leaves(stage_params)).shape[0]

    def one(mb):
        for s in range(n_stages):
            mb = stage_fn(tree_map(lambda _, a: a[s], stage_params), mb)
        return mb

    return torch.stack([one(mb) for mb in x])
