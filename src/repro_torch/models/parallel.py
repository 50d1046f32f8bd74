"""The model functions on DTensors: the local calls and placements.

On a mesh the parameters, the batch and the caches are DTensors
(``launch.sharding``), and the model functions run on them as they are
wherever DTensor has a sharding rule for the op. This module holds what
it has no rule for, or where the rule would hide a fault:

  * ``local_call`` runs a function on the local shards of its DTensor
    arguments (``torch.distributed.tensor.experimental.local_map``) and
    wraps its outputs as DTensors of the stated placements. The kernels'
    autograd Functions and the ctypes wrappers read raw pointers, so a
    DTensor reaches a kernel only through it (each rank's kernel sees its
    shard). Its backward states each input's gradient placement: an input
    replicated over a mesh dim on which the call is split (another input
    or an output is sharded or partial there) gets a gradient that is a
    partial sum over that dim, and is declared ``Partial()``.
  * ``replicate_like`` makes a plain tensor (RoPE's tables, the vocab
    mask) a replicated DTensor on the mesh of the tensor it meets, since
    DTensor refuses to mix the two in one op.
  * ``gather_rows`` is the embedding lookup on local shards (DTensor's
    rule for the gather's backward differs between torch versions).
  * ``write`` writes into a slice of a cache on each rank's shard (a
    prompt's prefix into a KV cache whose sequence may be sharded).
  * ``to_batch`` keeps only an activation's batch sharding (the
    embeddings, sharded on d_model by the specs, are gathered over
    "model"), ``like`` reduces a sublayer's partial sum over "model" to
    the residual stream's placements before the add, and ``splittable``
    gathers a projection whose heads do not divide the model axis
    before it is split into them.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def replicate_like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t`` replicated on ``ref``'s mesh when ``ref`` is a DTensor, else
    ``t`` itself."""
    if not is_dtensor(ref):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def like(t, ref):
    """``t`` redistributed to ``ref``'s placements when both are DTensors
    (a sublayer's partial sum over "model" reduced before the residual
    add), else ``t`` itself."""
    if is_dtensor(t) and is_dtensor(ref) and t.placements != ref.placements:
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


def to_batch(t):
    """A DTensor activation with only its batch sharding kept (replicated
    over "model"), else ``t`` itself."""
    if not is_dtensor(t):
        return t
    return t.redistribute(t.device_mesh, batch_placements(t))


def gather_rows(table, ids):
    """``table[ids]`` (an embedding lookup). On a mesh, each rank gathers
    its batch shard's rows from its slice of the table's last dim (the
    specs shard d_model over "model"), so the result is sharded as the
    ids on the batch and as the table on its last dim; DTensor's own
    rule for the gather's backward differs between torch versions."""
    if not is_dtensor(table):
        return table[ids]
    mesh = table.device_mesh
    md = mesh.mesh_dim_names.index("model")
    cols = table.placements[md]
    cols = cols if isinstance(cols, Shard) and cols.dim == 1 else Replicate()
    tp = tuple(cols if d == md else Replicate() for d in range(mesh.ndim))
    ip = batch_placements(ids)
    out = tuple(Shard(ids.ndim) if d == md and isinstance(cols, Shard)
                else p for d, p in enumerate(ip))
    return local_call(lambda t, i: t[i], out, (tp, ip), table, ids)


def model_size_of(t) -> int:
    """The size of the "model" axis of DTensor ``t``'s mesh."""
    mesh = t.device_mesh
    return mesh.size(mesh.mesh_dim_names.index("model"))


def splittable(t, n: int):
    """``t``, gathered over "model" when that axis shards it but ``n``
    (the number of heads its last dim is about to split into) does not
    divide the axis: DTensor can split a sharded dim only evenly."""
    if is_dtensor(t) and n % model_size_of(t):
        return to_batch(t)
    return t


def _grad_placements(in_placements, out_placements, ndim: int):
    """Each input's gradient placements: ``Partial()`` on the mesh dims
    where the input is replicated but the call is split."""
    split = [False] * ndim
    for pl in (*in_placements, *out_placements):
        if pl is None:
            continue
        for d, p in enumerate(pl):
            split[d] = split[d] or not isinstance(p, Replicate)
    return tuple(
        None if pl is None else tuple(
            Partial() if isinstance(p, Replicate) and split[d] else p
            for d, p in enumerate(pl))
        for pl in in_placements)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous. A local
    gradient leaves ``local_call`` as the shard of a DTensor, whose later
    view ops assume the shard's logical layout; a permuted gradient (an
    einsum's, summed over a GQA group) would fail them."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_grads(fn):
    def call(*args):
        return fn(*(_ContiguousGrad.apply(a) if isinstance(a, torch.Tensor)
                    and a.requires_grad else a for a in args))
    return call


def local_call(fn: Callable, out_placements, in_placements: Sequence,
               *args):
    """``fn`` on the local shards of ``args`` (module docstring).
    ``in_placements`` has one entry per argument (None for a non-tensor);
    an input whose placements differ is redistributed to them first.
    ``out_placements`` is one placements tuple, or a tuple of them for a
    function with several outputs."""
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    several = isinstance(out_placements[0], (tuple, list))
    outs = out_placements if several else (out_placements,)
    grads = _grad_placements(in_placements, outs, mesh.ndim)
    # local_map reads a tuple as one entry per output, a list as the
    # placements of the one output
    out_arg = tuple(list(o) for o in outs) if several else list(outs[0])
    return local_map(_contiguous_grads(fn), out_placements=out_arg,
                     in_placements=tuple(in_placements),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def write(dst, src, index=()) -> None:
    """``dst[index] = src`` in place, ``index`` a tuple of step-1 slices
    (missing trailing dims whole) and ``src`` a tensor or a number. On a
    DTensor ``dst`` each rank writes its shard: ``src`` is brought to
    ``dst``'s placements, whole over the mesh dims that shard a sliced
    dim, and each rank writes the part of the slice its shard holds (a
    KV cache sharded on its sequence takes a prompt's prefix)."""
    if not is_dtensor(dst):
        dst[index] = src
        return
    mesh = dst.device_mesh
    idx = list(index) + [slice(None)] * (dst.ndim - len(index))
    sliced = {k for k, sl in enumerate(idx) if sl != slice(None)}
    if isinstance(src, torch.Tensor):
        where = tuple(Replicate() if isinstance(p, Shard) and p.dim in sliced
                      else p for p in dst.placements)
        if not is_dtensor(src):
            src = replicate_like(src, dst)
        src = src.redistribute(mesh, where).to_local()
    local = dst.to_local()
    dst_idx, src_idx = [], []
    for k, sl in enumerate(idx):
        if k not in sliced:
            dst_idx.append(slice(None))
            src_idx.append(slice(None))
            continue
        start, stop, _ = sl.indices(dst.shape[k])
        off = 0
        for d in mesh_dims_sharding(dst, k):
            off = off * mesh.size(d) + mesh.get_local_rank(d)
        off *= local.shape[k]
        lo, hi = max(start, off), min(stop, off + local.shape[k])
        if lo >= hi:
            return
        dst_idx.append(slice(lo - off, hi - off))
        src_idx.append(slice(lo - start, hi - start))
    if isinstance(src, torch.Tensor):
        src = src[tuple(src_idx)]
    local[tuple(dst_idx)] = src


def mesh_dims_sharding(t: DTensor, dim: int) -> list:
    """The mesh dims over which tensor dim ``dim`` of ``t`` is sharded, in
    mesh order."""
    return [d for d, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim == dim]


def batch_placements(t: DTensor) -> tuple:
    """``t``'s placements with only its batch sharding (dim 0) kept."""
    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in t.placements)


def on_model(placements, dim: int, mesh) -> tuple:
    """``placements`` with the "model" mesh dim set to ``Shard(dim)``."""
    md = mesh.mesh_dim_names.index("model")
    return tuple(Shard(dim) if d == md else p
                 for d, p in enumerate(placements))
