"""Sharding rules: DP (+pod) x TP/EP over the ("pod", "data", "model")
mesh, applied by parameter path.

PyTorch counterpart of ``repro.launch.sharding``, with the same rules
(Megatron-style):
  * embeddings shard d_model; unembed shards vocab;
  * attention q/k/v and MLP in-projections shard the OUT dim, o/w2 shard
    the IN dim (one all-reduce per block);
  * MoE experts shard the EXPERT axis ("model" = expert parallelism);
  * Mamba projections shard d_inner / heads / state groups;
  * anything not divisible by the model-axis size is replicated.

Batch dims shard over ("pod","data"). When the batch is smaller than the
data extent, KV caches shard the SEQUENCE axis instead.

A spec is a plain tuple with one entry per tensor dim: ``None``
(replicated), an axis name, or a tuple of axis names (the dim sharded
over several axes, in that order); the reference's ``PartitionSpec``
with the same entries. ``placements`` turns a spec into DTensor
placements for a mesh (the reference's ``to_shardings``), and
``distribute`` places a tree of tensors by a tree of specs. The spec
functions read only the mesh's axis names and sizes
(``launch.mesh.axis_sizes``).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor
from torch.distributed.tensor import zeros as dtensor_zeros

from ..models.common import ModelConfig, tree_get, tree_map
from .mesh import axis_sizes, batch_shard_size, data_axes, model_size

PyTree = Any
Spec = Tuple

# param-name -> (axis index to shard with "model"), counted AFTER any
# stacked layer axis is skipped.
_OUT_DIM = {"wq", "wk", "wv", "w1", "w3", "wz", "wx", "wB", "wC", "wdt",
            "embed", "unembed", "enc_pos", "dec_pos"}
_IN_DIM = {"wo", "w2"}
_CONV = {"conv_x", "conv_B", "conv_C"}
_REPL = {"router", "dt_bias", "A_log", "D", "gn_scale"}


def _divisible(n: int, m: int) -> bool:
    return m > 0 and n % m == 0


def param_spec(path_keys, shape, msize: int) -> Spec:
    """Spec for one param leaf."""
    name = path_keys[-1]
    stacked = "layers" in path_keys or "encoder" in path_keys \
        or "decoder" in path_keys
    off = 1 if stacked else 0
    spec = [None] * len(shape)
    is_moe = "moe" in path_keys and name in ("w1", "w2", "w3")
    if is_moe:
        if _divisible(shape[off], msize):
            spec[off] = "model"          # expert axis
    elif name in _OUT_DIM or name in _CONV:
        ax = len(shape) - 1
        if _divisible(shape[ax], msize):
            spec[ax] = "model"
    elif name in _IN_DIM:
        if _divisible(shape[off], msize):
            spec[off] = "model"
    # norms / scalars / _REPL stay replicated
    return tuple(spec)


def param_specs(tree: PyTree, mesh, plan: str = "tp") -> PyTree:
    """Spec tree for a param (or param-shape) tree. Plans:
      * "tp": Megatron-style tensor parallel on the model axis;
      * "dp": pure data parallel, params replicated;
      * "ep": experts sharded on the model axis, dense params replicated,
        embeddings kept as under "tp" (a replicated unembed all-reduces
        full fp32 logits).
    """
    if plan not in ("tp", "dp", "ep"):
        raise ValueError(f"unknown plan {plan!r}; have 'tp', 'dp', 'ep'")
    msize = model_size(mesh)
    keep_tp = {"embed", "unembed", "enc_pos", "dec_pos"}

    def one(path, leaf):
        keys = path.split("/")
        repl = (None,) * len(leaf.shape)
        if plan == "dp":
            return repl
        if plan == "ep" and keys[-1] not in keep_tp and not (
                "moe" in keys and keys[-1] in ("w1", "w2", "w3")):
            return repl
        return param_spec(keys, leaf.shape, msize)
    return tree_map(one, tree)


def zero_extend(spec: Spec, shape, mesh,
                axes: Tuple[str, ...] = ("data",)) -> Spec:
    """ZeRO-style extension: additionally shard the first free axis over
    ``axes`` when divisible (used for optimizer state always, and for
    params under FSDP)."""
    sizes = axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    flat = [a for e in entries if e is not None
            for a in (e if isinstance(e, tuple) else (e,))]
    for combo in (axes, ("data",)):
        if any(a in flat for a in combo):
            continue
        size = 1
        for a in combo:
            size *= sizes[a]
        for i, (e, n) in enumerate(zip(entries, shape)):
            if e is None and _divisible(n, size) and n >= size:
                entries[i] = combo if len(combo) > 1 else combo[0]
                return tuple(entries)
    return tuple(entries)


def opt_specs(param_spec_tree: PyTree, shapes: PyTree, mesh,
              axes: Tuple[str, ...] = ("data",)) -> PyTree:
    """Specs for one Adam moment tree (mirrors params + ZeRO sharding)."""
    return tree_map(lambda path, s: zero_extend(
        s, tree_get(shapes, path).shape, mesh, axes), param_spec_tree)


def fsdp_param_specs(tree: PyTree, mesh) -> PyTree:
    return opt_specs(param_specs(tree, mesh), tree, mesh)


def _axes_entry(axes: Tuple[str, ...]):
    """A spec entry for a dim sharded over ``axes``: the name alone for
    one axis (as ``PartitionSpec`` canonicalises a 1-tuple)."""
    return axes[0] if len(axes) == 1 else axes


def batch_specs(cfg: ModelConfig, batch: int, mesh, kind: str) -> PyTree:
    dp = _axes_entry(data_axes(mesh))
    bs = batch_shard_size(mesh)
    bspec = dp if _divisible(batch, bs) else None
    if kind in ("train", "prefill"):
        out = {"tokens": (bspec, None), "labels": (bspec, None)}
        if cfg.family == "audio":
            out["frames"] = (bspec, None, None)
        if kind == "prefill":
            out.pop("labels")
        return out
    return (bspec,)  # decode tokens [B]


def cache_specs(cfg: ModelConfig, batch: int, mesh,
                cache_tree: PyTree) -> PyTree:
    """Shard KV caches: batch over data axes when divisible, otherwise the
    sequence axis (long-context decode); kv-heads / ssm-heads over model
    when divisible."""
    dp = _axes_entry(data_axes(mesh))
    bs = batch_shard_size(mesh)
    msize = model_size(mesh)
    dsize = axis_sizes(mesh)["data"]
    batch_ok = _divisible(batch, bs)

    def spec_for(path, leaf) -> Spec:
        name = path.split("/")[-1]
        if name == "pos":
            return ()
        shp = leaf.shape
        if name in ("k", "v"):          # [L, B, S, kv, hd]
            kvs = "model" if _divisible(shp[3], msize) else None
            # kv heads narrower than the model axis: shard the SEQUENCE
            # axis over "model" instead (split-KV decode)
            seq_m = None if kvs else (
                "model" if _divisible(shp[2], msize) else None)
            if batch_ok:
                return (None, dp, seq_m, kvs, None)
            seq = "data" if _divisible(shp[2], dsize) else None
            if seq is not None and seq_m is not None:
                return (None, None, ("data", "model"), kvs, None)
            return (None, None, seq or seq_m, kvs, None)
        if name == "state":             # [L, B, H, N, P]
            hs = "model" if _divisible(shp[2], msize) else None
            return (None, dp if batch_ok else None, hs, None, None)
        if name.startswith("conv_"):    # [L, B, K-1, W]
            ws = "model" if _divisible(shp[3], msize) else None
            return (None, dp if batch_ok else None, None, ws)
        return (None,) * len(shp)

    return tree_map(spec_for, cache_tree)


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of a spec: mesh dim ``a`` is
    ``Shard(d)`` when tensor dim ``d``'s entry names ``a``, else
    ``Replicate()``. A dim sharded over several axes lists them in mesh
    order, the order in which DTensor splits it (ValueError otherwise).
    A mesh dim of size 1 splits nothing and is ``Replicate()`` whatever
    the spec names: DTensor refuses a view that merges a dim sharded over
    it once that dim is 1 wide (a batch of 1 on a (1, n) mesh)."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{tuple(names)}")
        for i in idx:
            if mesh.shape[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def distribute(tree: PyTree, spec_tree: PyTree, mesh) -> PyTree:
    """``tree``'s tensors as DTensors on ``mesh`` with the placements of
    ``spec_tree``; every rank passes the same full tensors and keeps its
    shard (no communication); a cache's ``pos`` (spec ``()``) is
    replicated. Non-tensor leaves and leaves whose spec is None (the
    optimizer's step) pass through."""
    def one(path, t):
        spec = tree_get(spec_tree, path) if path else spec_tree
        if not isinstance(t, torch.Tensor) or spec is None:
            return t
        return distribute_tensor(t, mesh, placements(spec, mesh),
                                 src_data_rank=None)
    return tree_map(one, tree)


def zeros(tree: PyTree, spec_tree: PyTree, mesh) -> PyTree:
    """DTensor zeros of the shapes and dtypes of ``tree``'s tensors (meta
    tensors will do) on ``mesh``, placed by ``spec_tree``: each rank
    allocates its shard only. Non-tensor leaves pass through."""
    def one(path, t):
        if not isinstance(t, torch.Tensor):
            return t
        spec = tree_get(spec_tree, path) if path else spec_tree
        return dtensor_zeros(t.shape, dtype=t.dtype, device_mesh=mesh,
                             placements=placements(spec, mesh))
    return tree_map(one, tree)


def gather(tree: PyTree) -> PyTree:
    """``tree`` with every DTensor leaf replaced by its full tensor."""
    return tree_map(lambda _, t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def spec_placements(spec_tree: PyTree, mesh) -> PyTree:
    """The placements of every spec of a tree (None stays None)."""
    return tree_map(lambda _, s: None if s is None else placements(s, mesh),
                    spec_tree)


def opt_state_specs(pspecs: PyTree, pshapes: PyTree, mesh) -> dict:
    """Spec tree of an optimizer state ``{"mu", "nu", "step"}``: the
    moments ZeRO-extended over "data" (the reference trainer's
    ``ospecs``); the step None, a plain tensor on every rank, so that
    the schedule's scalars stay plain tensors."""
    return {"mu": opt_specs(pspecs, pshapes, mesh),
            "nu": opt_specs(pspecs, pshapes, mesh), "step": None}
