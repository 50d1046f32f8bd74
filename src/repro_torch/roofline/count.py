"""Counters that run around one step: FLOPs, bytes, collectives and peak
memory of one device.

``StepCounter`` is a ``TorchDispatchMode``. For an op on DTensors it
steps aside (returns ``NotImplemented``), so DTensor runs the op as
each rank does: a redistribution's collectives, then the op on the local
tensors. Those local ops come back through the mode, which counts them.
So every count is rank 0's, per device. Ops that DTensor's sharding
propagation runs on global shapes, only to learn an output's metadata,
are not counted.

  * FLOPs: the matmul-class FLOPs of ``torch.utils.flop_counter``'s
    formulas (``FlopCounterMode``'s registry: mm, addmm, bmm, baddbmm,
    convolutions, the fused attentions), as ``hlo_cost`` counts dot and
    convolution in the reference.
  * Bytes: the operand and result bytes of each aten op that moves data
    (an op whose results only alias its operands, a view, moves none).
    It is the eager counterpart of ``hlo_cost``'s proxy and counts
    unfused: every elementwise op reads and writes its tensors, where a
    compiler would fuse a chain of them into one pass.
  * Collectives: the ``_c10d_functional`` collectives, by kind, with
    their result bytes, as ``hlo_cost`` counts them. On a CPU mesh
    DTensor sends a shard-to-shard redistribution as an all-gather and a
    chunk (gloo has no all-to-all); such an all-gather is counted as the
    all-to-all that NCCL would run: its input's bytes, read and written.
  * Peak memory: the most bytes of live storage at any point of the
    step, the step's arguments (``hold``) included. A storage is live
    from the op that creates it until Python frees it, whoever holds it
    (autograd's saved tensors too).

``repeat(mark, n)`` counts what ran since ``mark()`` ``n`` more times
(the dry-run traces one of identical micro-batches); the peak is not
scaled.
"""
from __future__ import annotations

import sys
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .analysis import COLLECTIVES, CollectiveStats, Roofline

# op name fragment -> collective kind (the reference's HLO names)
_KINDS = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"))
# ops that allocate without writing
_ALLOCS = {"empty", "empty_strided", "empty_like", "new_empty",
           "new_empty_strided"}


def _collective_kind(func) -> Optional[str]:
    ns = func.namespace
    if not (ns.startswith("_c10d_functional") or ns == "_dtensor"):
        return None
    name = func._opname
    if name == "wait_tensor":
        return None
    return next((kind for frag, kind in _KINDS if frag in name), None)


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """The counts of every op run while the mode is active (module
    docstring). Read ``flops``, ``hbm_bytes``, ``coll_counts``,
    ``coll_bytes``, ``peak_bytes`` and ``argument_bytes`` after."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_counts = dict.fromkeys(COLLECTIVES, 0)
        self.coll_bytes = dict.fromkeys(COLLECTIVES, 0)
        self.live = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self._seen: Dict[int, int] = {}

    # -- memory -----------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key)

    def hold(self, *trees: Any) -> None:
        """Count the storages of ``trees``' tensors (DTensors: their local
        shards) as live from the start: the step's arguments."""
        before = self.live
        for t in _tensors(trees):
            self._track(t.to_local() if isinstance(t, DTensor) else t)
        self.argument_bytes += self.live - before

    # -- dispatch ---------------------------------------------------------

    def _where(self):
        """(inside sharding propagation, inside DTensor's all-to-all
        fallback) for the op being run."""
        a2a = False
        f = sys._getframe(2)
        while f is not None:
            code = f.f_code
            if code.co_name == "shard_dim_alltoall":
                a2a = True
            elif code.co_filename.endswith("_sharding_prop.py"):
                return True, a2a
            f = f.f_back
        return False, a2a

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        prop, a2a = self._where()
        if prop:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        kind = _collective_kind(func)
        if kind is not None:
            if a2a and kind == "all-gather":   # gloo's stand-in, above
                kind, res = "all-to-all", sum(_nbytes(t) for t in ins)
            else:
                res = sum(_nbytes(t) for t in outs)
            self.coll_counts[kind] += 1
            self.coll_bytes[kind] += res
            self.hbm_bytes += sum(_nbytes(t) for t in ins) + res
            if not a2a:
                for t in outs:
                    self._track(t)
            return out
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        in_st = {id(t.untyped_storage()) for t in ins}
        aliases = all(id(t.untyped_storage()) in in_st for t in outs)
        if outs and func._opname not in _ALLOCS and (
                func._schema.is_mutable or not aliases):
            self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out

    # -- results ----------------------------------------------------------

    def collectives(self) -> CollectiveStats:
        return CollectiveStats(counts=dict(self.coll_counts),
                               bytes_by_kind=dict(self.coll_bytes))

    def roofline(self) -> Roofline:
        return Roofline(flops=self.flops, hbm_bytes=self.hbm_bytes,
                        collective_bytes=sum(self.coll_bytes.values()))

    # -- repeated work ----------------------------------------------------

    def mark(self) -> Tuple:
        """The additive counts so far, for ``repeat``."""
        return (self.flops, self.hbm_bytes, dict(self.coll_counts),
                dict(self.coll_bytes))

    def repeat(self, mark: Tuple, times: int) -> None:
        """Count the ops run since ``mark`` ``times`` more times; the peak
        is not scaled."""
        flops, hbm, counts, nbytes = mark
        self.flops += times * (self.flops - flops)
        self.hbm_bytes += times * (self.hbm_bytes - hbm)
        for kind in COLLECTIVES:
            self.coll_counts[kind] += times * (self.coll_counts[kind]
                                               - counts[kind])
            self.coll_bytes[kind] += times * (self.coll_bytes[kind]
                                              - nbytes[kind])
