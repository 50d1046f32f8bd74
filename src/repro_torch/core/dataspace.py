"""Fine-grained data space generation (paper Section IV-E/F).

A *data space* is the hyper-rectangle of tensor coordinates processed by one
analysis-level instance (bank) in one time step. This module produces the
full (bank, step) -> rectangle map two ways:

* ``generate_exhaustive`` — recursive enumeration of the loop nest, the way
  Timeloop/OverlaPIM materialize data spaces (paper: "recursive function
  calls ... around 600 seconds"). Pure-Python, O(n) spaces with large
  constants. Kept as the oracle.
* ``generate_analytical`` — the paper's lightweight algorithm: every loop
  level contributes ``idx * block_size`` to the offset, where the temporal
  index increment is the closed-form stride of Eq (1)/(2). Vectorized with
  numpy ("less than 60 seconds" in the paper; orders of magnitude faster
  here too — measured in benchmarks/bench_dataspace.py).

Both return identical ``DataSpaces`` (property-checked in tests).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .mapping import Mapping
from .workload import DIMS, OUTPUT_DIMS, REDUCTION_DIMS


@dataclasses.dataclass
class DataSpaces:
    """Rectangles per (bank, step): ``offsets[d][b, t]`` is the lower corner
    of dim ``d``; extents are mapping-constant (``extent[d]``)."""

    mapping: Mapping
    offsets: Dict[str, np.ndarray]  # dim -> (n_banks, n_steps) int64
    extent: Dict[str, int]

    @property
    def n_banks(self) -> int:
        return self.mapping.n_banks

    @property
    def n_steps(self) -> int:
        return self.mapping.n_steps

    @property
    def n_spaces(self) -> int:
        return self.n_banks * self.n_steps

    def rect(self, b: int, t: int, dims=OUTPUT_DIMS):
        """[(lo, hi_exclusive)] per dim for one space."""
        return {d: (int(self.offsets[d][b, t]),
                    int(self.offsets[d][b, t]) + self.extent[d])
                for d in dims}

    def equals(self, other: "DataSpaces") -> bool:
        if self.extent != other.extent:
            return False
        return all(np.array_equal(self.offsets[d], other.offsets[d])
                   for d in DIMS)


def generate_analytical(mapping: Mapping,
                        dims=DIMS) -> DataSpaces:
    """Closed-form generation, O(n_spaces) vectorized (paper Eq (1)/(2))."""
    nb, nt = mapping.n_banks, mapping.n_steps
    steps = np.arange(nt, dtype=np.int64)
    banks = np.arange(nb, dtype=np.int64)
    offsets = {d: np.zeros((nb, nt), dtype=np.int64) for d in dims}
    for lp, blk, tstride, bstride in mapping.rect_loops:
        if lp.dim not in offsets:
            continue
        if lp.spatial:
            idx = (banks // bstride) % lp.size            # (nb,)
            offsets[lp.dim] += (idx * blk)[:, None]
        else:
            idx = (steps // tstride) % lp.size            # (nt,)
            offsets[lp.dim] += (idx * blk)[None, :]
    extent = {d: mapping.tile_extent[d] for d in dims}
    return DataSpaces(mapping=mapping, offsets=offsets, extent=extent)


def rect_bounds(mapping: Mapping, dims=DIMS):
    """Lower / upper (exclusive) corners of every (bank, step) rectangle:
    ``(lo, hi)`` dicts of (n_banks, n_steps) arrays. This is the
    consumer-tile view shared by overlap analysis and the batched engine
    (which flattens and stacks these across candidate mappings)."""
    ds = generate_analytical(mapping, dims)
    lo = {d: ds.offsets[d] for d in dims}
    hi = {d: ds.offsets[d] + ds.extent[d] for d in dims}
    return lo, hi


def rect_bounds_stacked(mappings, dims=DIMS):
    """``rect_bounds`` for K candidate mappings, stacked along a leading
    candidate axis: per dim one 1-D concatenation of the flattened
    ``(n_banks * n_steps)`` rect corners of every candidate, plus the
    slice offsets delimiting each candidate's segment. The batched engine
    runs coordinate maps and digit scans once over the concatenation
    instead of per candidate — elementwise ops on the stack are
    bit-identical to the per-candidate grids."""
    sizes = [m.n_banks * m.n_steps for m in mappings]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    total = int(offsets[-1])
    lo = {d: np.empty(total, dtype=np.int64) for d in dims}
    hi = {d: np.empty(total, dtype=np.int64) for d in dims}
    for k, m in enumerate(mappings):
        l, h = rect_bounds(m, dims)
        o0, o1 = offsets[k], offsets[k + 1]
        for d in dims:
            lo[d][o0:o1] = l[d].reshape(-1)
            hi[d][o0:o1] = h[d].reshape(-1)
    return lo, hi, offsets


def rect_bounds_separable_stacked(mappings, dims=DIMS):
    """``rect_bounds_separable`` for K candidate mappings, stacked: per dim
    the bank parts of all candidates concatenated (offsets ``boff``) and
    the step parts concatenated (offsets ``toff``), plus each candidate's
    extent dict. One allocation per dim serves the whole batch and the
    engine's class/interval dedup runs pooled over the concatenation."""
    nbs = [m.n_banks for m in mappings]
    nts = [m.n_steps for m in mappings]
    boff = np.concatenate([[0], np.cumsum(nbs)]).astype(np.int64)
    toff = np.concatenate([[0], np.cumsum(nts)]).astype(np.int64)
    bank_part = {d: np.zeros(int(boff[-1]), dtype=np.int64) for d in dims}
    step_part = {d: np.zeros(int(toff[-1]), dtype=np.int64) for d in dims}
    aranges: Dict[int, np.ndarray] = {}
    for k, m in enumerate(mappings):
        nb, nt = nbs[k], nts[k]
        steps = aranges.get(nt)
        if steps is None:
            steps = aranges[nt] = np.arange(nt, dtype=np.int64)
        banks = aranges.get(nb)
        if banks is None:
            banks = aranges[nb] = np.arange(nb, dtype=np.int64)
        b0, t0 = int(boff[k]), int(toff[k])
        for lp, blk, tstride, bstride in m.rect_loops:
            if lp.dim not in bank_part:
                continue
            if lp.spatial:
                bank_part[lp.dim][b0:b0 + nb] += (
                    (banks // bstride) % lp.size) * blk
            else:
                step_part[lp.dim][t0:t0 + nt] += (
                    (steps // tstride) % lp.size) * blk
    extents = [{d: m.tile_extent[d] for d in dims} for m in mappings]
    return bank_part, step_part, extents, boff, toff


def rect_bounds_separable(mapping: Mapping, dims=DIMS):
    """Factored form of ``rect_bounds``: per dim ``d`` the lower corner is
    ``bank_part[d][b] + step_part[d][t]`` (spatial loops index only the
    bank axis, temporal loops only the step axis — Eq (1)/(2) is a sum of
    independent digit contributions). O(n_banks + n_steps) instead of
    O(n_banks * n_steps); the batched engine dedups interval combos from
    these parts instead of materializing the full grid. ``extent`` is the
    mapping-constant rectangle size per dim."""
    nb, nt = mapping.n_banks, mapping.n_steps
    steps = np.arange(nt, dtype=np.int64)
    banks = np.arange(nb, dtype=np.int64)
    bank_part = {d: np.zeros(nb, dtype=np.int64) for d in dims}
    step_part = {d: np.zeros(nt, dtype=np.int64) for d in dims}
    for lp, blk, tstride, bstride in mapping.rect_loops:
        if lp.dim not in bank_part:
            continue
        if lp.spatial:
            bank_part[lp.dim] += ((banks // bstride) % lp.size) * blk
        else:
            step_part[lp.dim] += ((steps // tstride) % lp.size) * blk
    extent = {d: mapping.tile_extent[d] for d in dims}
    return bank_part, step_part, extent


def generate_exhaustive(mapping: Mapping, dims=DIMS) -> DataSpaces:
    """Recursive enumeration of the nest (Timeloop-style reference)."""
    nb, nt = mapping.n_banks, mapping.n_steps
    offsets = {d: np.zeros((nb, nt), dtype=np.int64) for d in dims}
    rect_loops = mapping.rect_loops
    n_loops = len(rect_loops)
    cur_off = {d: 0 for d in dims}

    def rec(i: int, bank: int, step: int) -> None:
        if i == n_loops:
            for d in dims:
                offsets[d][bank, step] = cur_off[d]
            return
        lp, blk, tstride, bstride = rect_loops[i]
        for k in range(lp.size):
            if lp.dim in cur_off:
                prev = cur_off[lp.dim]
                cur_off[lp.dim] = prev + k * blk
            if lp.spatial:
                rec(i + 1, bank + k * bstride, step)
            else:
                rec(i + 1, bank, step + k * tstride)
            if lp.dim in cur_off:
                cur_off[lp.dim] = prev
    rec(0, 0, 0)
    extent = {d: mapping.tile_extent[d] for d in dims}
    return DataSpaces(mapping=mapping, offsets=offsets, extent=extent)


# ---------------------------------------------------------------------------
# Point location (paper Eq (5)/(6)): which (bank, step) produces a coord.
# ---------------------------------------------------------------------------

def locate_finish(mapping: Mapping, coords: Dict[str, np.ndarray]):
    """Finish (bank, step) of output coordinates, vectorized.

    ``coords`` maps each of K/P/Q to an equal-shape int array. Returns
    ``(bank, step)`` arrays. Reduction loops (C/R/S) are taken at their last
    iteration — an output element is complete only once its whole reduction
    has run (Section IV-H: "the total sizes will be added to the temporal
    index for the finalized time step").
    """
    shape = np.broadcast(*coords.values()).shape
    step = np.zeros(shape, dtype=np.int64)
    bank = np.zeros(shape, dtype=np.int64)
    for lp, blk, tstride, bstride in mapping.rect_loops:
        if lp.dim in coords:
            idx = (coords[lp.dim] // blk) % lp.size
        elif lp.dim in REDUCTION_DIMS:
            idx = lp.size - 1
        else:  # untracked dim (e.g. N) — production order irrelevant
            idx = lp.size - 1
        if lp.spatial:
            bank = bank + idx * bstride
        else:
            step = step + idx * tstride
    return bank, step


def locate_finish_exhaustive(spaces: DataSpaces,
                             lo: Dict[str, int],
                             hi: Dict[str, int]):
    """OverlaPIM-style exhaustive location: scan *all* producer data spaces,
    keep the latest step whose rectangle intersects [lo, hi) (output dims
    only). O(n_spaces) per query. Returns (bank, step) or (-1, -1)."""
    best_t, best_b = -1, -1
    offs = spaces.offsets
    ext = spaces.extent
    for b in range(spaces.n_banks):
        for t in range(spaces.n_steps):
            inter = True
            for d in OUTPUT_DIMS:
                o = int(offs[d][b, t])
                if not (o < hi[d] and o + ext[d] > lo[d]):
                    inter = False
                    break
            if inter and t > best_t:
                best_t, best_b = t, b
    return best_b, best_t
