"""Timeloop-style mappings: per-level loop blocks over the 7D nest.

A mapping assigns, to every architecture level, an ordered block of loops
``(dim, size, spatial?)`` (outer -> inner). Spatial loops in the block of
level *i* distribute iterations across instances of level *i+1*
(``parallel_for``); temporal loops sequence them in time (``for``).

Conventions (see DESIGN.md Section 5):
  * perfect factorization: per dim, the product of loop sizes across all
    blocks equals the dim size, so data spaces are exact hyper-rectangles;
  * reduction dims (C, R, S) may only be spatial at the target (bank) block
    — i.e. partial sums may be spread across *columns* (charged a reduction
    movement cost) but never across banks/channels, keeping bank-level
    output data spaces well defined;
  * within the target block all temporal loops precede all spatial loops,
    keeping bank-level data spaces contiguous rectangles.
"""
from __future__ import annotations

import dataclasses
import functools
import random
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .arch import ArchSpec
from .workload import DIMS, OUTPUT_DIMS, REDUCTION_DIMS, LayerSpec


@dataclasses.dataclass(frozen=True)
class Loop:
    dim: str
    size: int
    spatial: bool = False

    def __repr__(self):
        tag = "par" if self.spatial else "for"
        return f"{tag}({self.dim}:{self.size})"


# process-global intern table: token -> unique per (layer, blocks) content.
# Deliberately unbounded — tokens must never be reused (engine caches key on
# them), and entries are tiny tuples bounded by the distinct mappings a
# process ever explores.
_CACHE_KEY_INTERN: Dict = {}


@dataclasses.dataclass(frozen=True)
class Mapping:
    layer: LayerSpec
    arch: ArchSpec
    # one loop block per arch level, outer -> inner within each block
    blocks: Tuple[Tuple[Loop, ...], ...]

    # -- validation ---------------------------------------------------------

    def validate(self) -> None:
        arch, layer = self.arch, self.layer
        if len(self.blocks) != len(arch.levels):
            raise ValueError("one loop block per architecture level required")
        prod: Dict[str, int] = {d: 1 for d in DIMS}
        for li, block in enumerate(self.blocks):
            spatial_prod = 1
            seen_spatial = False
            for lp in block:
                if lp.size < 1:
                    raise ValueError(f"loop size < 1: {lp}")
                prod[lp.dim] *= lp.size
                if lp.spatial:
                    seen_spatial = True
                    spatial_prod *= lp.size
                    if li >= len(arch.levels) - 1:
                        raise ValueError("innermost level cannot be spatial")
                    if (lp.dim in REDUCTION_DIMS
                            and li != arch.target_index):
                        raise ValueError(
                            f"reduction dim {lp.dim} spatial above target")
                elif seen_spatial and li == arch.target_index:
                    raise ValueError(
                        "target block must order temporal before spatial")
            if li < len(arch.levels) - 1:
                if spatial_prod > arch.levels[li + 1].fanout:
                    raise ValueError(
                        f"spatial fanout {spatial_prod} exceeds "
                        f"{arch.levels[li + 1].name} fanout "
                        f"{arch.levels[li + 1].fanout}")
        for d in DIMS:
            if prod[d] != layer.dim(d):
                raise ValueError(
                    f"dim {d}: factors multiply to {prod[d]} != "
                    f"{layer.dim(d)}")

    # -- derived schedule structure -----------------------------------------

    @functools.cached_property
    def nest(self) -> List[Tuple[int, Loop]]:
        """All loops outer -> inner as (level_index, loop)."""
        out = []
        for li, block in enumerate(self.blocks):
            for lp in block:
                out.append((li, lp))
        return out

    @functools.cached_property
    def time_loops(self) -> List[Loop]:
        """Temporal loops that advance the bank-level time step, in nest
        order: temporal loops of blocks 0..target."""
        t = self.arch.target_index
        return [lp for li, lp in self.nest if li <= t and not lp.spatial]

    @functools.cached_property
    def space_loops(self) -> List[Loop]:
        """Spatial loops above the target level, in nest order — they define
        the bank coordinate."""
        t = self.arch.target_index
        return [lp for li, lp in self.nest if li < t and lp.spatial]

    @functools.cached_property
    def column_loops(self) -> List[Loop]:
        """Loops inside a bank step: target-block spatial (across columns)
        plus all loops of levels below the target."""
        t = self.arch.target_index
        out = [lp for li, lp in self.nest if li == t and lp.spatial]
        out += [lp for li, lp in self.nest if li > t]
        return out

    @property
    def n_steps(self) -> int:
        n = 1
        for lp in self.time_loops:
            n *= lp.size
        return n

    @property
    def n_banks(self) -> int:
        n = 1
        for lp in self.space_loops:
            n *= lp.size
        return n

    @property
    def n_columns_used(self) -> int:
        t = self.arch.target_index
        n = 1
        for li, lp in self.nest:
            if li == t and lp.spatial:
                n *= lp.size
        return n

    @functools.cached_property
    def time_strides(self) -> List[int]:
        """Paper Eq (1): G(n) = product of iteration counts of temporal
        loops inner to n — the time-step increment of one iteration of
        loop n."""
        strides = []
        rest = self.n_steps
        for lp in self.time_loops:
            rest //= lp.size
            strides.append(rest)
        return strides

    @functools.cached_property
    def space_strides(self) -> List[int]:
        strides = []
        rest = self.n_banks
        for lp in self.space_loops:
            rest //= lp.size
            strides.append(rest)
        return strides

    @functools.cached_property
    def tile_extent(self) -> Dict[str, int]:
        """Extent per dim of one (bank, step) data space rectangle."""
        ext = {d: self.layer.dim(d) for d in DIMS}
        t = self.arch.target_index
        for li, lp in self.nest:
            if li < t or (li == t and not lp.spatial):
                ext[lp.dim] //= lp.size
        return ext

    @functools.cached_property
    def rect_loops(self) -> List[Tuple[Loop, int, int, int]]:
        """Rectangle-defining loops outer->inner with their per-dim block
        size after the split, time stride (0 for spatial) and bank stride
        (0 for temporal).

        Returns tuples ``(loop, dim_block_size, time_stride, bank_stride)``
        where ``dim_block_size`` is the sub-block extent of ``loop.dim``
        produced by this loop (i.e. offset contribution per iteration).
        """
        t = self.arch.target_index
        cur = {d: self.layer.dim(d) for d in DIMS}
        tstrides = iter(self.time_strides)
        sstrides = iter(self.space_strides)
        out = []
        for li, lp in self.nest:
            if li > t or (li == t and lp.spatial):
                continue
            cur[lp.dim] //= lp.size
            if lp.spatial:
                out.append((lp, cur[lp.dim], 0, next(sstrides)))
            else:
                out.append((lp, cur[lp.dim], next(tstrides), 0))
        return out

    @functools.cached_property
    def cache_key(self) -> int:
        """Content-based identity for memoization: an interned token for
        (layer spec, loop blocks) — equal-content mappings share a token,
        and later cache lookups hash a small int instead of the whole
        nest. ``ArchSpec`` holds unhashable members (per-level op dicts) so
        callers cache per-arch (see ``core.engine``); two mappings with
        equal keys under the same arch are behaviourally identical."""
        content = (self.layer, self.blocks)
        token = _CACHE_KEY_INTERN.get(content)
        if token is None:
            token = _CACHE_KEY_INTERN[content] = len(_CACHE_KEY_INTERN)
        return token

    def macs_per_step(self) -> int:
        e = self.tile_extent
        m = 1
        for d in DIMS:
            m *= e[d]
        return m

    def pretty(self) -> str:
        lines = []
        for li, block in enumerate(self.blocks):
            name = self.arch.levels[li].name
            body = " ".join(repr(lp) for lp in block) or "-"
            lines.append(f"{name:>8}: {body}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Factorization utilities + random mapping generation (mapper substrate)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def divisors(n: int) -> Tuple[int, ...]:
    out = [d for d in range(1, int(n ** 0.5) + 1) if n % d == 0]
    out += [n // d for d in reversed(out) if d * d != n]
    return tuple(out)


def random_divisor_le(n: int, cap: int, rng: random.Random) -> int:
    opts = [d for d in divisors(n) if d <= cap]
    return rng.choice(opts)


# slots: (level_index, spatial?) outer->inner; filled per dim
def _slot_order(arch: ArchSpec) -> List[Tuple[int, bool]]:
    slots: List[Tuple[int, bool]] = []
    for li in range(len(arch.levels)):
        slots.append((li, False))                  # temporal at level li
        if li < len(arch.levels) - 1:
            slots.append((li, True))               # spatial -> level li+1
    return slots


def random_mapping(layer: LayerSpec, arch: ArchSpec, rng: random.Random,
                   max_steps: int = 65536,
                   max_tries: int = 64,
                   stream: Optional[bool] = None) -> Mapping:
    """Sample a random valid mapping (rejection sampling with repair).

    Search-space shape follows the paper: tiling factors per dim per level
    slot + loop permutation per block. ``stream=True`` forces the
    overlap-friendly temporal order (half of candidates by default).
    """
    t = arch.target_index
    n_levels = len(arch.levels)
    for _ in range(max_tries):
        # factor assignment: dim -> {slot -> factor}
        per_slot: Dict[Tuple[int, bool], Dict[str, int]] = {
            s: {} for s in _slot_order(arch)}
        ok = True
        for d in DIMS:
            rem = layer.dim(d)
            # choose spatial splits top-down first (subject to fanout)
            for li in range(n_levels - 1):
                cap = arch.levels[li + 1].fanout
                if d in REDUCTION_DIMS and li != t:
                    f = 1
                elif rng.random() < 0.5:
                    f = random_divisor_le(rem, cap, rng)
                else:
                    f = 1
                per_slot[(li, True)][d] = f
                rem //= f
            # distribute the remainder across temporal slots
            for li in range(n_levels):
                if li == n_levels - 1:
                    f = rem  # innermost absorbs the rest
                else:
                    f = random_divisor_le(rem, rem, rng)
                per_slot[(li, False)][d] = f
                rem //= f
            if rem != 1:
                ok = False
                break
        if not ok:
            continue
        # fanout constraints (joint across dims) + step bound, with repair:
        for li in range(n_levels - 1):
            cap = arch.levels[li + 1].fanout
            sl = per_slot[(li, True)]
            dims_sorted = sorted(sl, key=lambda d: -sl[d])
            while _prod(sl.values()) > cap:
                dd = dims_sorted[0]
                # demote largest spatial factor to temporal at same level
                per_slot[(li, False)][dd] *= sl[dd]
                sl[dd] = 1
                dims_sorted = sorted(sl, key=lambda d: -sl[d])
        n_steps = 1
        for li in range(t + 1):
            n_steps *= _prod(per_slot[(li, False)].values())
        if n_steps > max_steps:
            continue
        do_stream = stream if stream is not None else (rng.random() < 0.5)
        blocks = _assemble_blocks(arch, per_slot, rng, stream=do_stream)
        m = Mapping(layer=layer, arch=arch, blocks=blocks)
        try:
            m.validate()
        except ValueError:
            continue
        return m
    # fall back to a deterministic valid mapping
    return heuristic_mapping(layer, arch)


def _prod(xs: Iterable[int]) -> int:
    p = 1
    for x in xs:
        p *= x
    return p


def _assemble_blocks(arch, per_slot, rng,
                     stream: bool = False) -> Tuple[Tuple[Loop, ...], ...]:
    t = arch.target_index
    blocks: List[Tuple[Loop, ...]] = []
    for li in range(len(arch.levels)):
        temporal = [Loop(d, f, False)
                    for d, f in per_slot[(li, False)].items() if f > 1]
        spatial = []
        if li < len(arch.levels) - 1:
            spatial = [Loop(d, f, True)
                       for d, f in per_slot[(li, True)].items() if f > 1]
        if stream:
            temporal = _stream_order(temporal, rng)
        else:
            rng.shuffle(temporal)
        rng.shuffle(spatial)
        if li == t:
            block = temporal + spatial  # temporal-before-spatial invariant
        else:
            block = temporal + spatial
            if not stream:
                rng.shuffle(block)
        blocks.append(tuple(block))
    return tuple(blocks)


_STREAM_GROUP = {"N": 0, "P": 0, "Q": 0, "K": 1, "C": 2, "R": 2, "S": 2}


def _stream_order(loops: List[Loop], rng) -> List[Loop]:
    """Overlap-friendly temporal order: spatial output position (P/Q)
    outermost, channels (K) next, reductions (C/R/S) innermost — each
    output region then completes (all channels, full reduction) early and
    in raster order, which is what gives the succeeding layer early ready
    times (paper Section III-C/D)."""
    rng.shuffle(loops)
    return sorted(loops, key=lambda lp: _STREAM_GROUP[lp.dim])


def heuristic_mapping(layer: LayerSpec, arch: ArchSpec,
                      max_steps: int = 65536) -> Mapping:
    """Deterministic output-stationary mapping: parallelize K/P/Q across
    banks, C/R/S across columns, remaining output dims temporal at bank."""
    t = arch.target_index
    n_levels = len(arch.levels)
    per_slot: Dict[Tuple[int, bool], Dict[str, int]] = {
        s: {d: 1 for d in DIMS} for s in _slot_order(arch)}

    rem = {d: layer.dim(d) for d in DIMS}
    # spatial across banks: split P then Q then K greedily
    for li in range(t):
        cap = arch.levels[li + 1].fanout
        used = 1
        for d in ("P", "Q", "K"):
            best = 1
            for f in divisors(rem[d]):
                if used * f <= cap:
                    best = max(best, f)
            per_slot[(li, True)][d] = best
            used *= best
            rem[d] //= best
    # spatial across columns at target: reduction dims then K
    cap = arch.levels[t + 1].fanout if t + 1 < n_levels else 1
    used = 1
    for d in ("C", "R", "S", "K"):
        best = 1
        for f in divisors(rem[d]):
            if used * f <= cap:
                best = max(best, f)
        per_slot[(t, True)][d] = best
        used *= best
        rem[d] //= best
    # everything else temporal at target level (bank steps), but keep the
    # step count bounded by pushing overflow into the innermost level.
    n_steps = _prod(rem.values())
    for d in ("C", "R", "S", "K", "Q", "P", "N"):
        while n_steps > max_steps and rem[d] > 1:
            small = min(f for f in divisors(rem[d]) if f > 1)
            per_slot[(n_levels - 1, False)][d] *= small
            rem[d] //= small
            n_steps //= small
    for d in DIMS:
        per_slot[(t, False)][d] = rem[d]

    blocks: List[Tuple[Loop, ...]] = []
    for li in range(n_levels):
        temporal = [Loop(d, f, False)
                    for d, f in per_slot[(li, False)].items() if f > 1]
        temporal.sort(key=lambda lp: _STREAM_GROUP[lp.dim])
        spatial = []
        if li < n_levels - 1:
            spatial = [Loop(d, f, True)
                       for d, f in per_slot[(li, True)].items() if f > 1]
        blocks.append(tuple(temporal + spatial))
    m = Mapping(layer=layer, arch=arch, blocks=tuple(blocks))
    m.validate()
    return m
