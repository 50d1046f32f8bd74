"""Batched, memoizing overlap-analysis engine for the mapping search.

``optimize_network`` scores K candidate mappings per layer against committed
neighbors. The per-candidate reference path (``core.search`` /
``core.overlap``) recomputes ``analyze()``, ``consumer_tiles()``,
``stream_tail_fraction()`` and the ``max_step_in_rect`` digit scan from
scratch for every (candidate, edge) pair, and the refine pass re-evaluates
the whole chain per trial. The engine removes that redundancy without
changing a single produced number (DESIGN.md Section 6):

1. **Memoization** — ``analyze()`` (via ``PerfCache``), consumer tile
   rectangles, tail fractions, clipped producer-space projections,
   ``(step, ready0)`` ready matrices and whole candidate scores are cached
   on ``Mapping.cache_key`` (interned layer+blocks token). Ready matrices
   depend only on the two mappings and the coordinate map — never on
   schedule times — so search, commit and refine all reuse one analysis.
2. **Batched + deduplicated ready steps** — the tile rectangles of all K
   candidates for a layer are flattened and concatenated along a leading
   candidate axis; the mixed-radix digit scan then runs once per
   *distinct* interval per dim (``max_step_in_rect_dedup`` — the step
   maximum is separable across dims) and gathers back. ``IdentityMap``
   edges use the stronger separable path (``_ready_steps_identity``):
   tile corners factor into bank + step parts, so the scan touches only
   distinct (bank value, step pair) combos.
3. **Radix transform ordering** — single-edge ready matrices are ordered
   by producer finish-time rank, handing ``transform_schedule`` a
   precomputed stable integer argsort instead of a float mergesort.
4. **Incremental chain re-evaluation** — a refine trial that changes layer
   ``i`` only recomputes ``i`` and its transitive consumers, reusing the
   committed ``LayerResult`` objects of unaffected layers (pure functions
   of the mappings, so reuse is bit-exact).

Equivalence contract: every engine path yields bit-identical scores,
ready/step matrices, chosen mappings and ``total_ns`` to the reference
path. Enforced by differential tests (``tests/test_core_engine.py``).

Multi-arch reuse (the DSE substrate, ``repro_torch.dse``): one engine instance
may be shared across any number of ``optimize_network`` runs under
different ``ArchSpec``s. Caches are bundled per ``ArchSpec.to_key()`` —
mapping content keys (layer + blocks) are arch-agnostic, so the arch
content key disambiguates them. Switching architectures activates (or
creates) that arch's bundle in O(1); returning to a previously seen
architecture — even via a distinct but content-equal ``ArchSpec`` object,
e.g. one rebuilt by a DSE worker from ``ArchSpec.from_dict`` — resumes
its bundle with all memoized analysis intact. ``PerfCache`` is arch-keyed
directly and shared across bundles.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from .arch import ArchSpec
from .dataspace import (rect_bounds, rect_bounds_separable,
                        rect_bounds_stacked)
from .mapping import Mapping
from .overlap import (Edge, IdentityMap, CoordMap, digit_scan,
                      overlapped_end, rect_loop_groups, schedule_with_ready,
                      stream_tail_fraction, stream_tail_fractions)
from .perf_model import LayerPerf, PerfCache
from .search import (LayerResult, NetworkResult, SearchConfig,
                     _consumers_of, _visit_order, candidates,
                     combine_objective)
from .transform import transform_end_grouped, transform_schedule
from .workload import LayerSpec, OUTPUT_DIMS

# class-grid cells above which the batched identity scorer falls back to
# the dense per-candidate path (pathological mappings whose class product
# approaches the full (banks x steps x steps) grid)
_GRID_GUARD = 1 << 19

# engine-local stat keys (plain ints in ``OverlapEngine.stats``; the
# sustained scoring path must stay free of telemetry dispatch, so hot
# loops bump these dict cells and ``publish_metrics`` forwards deltas
# to the obs registry at search boundaries)
_STAT_KEYS = ("tiles_hit", "tiles_miss", "tail_hit", "tail_miss",
              "proj_hit", "proj_miss", "ready_hit", "ready_miss",
              "sepcls_hit", "sepcls_miss", "score_hit", "score_miss",
              "score_pool_hit", "batch_scored", "dense_scored",
              "guard_fallback", "evictions", "perf_hit", "perf_miss")


def _unique_inverse(codes: np.ndarray, bound: int):
    """``np.unique(codes, return_inverse=True)`` via a dense lookup table
    when the code range is small (two O(n) passes instead of an O(n log n)
    sort). ``codes`` must lie in ``[0, bound)``."""
    if bound <= (1 << 20):
        mask = np.zeros(bound, dtype=bool)
        mask[codes] = True
        uniq = np.flatnonzero(mask)
        lut = np.empty(bound, dtype=np.int64)
        lut[uniq] = np.arange(uniq.size)
        return uniq, lut[codes]
    return np.unique(codes, return_inverse=True)


def max_step_in_rect_dedup(m_p: Mapping, plo, phi) -> np.ndarray:
    """``overlap.max_step_in_rect`` with interval deduplication.

    The step maximum is separable: ``T = const + sum_d best_d(lo_d, hi_d)``
    where ``best_d`` depends only on that dim's interval. Candidate tile
    grids repeat a handful of distinct intervals per dim (#offsets x
    #extents, typically tens), so the digit scan runs on ``np.unique``
    interval codes and gathers back — bit-identical results at a fraction
    of the arithmetic. This is what makes stacking K candidates profitable
    (DESIGN.md Section 6)."""
    per_dim, const = rect_loop_groups(m_p)
    shape = np.broadcast(*[plo[d] for d in OUTPUT_DIMS]).shape
    total = np.full(shape, float(const))
    for d, loops in per_dim.items():
        lo = np.ascontiguousarray(
            np.broadcast_to(plo[d], shape)).reshape(-1)
        hi = np.ascontiguousarray(
            np.broadcast_to(phi[d], shape)).reshape(-1) - 1  # inclusive
        span = m_p.layer.dim(d) + 2
        codes = lo * span + hi
        uniq, inv = _unique_inverse(codes, span * span)
        best = digit_scan(loops, uniq // span, uniq % span)
        total = total + best[inv].reshape(shape)
    return total.astype(np.int64)


class _ArchCaches:
    """One architecture's cache bundle (mapping content keys are only
    unique per arch, so every per-mapping cache lives in a bundle)."""

    __slots__ = ("tiles", "tsep", "tail", "proj", "sepproj", "ready",
                 "ranks", "score", "sepcls", "clsr0")

    def __init__(self):
        self.tiles: Dict = {}    # mapping key -> (lo, hi) rect dicts
        self.tsep: Dict = {}     # mapping key -> separable rect parts
        self.tail: Dict = {}     # mapping key -> stream tail fraction
        self.proj: Dict = {}     # (consumer key, cmap key, producer layer)
        self.sepproj: Dict = {}  # same key -> separable combo decomposition
        self.ready: Dict = {}    # (producer key, consumer key, cmap key)
        self.ranks: Dict = {}    # id(LayerResult) -> finish-step ranks
        self.score: Dict = {}    # scoring-context key -> pinned score
        self.sepcls: Dict = {}   # (consumer key, cmap key) -> _SepClasses
        self.clsr0: Dict = {}    # (consumer key, cmap key, P, Q) -> r0 grid


class _SepClasses:
    """Factored class structure of one consumer mapping under an
    ``IdentityMap`` edge (producer-mapping-free, cached per (consumer,
    cmap) — the batched scorer's unit of reuse, DESIGN.md Section 6).

    Per producer output dim ``d`` in (K, P, Q) the projected interval of a
    consumer tile is ``bank_val + step_lo + [0, cst]``; ``tvals[d]`` holds
    the distinct step-lo values (ascending). ``jbmap`` maps each original
    bank to its *joint* bank class (distinct (K, P, Q) bank-value triple);
    ``bvj[d]`` is that class's bank value per dim. ``wjoint[kK, kP, kQ]``
    is the exact number of time steps whose (K, P, Q) step-lo classes are
    that combination — the per-dim step classes depend on disjoint
    temporal digit groups ({C}, {P,R}, {Q,S}), so the joint distribution
    is the product measure ``count_K x count_P x count_Q x (n_steps /
    prod(group sizes))`` (exact integer division: step counts factor over
    the free digits). ``wflat`` (lazy) is ``wjoint`` flattened and tiled
    over the joint bank classes, matching a C-order raveled class grid.
    ``tmin[d]`` (lazy, overlap mode only) is the minimum temporal partial
    step index per class; ``scodes`` caches per (dim, producer-dim-size)
    the clipped scan-interval codes."""

    __slots__ = ("tvals", "cst", "bvj", "jbmap", "wjoint", "wflat",
                 "cells", "tmin", "scodes")


class OverlapEngine:
    """Caches + batched kernels shared across ``optimize_network`` runs.

    Reusable across architectures: bundles are keyed on
    ``ArchSpec.to_key()`` and retained, so a DSE sweep revisiting an arch
    point resumes its memoized analysis (see module docstring)."""

    def __init__(self):
        self._perf = PerfCache()
        self._bundles: Dict[str, _ArchCaches] = {}
        self._cur = _ArchCaches()
        self._arch: Optional[ArchSpec] = None
        # pure-arithmetic memos (arch-independent): arange(n) and the
        # digit-contribution arrays arange(size) * weight
        self._ar: Dict[int, np.ndarray] = {}
        self._dc: Dict = {}
        #: always-on memo hit/miss accounting (plain ints — cheaper than
        #: telemetry dispatch in the hot loops; ``publish_metrics``
        #: forwards deltas to ``repro_torch.obs``)
        self.stats: Dict[str, int] = {k: 0 for k in _STAT_KEYS}
        self._published: Dict[str, int] = {k: 0 for k in _STAT_KEYS}

    def _arange(self, n: int) -> np.ndarray:
        a = self._ar.get(n)
        if a is None:
            a = self._ar[n] = np.arange(n, dtype=np.int64)
        return a

    def _digit_contrib(self, size: int, w: int) -> np.ndarray:
        a = self._dc.get((size, w))
        if a is None:
            a = self._dc[(size, w)] = self._arange(size) * w
        return a

    # -- memoized primitives -------------------------------------------------

    def _check_arch(self, m: Mapping) -> None:
        if m.arch is self._arch:       # fast path: same spec object
            return
        # never clobber a warm bundle for this key (regression: the
        # initial/post-evict state once overwrote it with an empty one).
        # Pop + reinsert keeps ``_bundles`` in last-touched order, which
        # is what makes ``evict_lru`` an LRU and not merely FIFO — the
        # dict ops run only on an arch *switch*, never per score.
        key = m.arch.to_key()
        cur = self._bundles.pop(key, None)
        if cur is None:
            cur = _ArchCaches()
        self._bundles[key] = cur
        self._cur = cur
        self._arch = m.arch

    @property
    def n_arch_bundles(self) -> int:
        """Distinct architectures this engine holds caches for."""
        return len(self._bundles)

    def evict_arch(self, arch) -> bool:
        """Drop one architecture's cache bundle (spec or ``to_key()``).

        Bundles are retained by default so arch revisits resume warm, but
        a sweep that scores each architecture exactly once (the DSE
        explorers dedup proposals and the journal absorbs revisits) should
        evict after scoring to bound memory — the shared ``PerfCache``
        keeps whatever cross-arch reuse exists. Returns True if a bundle
        was dropped."""
        key = arch if isinstance(arch, str) else arch.to_key()
        bundle = self._bundles.pop(key, None)
        if bundle is not None and bundle is self._cur:
            self._cur = _ArchCaches()
            self._arch = None
        if bundle is not None:
            self.stats["evictions"] += 1
            obs.event("engine.evict_arch", arch=key,
                      remaining=len(self._bundles))
        return bundle is not None

    def evict_lru(self, keep: int) -> int:
        """Evict least-recently-used arch bundles until at most ``keep``
        remain; returns how many were dropped. ``_bundles`` is kept in
        last-touched order by ``_check_arch``, so iteration order *is*
        recency order. The content-keyed ``PerfCache`` is untouched —
        this bounds per-arch cache memory, not cross-arch reuse. A
        long-lived multi-tenant service calls this between requests so
        repeat arch families stay warm under a fixed memory cap."""
        n = 0
        while len(self._bundles) > max(0, keep):
            self.evict_arch(next(iter(self._bundles)))
            n += 1
        return n

    def publish_metrics(self, registry=None) -> None:
        """Forward ``stats`` deltas since the last publish into the obs
        registry as ``engine.*`` counters (plus the live bundle-count
        gauge). Called at search boundaries — never from hot loops — so
        the sustained scoring path performs zero telemetry dispatch.
        No-op when telemetry is disabled and no ``registry`` is given."""
        reg = registry if registry is not None else obs.registry()
        if reg is None:
            return
        # fold the PerfCache's plain-int accounting in first, so
        # ``engine.perf_hit``/``perf_miss`` ride the same delta cursor
        self.stats["perf_hit"] = self._perf.hits
        self.stats["perf_miss"] = self._perf.misses
        for k, v in self.stats.items():
            d = v - self._published[k]
            if d:
                reg.counter("engine." + k).inc(d)
                self._published[k] = v
        reg.gauge("engine.arch_bundles").set(len(self._bundles))

    def perf(self, m: Mapping) -> LayerPerf:
        return self._perf.analyze(m)

    def tiles(self, m: Mapping):
        self._check_arch(m)
        key = m.cache_key
        hit = self._cur.tiles.get(key)
        if hit is None:
            self.stats["tiles_miss"] += 1
            hit = self._cur.tiles[key] = rect_bounds(m)
        else:
            self.stats["tiles_hit"] += 1
        return hit

    def tail(self, m: Mapping) -> float:
        self._check_arch(m)
        key = m.cache_key
        hit = self._cur.tail.get(key)
        if hit is None:
            self.stats["tail_miss"] += 1
            hit = self._cur.tail[key] = stream_tail_fraction(m)
        else:
            self.stats["tail_hit"] += 1
        return hit

    def projection(self, m_c: Mapping, cmap: CoordMap, p_layer: LayerSpec):
        """Clipped producer-output rectangle of every consumer tile. Depends
        on the consumer mapping and the producer *layer* only, so backward
        scoring reuses it across all producer candidates."""
        self._check_arch(m_c)
        key = (m_c.cache_key, cmap.key(), p_layer)
        hit = self._cur.proj.get(key)
        if hit is not None:
            self.stats["proj_hit"] += 1
        else:
            self.stats["proj_miss"] += 1
            lo, hi = self.tiles(m_c)
            plo, phi, ready0 = cmap.to_producer(p_layer, m_c.layer, lo, hi)
            plo = {d: np.clip(plo[d], 0, p_layer.dim(d) - 1)
                   for d in OUTPUT_DIMS}
            phi = {d: np.clip(phi[d], 1, p_layer.dim(d))
                   for d in OUTPUT_DIMS}
            hit = self._cur.proj[key] = (plo, phi, ready0)
        return hit

    def _projection_batch(self, reps: Sequence[Mapping], cmap: CoordMap,
                          p_layer: LayerSpec):
        """``projection`` for several consumer candidates of one layer in
        one pass: rect bounds are stacked along the candidate axis
        (``rect_bounds_stacked``), the coordinate map and clips run once on
        the concatenation (elementwise, so bit-identical per candidate) and
        each candidate's slice is cached under its ``projection`` key."""
        ck = cmap.key()
        out: List = [self._cur.proj.get((m.cache_key, ck, p_layer))
                     for m in reps]
        miss = [k for k in range(len(reps)) if out[k] is None]
        self.stats["proj_hit"] += len(reps) - len(miss)
        self.stats["proj_miss"] += len(miss)
        if not miss:
            return out
        mm = [reps[k] for k in miss]
        lo, hi, offs = rect_bounds_stacked(mm)
        plo, phi, ready0 = cmap.to_producer(p_layer, mm[0].layer, lo, hi)
        plo = {d: np.clip(plo[d], 0, p_layer.dim(d) - 1)
               for d in OUTPUT_DIMS}
        phi = {d: np.clip(phi[d], 1, p_layer.dim(d))
               for d in OUTPUT_DIMS}
        ready0 = np.broadcast_to(ready0, plo["K"].shape)
        for x, k in enumerate(miss):
            m = mm[x]
            o0, o1 = int(offs[x]), int(offs[x + 1])
            shp = (m.n_banks, m.n_steps)
            hit = ({d: plo[d][o0:o1].reshape(shp) for d in OUTPUT_DIMS},
                   {d: phi[d][o0:o1].reshape(shp) for d in OUTPUT_DIMS},
                   ready0[o0:o1].reshape(shp))
            self._cur.proj[(m.cache_key, ck, p_layer)] = hit
            out[k] = hit
        return out

    def tiles_sep(self, m: Mapping):
        self._check_arch(m)
        key = m.cache_key
        hit = self._cur.tsep.get(key)
        if hit is None:
            hit = self._cur.tsep[key] = rect_bounds_separable(m)
        return hit

    # -- ready-step analysis -------------------------------------------------

    def ready_steps(self, m_p: Mapping, m_c: Mapping,
                    cmap: Optional[CoordMap] = None):
        """Memoized ``ready_steps_analytical`` (identical results)."""
        self._check_arch(m_p)
        cmap = cmap or IdentityMap()
        key = (m_p.cache_key, m_c.cache_key, cmap.key())
        hit = self._cur.ready.get(key)
        if hit is not None:
            self.stats["ready_hit"] += 1
        else:
            self.stats["ready_miss"] += 1
            if type(cmap) is IdentityMap:
                hit = self._ready_steps_identity(m_p, m_c, cmap)
            else:
                plo, phi, ready0 = self.projection(m_c, cmap, m_p.layer)
                hit = (max_step_in_rect_dedup(m_p, plo, phi), ready0)
            self._cur.ready[key] = hit
        return hit

    def _sep_decomp(self, m_c: Mapping, cmap: IdentityMap,
                    p_layer: LayerSpec):
        """Separable decomposition of the identity projection, cached per
        (consumer mapping, cmap, producer layer) — producer-mapping-free,
        so backward scoring shares it across all producer candidates.

        Tile corners factor into bank + step parts (``rect_bounds_separable``)
        and the identity projection is affine per dim, so each dim's
        producer interval is ``bank_val[b] + (step_lo, step_hi)[t]``.
        Returns the ready-at-0 mask plus, per output dim, the deduplicated
        (bank values, step pairs) combos and their inverse indices."""
        key = (m_c.cache_key, cmap.key(), p_layer)
        hit = self._cur.sepproj.get(key)
        if hit is not None:
            return hit
        bank, stepp, ext = self.tiles_sep(m_c)
        cl = m_c.layer
        st, pad, pool = cl.stride, cl.pad, cmap.pool
        nb, nt = m_c.n_banks, m_c.n_steps

        # interval parts per producer output dim (hi inclusive)
        parts = {
            "K": (bank["C"], stepp["C"], stepp["C"] + ext["C"] - 1),
            "P": (st * pool * bank["P"] + pool * bank["R"],
                  pool * (st * stepp["P"] - pad + stepp["R"]),
                  pool * (st * (stepp["P"] + ext["P"] - 1) - pad
                          + stepp["R"] + ext["R"] - 1) + pool - 1),
            "Q": (st * pool * bank["Q"] + pool * bank["S"],
                  pool * (st * stepp["Q"] - pad + stepp["S"]),
                  pool * (st * (stepp["Q"] + ext["Q"] - 1) - pad
                          + stepp["S"] + ext["S"] - 1) + pool - 1),
        }
        hb, htl, hth = parts["P"]
        wb, wtl, wth = parts["Q"]
        # ready-at-0 mask: exact IdentityMap.to_producer semantics; scalar
        # bound precheck skips the grid when no tile can be fully padded
        if (int(hb.min() + hth.min()) >= 0
                and int(wb.min() + wth.min()) >= 0
                and int(hb.max() + htl.max()) < p_layer.P
                and int(wb.max() + wtl.max()) < p_layer.Q):
            ready0 = np.zeros((nb, nt), dtype=bool)
        else:
            ready0 = ((hb[:, None] + hth[None, :] < 0)
                      | (wb[:, None] + wth[None, :] < 0)
                      | (hb[:, None] + htl[None, :] >= p_layer.P)
                      | (wb[:, None] + wtl[None, :] >= p_layer.Q))

        combos = {}
        for d in OUTPUT_DIMS:
            B, TL, TH = parts[d]
            tl_min = int(TL.min())
            th_min = int(TH.min())
            W = int(TH.max()) - th_min + 1
            codes = (TL - tl_min) * W + (TH - th_min)
            bound = (int(TL.max()) - tl_min + 1) * W
            u_t, inv_t = _unique_inverse(codes, bound)
            tl_u = u_t // W + tl_min
            th_u = u_t % W + th_min
            u_b, inv_b = np.unique(B, return_inverse=True)
            combos[d] = (u_b, inv_b, tl_u, th_u, inv_t)
        hit = self._cur.sepproj[key] = (ready0, combos)
        return hit

    def _ready_steps_identity(self, m_p: Mapping, m_c: Mapping,
                              cmap: IdentityMap):
        """Separable fast path for ``IdentityMap`` edges: the digit scan
        runs once per distinct (bank value, step pair) combo — typically
        tens — and an outer gather rebuilds the (nb, nt) grid.
        Bit-identical to ``ready_steps_analytical`` (the same integer
        pipeline runs per distinct element)."""
        pl = m_p.layer
        ready0, combos = self._sep_decomp(m_c, cmap, pl)
        per_dim, const = rect_loop_groups(m_p)
        nb, nt = m_c.n_banks, m_c.n_steps

        total = np.full((nb, nt), float(const))
        for d, loops in per_dim.items():
            u_b, inv_b, tl_u, th_u, inv_t = combos[d]
            dim = pl.dim(d)
            lo_raw = u_b[:, None] + tl_u[None, :]
            hi_raw = u_b[:, None] + th_u[None, :]
            if d == "K":
                plo_c, phi_c = lo_raw, hi_raw + 1
            else:  # to_producer's pre-clamp for P/Q
                plo_c = np.maximum(lo_raw, 0)
                phi_c = np.minimum(hi_raw, dim - 1) + 1
            lo_c = np.clip(plo_c, 0, dim - 1)
            hi_c = np.clip(phi_c, 1, dim) - 1          # inclusive
            best = digit_scan(loops, lo_c, hi_c)
            total = total + best[inv_b[:, None], inv_t[None, :]]
        return total.astype(np.int64), ready0

    # -- batched identity-edge scoring (class histograms) --------------------

    def _sep_classes_batch(self, cands: Sequence[Mapping],
                           cmap: IdentityMap) -> List[_SepClasses]:
        """Build (or fetch) the ``_SepClasses`` struct of every candidate.

        Built by *digit convolution* over the mapping's loop nest — never
        materializing per-step arrays: each producer output dim's step-lo
        value is a sum of independent digit contributions
        ``idx * (blk * weight)`` over that dim's temporal loops, so the
        distinct values (and their step counts) come from convolving the
        tiny per-loop contribution arrays and one ``np.unique`` at the
        end. Bank values likewise accumulate per spatial loop over an
        ``arange(n_banks)`` base; a single joint ``np.unique`` over the
        (K, P, Q) bank-value code yields ``jbmap``/``bvj`` in one pass."""
        ck = cmap.key()
        out = [self._cur.sepcls.get((m.cache_key, ck)) for m in cands]
        missing: Dict = {}
        for k, m in enumerate(cands):
            if out[k] is None:
                missing.setdefault(m.cache_key, m)
        self.stats["sepcls_hit"] += sum(s is not None for s in out)
        self.stats["sepcls_miss"] += len(missing)
        if not missing:
            return out
        layer = next(iter(missing.values())).layer
        st, pad, pool = layer.stride, layer.pad, cmap.pool
        # weight of one unit of each loop dim in the projected step-lo /
        # bank value of each producer output dim (IdentityMap.to_producer
        # algebra; the -pool*pad shift is applied after dedup)
        coeff = {"C": ("K", 1), "P": ("P", pool * st), "R": ("P", pool),
                 "Q": ("Q", pool * st), "S": ("Q", pool)}
        shift = {"K": 0, "P": -pool * pad, "Q": -pool * pad}
        zero1 = np.zeros(1, dtype=np.int64)
        one1 = np.ones(1, dtype=np.int64)
        for m in missing.values():
            nb, nt = m.n_banks, m.n_steps
            banks = self._arange(nb)
            vals = {"K": zero1, "P": zero1, "Q": zero1}
            gprod = {"K": 1, "P": 1, "Q": 1}
            bparts: Dict[str, Optional[np.ndarray]] = {
                "K": None, "P": None, "Q": None}
            for lp, blk, _tstride, bstride in m.rect_loops:
                c = coeff.get(lp.dim)
                if c is None:
                    continue
                d, w = c
                if lp.spatial:
                    cb = ((banks // bstride) % lp.size) * (blk * w)
                    bparts[d] = cb if bparts[d] is None else bparts[d] + cb
                else:
                    vals[d] = (vals[d][:, None]
                               + self._digit_contrib(lp.size, blk * w)
                               ).reshape(-1)
                    gprod[d] *= lp.size
            tvals: Dict[str, np.ndarray] = {}
            cnts: Dict[str, np.ndarray] = {}
            for d in ("K", "P", "Q"):
                v = vals[d]
                if v.size > 1:
                    u, c = np.unique(v, return_counts=True)
                else:
                    u, c = v, one1
                tvals[d] = u + shift[d] if shift[d] else u
                cnts[d] = c
            # steps outside this dim-triple's digit groups are free: every
            # (K, P, Q) class combo repeats exactly ``rest`` times
            rest = nt // (gprod["K"] * gprod["P"] * gprod["Q"])
            wjoint = (cnts["K"][:, None, None] * cnts["P"][None, :, None]
                      * cnts["Q"][None, None, :] * rest).astype(np.float64)
            bK = bparts["K"]
            bP = bparts["P"]
            bQ = bparts["Q"]
            if bK is None:
                bK = self._digit_contrib(nb, 0)
            if bP is None:
                bP = self._digit_contrib(nb, 0)
            if bQ is None:
                bQ = self._digit_contrib(nb, 0)
            spanP = int(bP.max()) + 1
            spanQ = int(bQ.max()) + 1
            code_b = (bK * spanP + bP) * spanQ + bQ
            _u, idx, jbmap = np.unique(
                code_b, return_index=True, return_inverse=True)
            ext = m.tile_extent
            s = _SepClasses()
            s.tvals = tvals
            s.cst = {"K": ext["C"] - 1,
                     "P": pool * (st * (ext["P"] - 1) + ext["R"] - 1)
                          + pool - 1,
                     "Q": pool * (st * (ext["Q"] - 1) + ext["S"] - 1)
                          + pool - 1}
            s.bvj = {"K": bK[idx], "P": bP[idx], "Q": bQ[idx]}
            s.jbmap = jbmap
            s.wjoint = wjoint
            s.wflat = None
            s.cells = idx.size * wjoint.size
            s.tmin = None
            s.scodes = {}
            self._cur.sepcls[(m.cache_key, ck)] = s
        return [self._cur.sepcls[(m.cache_key, ck)] for m in cands]

    def _cls_r0(self, m: Mapping, cmap: IdentityMap, s: _SepClasses,
                p_layer: LayerSpec) -> np.ndarray:
        """Class-grid ready-at-0 mask, shape (JB, 1, VP, VQ) broadcastable
        against the (JB, VK, VP, VQ) step grid. Exact
        ``IdentityMap.to_producer`` semantics evaluated on class
        representatives (the conditions are functions of the class
        values, so every member of a class shares the verdict)."""
        key = (m.cache_key, cmap.key(), p_layer.P, p_layer.Q)
        hit = self._cur.clsr0.get(key)
        if hit is None:
            loP = s.bvj["P"][:, None] + s.tvals["P"][None, :]
            loQ = s.bvj["Q"][:, None] + s.tvals["Q"][None, :]
            p0 = (loP + s.cst["P"] < 0) | (loP >= p_layer.P)
            q0 = (loQ + s.cst["Q"] < 0) | (loQ >= p_layer.Q)
            hit = p0[:, None, :, None] | q0[:, None, None, :]
            self._cur.clsr0[key] = hit
        return hit

    def _cls_tmin(self, m: Mapping, cmap: IdentityMap,
                  s: _SepClasses) -> Dict[str, np.ndarray]:
        """Per step-lo class, the minimum *partial* step index contributed
        by that dim's temporal digit group ({C} for K, {P,R} for P,
        {Q,S} for Q). The full step index is the sum of the three group
        partials plus a rest-digit partial whose minimum is 0, so the
        minimum step index over a joint class cell is the sum of the
        per-dim class minima — which turns ``overlapped_end``'s
        ``max(ready - t*L)`` into a class-grid max (overlap mode)."""
        if s.tmin is None:
            nt = m.n_steps
            steps = np.arange(nt, dtype=np.int64)
            cl = m.layer
            pool = cmap.pool
            coeff = {"C": ("K", 1),
                     "P": ("P", pool * cl.stride), "R": ("P", pool),
                     "Q": ("Q", pool * cl.stride), "S": ("Q", pool)}
            tl = {d: np.zeros(nt, dtype=np.int64) for d in ("K", "P", "Q")}
            tp = {d: np.zeros(nt, dtype=np.int64) for d in ("K", "P", "Q")}
            for lp, blk, tstride, _bstride in m.rect_loops:
                c = coeff.get(lp.dim)
                if c is None or lp.spatial:
                    continue
                d, w = c
                idx = (steps // tstride) % lp.size
                tl[d] += idx * (blk * w)
                tp[d] += idx * tstride
            tl["P"] -= pool * cl.pad
            tl["Q"] -= pool * cl.pad
            tmin = {}
            for d in ("K", "P", "Q"):
                pos = np.searchsorted(s.tvals[d], tl[d])
                mn = np.full(s.tvals[d].size, np.iinfo(np.int64).max)
                np.minimum.at(mn, pos, tp[d])
                tmin[d] = mn
            s.tmin = tmin
        return s.tmin

    def _scan_tables_batch(self, m_p: Mapping,
                           structs: Sequence[_SepClasses]) -> List:
        """Class-grid ready-step tables for every struct against one
        producer: per dim the distinct (lo, hi) interval codes of ALL
        structs are pooled, digit-scanned once and gathered back, then the
        separable contributions assemble each struct's (JB, VK, VP, VQ)
        int64 grid (``T[jb, kK, kP, kQ]`` = producer step feeding that
        class cell — same integer pipeline as ``_ready_steps_identity``,
        evaluated on class representatives)."""
        per_dim, const = rect_loop_groups(m_p)
        pl = m_p.layer
        T = [np.full((s.bvj["K"].size, s.tvals["K"].size,
                      s.tvals["P"].size, s.tvals["Q"].size), float(const))
             for s in structs]
        for ax, d in enumerate(("K", "P", "Q")):
            loops = per_dim.get(d)
            if not loops:
                continue
            dim = pl.dim(d)
            parts = []
            for s in structs:
                c = s.scodes.get((d, dim))
                if c is None:
                    lo_raw = s.bvj[d][:, None] + s.tvals[d][None, :]
                    hi_raw = lo_raw + s.cst[d]
                    if d == "K":
                        plo_c, phi_c = lo_raw, hi_raw + 1
                    else:  # to_producer's pre-clamp for P/Q
                        plo_c = np.maximum(lo_raw, 0)
                        phi_c = np.minimum(hi_raw, dim - 1) + 1
                    lo_c = np.clip(plo_c, 0, dim - 1)
                    hi_c = np.clip(phi_c, 1, dim) - 1      # inclusive
                    c = lo_c.reshape(-1) * (dim + 1) + hi_c.reshape(-1)
                    s.scodes[(d, dim)] = c
                parts.append(c)
            codes = np.concatenate(parts) if len(parts) > 1 else parts[0]
            u, inv = _unique_inverse(codes, (dim + 1) * (dim + 1))
            best = digit_scan(loops, u // (dim + 1), u % (dim + 1))
            ofs = 0
            for j, s in enumerate(structs):
                jb, vd = s.bvj["K"].size, s.tvals[d].size
                nsz = jb * vd
                g = best[inv[ofs:ofs + nsz]].reshape(jb, vd)
                ofs += nsz
                shape = [jb, 1, 1, 1]
                shape[1 + ax] = vd
                T[j] = T[j] + g.reshape(shape)
        return [t.astype(np.int64) for t in T]

    def _tails_batch(self, cands: Sequence[Mapping]) -> None:
        """Fill the tail-fraction cache for all candidates in one
        ``stream_tail_fractions`` call (shared sample coordinates)."""
        missing: Dict = {}
        for m in cands:
            if m.cache_key not in self._cur.tail:
                missing.setdefault(m.cache_key, m)
        self.stats["tail_hit"] += len(cands) - len(missing)
        self.stats["tail_miss"] += len(missing)
        if missing:
            ms = list(missing.values())
            for m, f in zip(ms, stream_tail_fractions(ms)):
                self._cur.tail[m.cache_key] = float(f)

    def _score_identity_batch(self, i: int, cands: Sequence[Mapping],
                              edges: Sequence[Sequence[Edge]],
                              done: Dict[int, LayerResult], mode: str,
                              has_consumer: bool, objective: str,
                              blend_alpha: float) -> List:
        """Batched scores for candidates under identity edges via factored
        class histograms + grouped closed forms (DESIGN.md Section 6).
        Returns a list aligned with ``cands``: float scores, or None where
        the class grid exceeds ``_GRID_GUARD`` (caller falls back to the
        dense per-candidate path)."""
        cmap = edges[i][0].cmap
        structs = self._sep_classes_batch(cands, cmap)
        res: List = [None] * len(cands)
        sel = [k for k in range(len(cands))
               if structs[k].cells <= _GRID_GUARD]
        self.stats["guard_fallback"] += len(cands) - len(sel)
        if not sel:
            return res
        ssel = [structs[k] for k in sel]
        edata = []
        for e in edges[i]:
            prod = done[e.producer]
            Ts = self._scan_tables_batch(prod.mapping, ssel)
            fin, ranks, ufin = self._prod_ranks(prod)
            r0s = [self._cls_r0(cands[k], cmap, structs[k],
                                prod.mapping.layer) for k in sel]
            edata.append((prod, Ts, fin, ranks, ufin, r0s))
        single = len(edata) == 1
        perfs = [self.perf(cands[k]) for k in sel]
        tails = ([self.tail(cands[k]) for k in sel] if has_consumer
                 else [0.0] * len(sel))
        if mode == "overlap":
            for j, k in enumerate(sel):
                m, s, perf = cands[k], structs[k], perfs[j]
                g = None
                for (prod, Ts, fin, ranks, ufin, r0s) in edata:
                    ge = np.where(r0s[j], 0.0,
                                  fin[Ts[j]] + prod.perf.tile_move_ns)
                    g = ge if g is None else np.maximum(g, ge)
                tm = self._cls_tmin(m, cmap, s)
                tmg = (tm["K"][:, None, None] + tm["P"][None, :, None]
                       + tm["Q"][None, None, :]).astype(np.float64)
                end = float((g - tmg[None] * perf.step_ns).max()) \
                    + float(m.n_steps) * perf.step_ns
                penalty = tails[j] * perf.compute_ns
                res[k] = combine_objective(
                    objective, end + perf.output_move_ns + penalty,
                    perf.energy_pj, blend_alpha)
            return res
        # transform mode: per-candidate grouped (value, orig-bank)
        # histograms, then one batched closed-form schedule per distinct
        # bank count
        hist = []
        for j, k in enumerate(sel):
            s = structs[k]
            JB = s.bvj["K"].size
            if single:
                prod, Ts, fin, ranks, ufin, r0s = edata[0]
                Tg = Ts[j]
                u_rk, inv = _unique_inverse(ranks[Tg].reshape(-1),
                                            ufin.size)
                kc = np.where(r0s[j], 0, inv.reshape(Tg.shape) + 1)
                V1 = u_rk.size + 1
                vals = np.empty(V1)
                vals[0] = 0.0
                vals[1:] = ufin[u_rk] + prod.perf.tile_move_ns
            else:
                g = None
                for (prod, Ts, fin, ranks, ufin, r0s) in edata:
                    ge = np.where(r0s[j], 0.0,
                                  fin[Ts[j]] + prod.perf.tile_move_ns)
                    g = ge if g is None else np.maximum(g, ge)
                vals, inv = np.unique(g.reshape(-1), return_inverse=True)
                kc = inv.reshape(g.shape)
                V1 = vals.size
            flatk = kc + (self._arange(JB) * V1)[:, None, None, None]
            w = s.wflat
            if w is None:
                w = s.wflat = np.ascontiguousarray(
                    np.broadcast_to(s.wjoint.reshape(-1)[None],
                                    (JB, s.wjoint.size))).reshape(-1)
            cnt = np.bincount(flatk.reshape(-1), weights=w,
                              minlength=JB * V1).reshape(JB, V1)
            cnt = np.round(cnt).astype(np.int64)
            used = cnt.any(axis=0)
            if not used.all():
                vals = vals[used]
                cnt = cnt[:, used]
            if vals.size > 1 and np.any(np.diff(vals) <= 0):
                # float collisions (distinct fins colliding after
                # + tile_move): merge adjacent equal values — within one
                # value group the stable sort is original-bank-major either
                # way, so per-bank counts just add
                keep = np.concatenate([[True], np.diff(vals) > 0])
                gid = np.cumsum(keep) - 1
                cnt2 = np.zeros((cnt.shape[0], int(gid[-1]) + 1),
                                dtype=np.int64)
                np.add.at(cnt2.T, gid, cnt.T)
                vals = vals[keep]
                cnt = cnt2
            hist.append((vals, cnt[s.jbmap, :]))
        by_nb: Dict[int, List[int]] = {}
        for j, k in enumerate(sel):
            by_nb.setdefault(cands[k].n_banks, []).append(j)
        for nb, grp in by_nb.items():
            Vmax = max(hist[j][0].size for j in grp)
            values = np.zeros((len(grp), Vmax))
            counts = np.zeros((len(grp), Vmax, nb), dtype=np.int64)
            for x, j in enumerate(grp):
                v, c = hist[j]
                values[x, :v.size] = v
                counts[x, :v.size, :] = c.T
            ends, moved = transform_end_grouped(
                values, counts,
                np.array([cands[sel[j]].n_steps for j in grp]),
                np.array([perfs[j].step_ns for j in grp]),
                np.array([perfs[j].tile_move_ns for j in grp]))
            for x, j in enumerate(grp):
                k = sel[j]
                perf = perfs[j]
                penalty = tails[j] * perf.compute_ns
                moved_bytes = int(moved[x]) * float(perf.tile_bytes)
                res[k] = combine_objective(
                    objective,
                    float(ends[x]) + perf.output_move_ns + penalty,
                    perf.energy_pj + moved_bytes * perf.move_pj_per_byte,
                    blend_alpha)
        return res

    def ready_steps_batch(self, m_p: Mapping, cands: Sequence[Mapping],
                          cmap: Optional[CoordMap] = None):
        """``ready_steps`` for K candidate consumers of one layer against a
        fixed producer in a single vectorized pass: per-candidate projected
        rectangles are flattened, concatenated along the candidate axis and
        digit-scanned once. Results (bit-identical to the per-candidate
        scan) land in the ready cache and are returned per candidate.
        ``IdentityMap`` edges use the stronger separable per-candidate path
        instead (deduplication beats concatenation there)."""
        self._check_arch(m_p)
        cmap = cmap or IdentityMap()
        if type(cmap) is IdentityMap:
            return [self.ready_steps(m_p, m, cmap) for m in cands]
        ck = cmap.key()
        pk = m_p.cache_key
        out: List = [None] * len(cands)
        todo: Dict[Tuple, List[int]] = {}
        for k, m in enumerate(cands):
            key = (pk, m.cache_key, ck)
            hit = self._cur.ready.get(key)
            if hit is not None:
                self.stats["ready_hit"] += 1
                out[k] = hit
            else:
                self.stats["ready_miss"] += 1
                todo.setdefault(key, []).append(k)  # dedupes equal mappings
        if todo:
            keys = list(todo)
            reps = [cands[todo[key][0]] for key in keys]
            projs = self._projection_batch(reps, cmap, m_p.layer)
            cat_lo = {d: np.concatenate([p[0][d].reshape(-1) for p in projs])
                      for d in OUTPUT_DIMS}
            cat_hi = {d: np.concatenate([p[1][d].reshape(-1) for p in projs])
                      for d in OUTPUT_DIMS}
            step_cat = max_step_in_rect_dedup(m_p, cat_lo, cat_hi)
            ofs = 0
            for key, rep, (plo, phi, ready0) in zip(keys, reps, projs):
                n = ready0.size
                step = step_cat[ofs:ofs + n].reshape(ready0.shape)
                ofs += n
                self._cur.ready[key] = (step, ready0)
                for k in todo[key]:
                    out[k] = (step, ready0)
        return out

    def _prod_ranks(self, prod: LayerResult):
        """Per producer result: synchronous per-step finish times, their
        dense ranks (ties share a rank) and the ascending distinct finish
        values (``uniq_fin[ranks[t]] == fin_step[t]``). Ranks are integer
        sort keys whose stable order equals the stable order of the float
        ready times; the batched scorer histograms over ranks and decodes
        values through ``uniq_fin``."""
        ent = self._cur.ranks.get(id(prod))
        if ent is None or ent[0] is not prod:
            fin_step = prod.finish_ns.max(axis=0)
            order = np.argsort(fin_step, kind="stable")
            vals = fin_step[order]
            keep = np.concatenate([[True], vals[1:] > vals[:-1]])
            ranks = np.empty(fin_step.size, dtype=np.int64)
            ranks[order] = np.cumsum(keep) - 1
            ent = self._cur.ranks[id(prod)] = (prod, fin_step, ranks,
                                               vals[keep])
        return ent[1], ent[2], ent[3]

    def ready_matrix(self, mapping: Mapping, edges: Sequence[Edge],
                     done: Dict[int, LayerResult]) -> np.ndarray:
        """Engine twin of ``search._ready_matrix`` (same operation order)."""
        nb, nt = mapping.n_banks, mapping.n_steps
        ready = np.zeros((nb, nt), dtype=np.float64)
        for e in edges:
            prod = done[e.producer]
            step, ready0 = self.ready_steps(prod.mapping, mapping, e.cmap)
            fin_step, _, _ = self._prod_ranks(prod)
            r = fin_step[step] + prod.perf.tile_move_ns
            r = np.where(ready0, 0.0, r)
            ready = np.maximum(ready, r)
        return ready

    def ready_matrix_order(self, mapping: Mapping, edges: Sequence[Edge],
                           done: Dict[int, LayerResult]):
        """``(ready, order)`` where ``order``, when not None, equals
        ``np.argsort(ready.reshape(-1), kind='stable')``.

        Single-edge case: ready values are ``fin_step[step] + tile_move``
        (or 0 for always-ready spaces), so ranking producer steps once
        yields integer sort keys and a radix argsort replaces the float
        mergesort inside ``transform_schedule``. Multi-edge ready matrices
        (max over edges) have no shared key space — callers fall back to
        the float sort."""
        if len(edges) != 1:
            return self.ready_matrix(mapping, edges, done), None
        e = edges[0]
        prod = done[e.producer]
        step, ready0 = self.ready_steps(prod.mapping, mapping, e.cmap)
        fin_step, ranks, _ = self._prod_ranks(prod)
        ready = np.where(ready0, 0.0,
                         fin_step[step] + prod.perf.tile_move_ns)
        # finish times are positive, so rank 0 is reserved for ready-at-0
        key = np.where(ready0, 0, ranks[step] + 1)
        order = np.argsort(key.reshape(-1), kind="stable")
        return ready, order

    # -- chain evaluation ----------------------------------------------------

    def layer_result(self, i: int, m: Mapping, edges: Sequence[Sequence[Edge]],
                     done: Dict[int, LayerResult], mode: str) -> LayerResult:
        """Per-layer result with exactly ``evaluate_chain``'s semantics."""
        perf = self.perf(m)
        nb, nt = m.n_banks, m.n_steps
        if mode == "original":
            start = max((done[e.producer].end_ns for e in edges[i]),
                        default=0.0)
            t = np.arange(nt, dtype=np.float64)
            fin = start + np.broadcast_to(
                (t + 1) * perf.step_ns, (nb, nt)).copy()
            end = start + perf.compute_ns + perf.output_move_ns
            return LayerResult(m, perf, start, end, fin)
        ready, order = self.ready_matrix_order(m, edges[i], done)
        start = float(ready.min()) if ready.size else 0.0
        if mode == "transform" and edges[i]:
            tr = transform_schedule(ready, perf.step_ns, perf.tile_move_ns,
                                    order=order,
                                    tile_bytes=perf.tile_bytes,
                                    move_pj_per_byte=perf.move_pj_per_byte)
            return LayerResult(m, perf, start,
                               tr.end_ns + perf.output_move_ns,
                               tr.finish_ns, transformed=True,
                               moved_frac=tr.moved_frac,
                               moved_bytes=tr.moved_bytes,
                               move_energy_pj=tr.move_energy_pj)
        fin = schedule_with_ready(ready, perf.step_ns)
        return LayerResult(m, perf, start,
                           float(fin[:, -1].max()) + perf.output_move_ns,
                           fin)

    def evaluate_chain(self, mappings: Sequence[Mapping],
                       edges: Sequence[Sequence[Edge]], mode: str,
                       reuse: Optional[Tuple[Sequence[LayerResult],
                                             Sequence[Mapping]]] = None
                       ) -> NetworkResult:
        """``evaluate_chain`` with optional incremental reuse.

        ``reuse=(base_results, base_mappings)``: layers whose mapping is
        unchanged AND whose (transitive) producers are all unchanged keep
        their base ``LayerResult`` — bit-exact because results are pure
        functions of the mapping chain prefix."""
        n = len(mappings)
        base = None
        affected = set(range(n))
        if reuse is not None:
            base_res, base_maps = reuse
            changed = {j for j in range(n)
                       if mappings[j].cache_key != base_maps[j].cache_key}
            affected = set()
            for j in range(n):
                if j in changed or any(e.producer in affected
                                       for e in edges[j]):
                    affected.add(j)
            base = base_res
        done: Dict[int, LayerResult] = {}
        per_layer = []
        for i, m in enumerate(mappings):
            if base is not None and i not in affected:
                done[i] = base[i]
            else:
                done[i] = self.layer_result(i, m, edges, done, mode)
            per_layer.append(done[i].latency_ns)
        total = max(r.end_ns for r in done.values()) if done else 0.0
        return NetworkResult(layers=[done[i] for i in range(n)],
                             total_ns=total, mode=mode,
                             per_layer_ns=per_layer)

    # -- candidate scoring ---------------------------------------------------

    def score_forward_batch(self, i: int, cands: Sequence[Mapping],
                            edges: Sequence[Sequence[Edge]],
                            done: Dict[int, LayerResult], mode: str,
                            has_consumer: bool = True,
                            objective: str = "latency",
                            blend_alpha: float = 0.5) -> np.ndarray:
        """Vector of ``search._score_forward`` values for all candidates;
        ready steps for each edge are computed in one batched pass."""
        if cands:
            self._check_arch(cands[0])
        if mode == "original":
            base = max((done[e.producer].end_ns for e in edges[i]),
                       default=0.0)
            return np.array([combine_objective(
                objective, base + self.perf(m).sequential_ns,
                self.perf(m).energy_pj, blend_alpha) for m in cands])
        # score memo: a candidate's forward score is a pure function of
        # (mode, objective, candidate, committed producer results,
        # has_consumer) — refine passes and repeated strategy sweeps
        # re-score identical contexts, which the reference path recomputes
        # from scratch
        prods = tuple([done[e.producer] for e in edges[i]])
        pids = tuple([id(p) for p in prods])
        # pool memo: refine passes and repeat sweeps re-score the exact
        # same candidate pool against the same committed producers — one
        # tuple key skips even the per-candidate memo scan
        pkey = (mode, objective, blend_alpha, has_consumer, pids,
                tuple([m.cache_key for m in cands]))
        phit = self._cur.score.get(pkey)
        if phit is not None and all([a is b for a, b in zip(phit[0],
                                                            prods)]):
            self.stats["score_pool_hit"] += 1
            return phit[1].copy()
        out = np.empty(len(cands), dtype=np.float64)
        todo: List[int] = []
        for k, m in enumerate(cands):
            skey = (mode, objective, blend_alpha, m.cache_key,
                    has_consumer, pids)
            hit = self._cur.score.get(skey)
            if hit is not None and all(a is b for a, b in zip(hit[0],
                                                              prods)):
                out[k] = hit[1]
            else:
                todo.append(k)
        self.stats["score_hit"] += len(cands) - len(todo)
        self.stats["score_miss"] += len(todo)
        if not todo:
            self._cur.score[pkey] = (prods, out.copy())
            return out
        sub = [cands[k] for k in todo]
        if has_consumer:
            self._tails_batch(sub)
        # fast path: identity edges with one shared coordinate map score
        # through the class-histogram batch; anything else (non-identity
        # maps, mixed pooling, guard overflows) falls back per candidate
        fast = (bool(edges[i]) and mode in ("overlap", "transform")
                and all(type(e.cmap) is IdentityMap for e in edges[i])
                and len({e.cmap.key() for e in edges[i]}) == 1)
        scored = (self._score_identity_batch(i, sub, edges, done, mode,
                                             has_consumer, objective,
                                             blend_alpha)
                  if fast else [None] * len(sub))
        if edges[i] and not fast:
            for e in edges[i]:
                self.ready_steps_batch(done[e.producer].mapping, sub,
                                       e.cmap)
        for j, k in enumerate(todo):
            m = cands[k]
            sc = scored[j]
            if sc is None:
                self.stats["dense_scored"] += 1
                sc = self._score_forward_one(i, m, edges, done, mode,
                                             has_consumer, objective,
                                             blend_alpha)
            else:
                self.stats["batch_scored"] += 1
            out[k] = sc
            skey = (mode, objective, blend_alpha, m.cache_key,
                    has_consumer, pids)
            self._cur.score[skey] = (prods, sc)
        self._cur.score[pkey] = (prods, out.copy())
        return out

    def _score_forward_one(self, i: int, m: Mapping,
                           edges: Sequence[Sequence[Edge]],
                           done: Dict[int, LayerResult], mode: str,
                           has_consumer: bool, objective: str,
                           blend_alpha: float) -> float:
        """Dense per-candidate forward score (the pre-batching engine path;
        fallback for contexts the class-histogram scorer does not cover)."""
        perf = self.perf(m)
        tail = self.tail(m) if has_consumer else 0.0
        penalty = tail * perf.compute_ns
        if not edges[i]:
            return combine_objective(
                objective, perf.sequential_ns + penalty,
                perf.energy_pj, blend_alpha)
        ready, order = self.ready_matrix_order(m, edges[i], done)
        if mode == "transform":
            tr = transform_schedule(
                ready, perf.step_ns, perf.tile_move_ns,
                order=order, tile_bytes=perf.tile_bytes,
                move_pj_per_byte=perf.move_pj_per_byte)
            return combine_objective(
                objective, tr.end_ns + perf.output_move_ns + penalty,
                perf.energy_pj + tr.move_energy_pj, blend_alpha)
        return combine_objective(
            objective,
            overlapped_end(ready, perf.step_ns)
            + perf.output_move_ns + penalty,
            perf.energy_pj, blend_alpha)

    def score_backward(self, i: int, m: Mapping,
                       edges: Sequence[Sequence[Edge]],
                       fixed: Dict[int, Mapping], mode: str,
                       objective: str = "latency",
                       blend_alpha: float = 0.5) -> float:
        """``search._score_backward`` with memoized analysis: the consumer
        tile projection is shared across all producer candidates, so each
        candidate only pays its own digit scan. The full score is memoized
        on (mode, objective, candidate, fixed consumer mappings) — a pure
        function."""
        self._check_arch(m)
        cons_key = tuple(sorted((j, fixed[j].cache_key)
                                for j in _consumers_of(edges, i)
                                if j in fixed))
        skey = ("bw", mode, objective, blend_alpha, i, m.cache_key,
                cons_key)
        hit = self._cur.score.get(skey)
        if hit is not None:
            return hit[1]
        perf = self.perf(m)
        done = {i: LayerResult(
            m, perf, 0.0, perf.sequential_ns,
            np.broadcast_to((np.arange(m.n_steps) + 1.0) * perf.step_ns,
                            (m.n_banks, m.n_steps)).copy())}
        cons = [j for j in _consumers_of(edges, i) if j in fixed]
        if mode == "original" or not cons:
            seq = combine_objective(objective, perf.sequential_ns,
                                    perf.energy_pj, blend_alpha)
            self._cur.score[skey] = (None, seq)
            return seq
        worst = 0.0
        for j in cons:
            mc = fixed[j]
            pc = self.perf(mc)
            es = [e for e in edges[j] if e.producer == i]
            ready = self.ready_matrix(mc, es, done)
            if mode == "transform":
                tr = transform_schedule(ready, pc.step_ns, pc.tile_move_ns,
                                        tile_bytes=pc.tile_bytes,
                                        move_pj_per_byte=pc.move_pj_per_byte)
                sc = combine_objective(objective, tr.end_ns,
                                       pc.energy_pj + tr.move_energy_pj,
                                       blend_alpha)
            else:
                sc = combine_objective(objective,
                                       overlapped_end(ready, pc.step_ns),
                                       pc.energy_pj, blend_alpha)
            worst = max(worst, sc)
        self._cur.score[skey] = (None, worst)
        return worst


def optimize_network_engine(layers: Sequence[LayerSpec],
                            edges: Sequence[Sequence[Edge]],
                            arch: ArchSpec,
                            cfg: SearchConfig,
                            engine: Optional[OverlapEngine] = None
                            ) -> NetworkResult:
    """Engine-backed ``optimize_network``: identical algorithm, candidates
    and tie-breaking as the reference path — same chosen mappings, same
    ``total_ns`` — with batched scoring and incremental refinement."""
    if cfg.use_exhaustive_overlap:
        raise ValueError(
            "use_exhaustive_overlap has no engine twin; call "
            "optimize_network, which routes the flag to the reference "
            "implementation")
    eng = engine or OverlapEngine()
    n = len(layers)
    order, backward_part = _visit_order(layers, cfg.strategy)

    chosen: Dict[int, Mapping] = {}
    done: Dict[int, LayerResult] = {}
    for i in order:
        with obs.span("search.layer", layer=i, mode=cfg.mode,
                      strategy=cfg.strategy,
                      phase="backward" if i in backward_part else "forward"):
            cands = candidates(layers[i], arch, cfg, salt=i)
            if i in backward_part:
                scores = np.array([eng.score_backward(i, m, edges, chosen,
                                                      cfg.mode,
                                                      cfg.objective,
                                                      cfg.blend_alpha)
                                   for m in cands])
            else:
                avail = all(e.producer in done for e in edges[i])
                has_cons = bool(_consumers_of(edges, i))
                if avail:
                    scores = eng.score_forward_batch(i, cands, edges, done,
                                                     cfg.mode, has_cons,
                                                     cfg.objective,
                                                     cfg.blend_alpha)
                else:
                    perfs = [eng.perf(m) for m in cands]
                    scores = np.array([combine_objective(
                        cfg.objective, p.sequential_ns, p.energy_pj,
                        cfg.blend_alpha) for p in perfs])
            # np.argmin == first minimum == min(cands, key=...) tie-break
            chosen[i] = cands[int(np.argmin(scores))]
            if all(e.producer in done for e in edges[i]):
                done[i] = eng.layer_result(i, chosen[i], edges, done,
                                           cfg.mode)
    cur_maps = [chosen[i] for i in range(n)]
    result = eng.evaluate_chain(cur_maps, edges, cfg.mode)

    # coordinate-descent refinement: trials differ from the current chain
    # in one layer, so only that layer + transitive consumers re-evaluate
    for rp in range(cfg.refine_passes if cfg.mode != "original" else 0):
        improved = False
        cur_res = result
        with obs.span("search.refine_pass", mode=cfg.mode,
                      strategy=cfg.strategy, pass_idx=rp):
            for i in range(n):
                rcfg = dataclasses.replace(
                    cfg, n_candidates=cfg.refine_candidates)
                cands = candidates(layers[i], arch, rcfg, salt=i + 7919)
                cands.append(chosen[i])
                best_m = chosen[i]
                best_t = result.objective_value(cfg.objective,
                                                cfg.blend_alpha)
                for m in cands:
                    trial_maps = list(cur_maps)
                    trial_maps[i] = m
                    r = eng.evaluate_chain(trial_maps, edges, cfg.mode,
                                           reuse=(cur_res.layers, cur_maps))
                    sc = r.objective_value(cfg.objective, cfg.blend_alpha)
                    if sc < best_t - 1e-9:
                        best_m, best_t = m, sc
                if best_m is not chosen[i]:
                    chosen[i] = best_m
                    new_maps = [chosen[j] for j in range(n)]
                    cur_res = eng.evaluate_chain(
                        new_maps, edges, cfg.mode,
                        reuse=(cur_res.layers, cur_maps))
                    cur_maps = new_maps
                    improved = True
        result = eng.evaluate_chain(cur_maps, edges, cfg.mode,
                                    reuse=(cur_res.layers, cur_maps))
        if not improved:
            break
    result.objective = cfg.objective
    eng.publish_metrics()
    return result
