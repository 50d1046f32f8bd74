"""Overlap analysis between consecutive layers (paper Sections IV-G/H).

For every consumer (bank, step) data space we find the *ready time*: the
moment the preceding layer has finished producing every input element the
space needs. Two implementations:

* ``ready_steps_exhaustive`` — OverlaPIM's O(N*M) traversal comparing all
  producer/consumer data spaces (the baseline the paper speeds up).
* ``ready_steps_analytical`` — the paper's closed-form algorithm
  (Eq (3)-(6)): map the consumer space's input rectangle into producer
  output coordinates, then locate the producer (bank, step) containing the
  rectangle's max corner via mixed-radix division; reduction loops are
  taken at their last iteration. Because the bank-step index is separable
  and monotone per tile index, the max corner's space IS the latest
  intersecting space (property-verified against the exhaustive oracle).

Scheduling given ready times uses the recurrence
``end[t] = max(end[t-1], ready[t]) + L`` whose closed form
``end[t] = L*(t+1) + running_max(ready[s] - s*L)`` is vectorized.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .dataspace import generate_analytical, locate_finish, rect_bounds
from .mapping import Mapping
from .workload import LayerSpec, OUTPUT_DIMS

Rect = Dict[str, np.ndarray]  # dim -> lo / hi arrays


# ---------------------------------------------------------------------------
# Coordinate maps: consumer input rectangle -> producer output bounding box.
# ---------------------------------------------------------------------------

class CoordMap:
    """Maps a consumer tile (lo/hi per dim, in the consumer's 7D coords) to
    a bounding rectangle in the producer's output space [K, P, Q], plus a
    mask of spaces that are ready at t=0 (e.g. fully inside padding).
    Coordinate conventions are specified in DESIGN.md Section 5.2."""

    def to_producer(self, producer: LayerSpec, consumer: LayerSpec,
                    lo: Rect, hi: Rect) -> Tuple[Rect, Rect, np.ndarray]:
        raise NotImplementedError

    def key(self) -> Tuple:
        """Hashable content identity (cache key for the batched engine).
        ``to_producer`` must be a pure function of this key and its
        arguments."""
        raise NotImplementedError


class IdentityMap(CoordMap):
    """Conv/FC chain: consumer input channel -> producer K, input pixel
    (h, w) -> producer (P, Q) through stride/pad/filter-offset. ``pool``
    models an elementwise pooling layer between the two convs (VGG,
    ResNet stem): input pixel h reads producer rows
    [pool*h, pool*h + pool)."""

    def __init__(self, pool: int = 1):
        self.pool = pool

    def key(self):
        return ("identity", self.pool)

    def to_producer(self, producer, consumer, lo, hi):
        st, pad, pool = consumer.stride, consumer.pad, self.pool
        h_lo = (lo["P"] * st - pad + lo["R"]) * pool
        h_hi = ((hi["P"] - 1) * st - pad + (hi["R"] - 1)) * pool + pool - 1
        w_lo = (lo["Q"] * st - pad + lo["S"]) * pool
        w_hi = ((hi["Q"] - 1) * st - pad + (hi["S"] - 1)) * pool + pool - 1
        ready0 = ((h_hi < 0) | (w_hi < 0)
                  | (h_lo >= producer.P) | (w_lo >= producer.Q))
        plo = {"K": lo["C"], "P": np.maximum(h_lo, 0),
               "Q": np.maximum(w_lo, 0)}
        phi = {"K": hi["C"],
               "P": np.minimum(h_hi, producer.P - 1) + 1,
               "Q": np.minimum(w_hi, producer.Q - 1) + 1}
        return plo, phi, ready0


class HeadFoldMap(CoordMap):
    """seq x (heads*hd) producer -> heads-folded consumer (rows h*seq+m).

    Consumer input coord (c, row) needs producer output (P=row%seq,
    K=(row//seq)*hd + c). Bounding box is conservative when a tile spans a
    head boundary (documented in DESIGN.md Section 5.3)."""

    def __init__(self, seq: int, hd: int):
        self.seq, self.hd = seq, hd

    def key(self):
        return ("headfold", self.seq, self.hd)

    def to_producer(self, producer, consumer, lo, hi):
        seq, hd = self.seq, self.hd
        r_lo, r_hi = lo["P"], hi["P"] - 1
        h_lo, h_hi = r_lo // seq, r_hi // seq
        spans = h_hi > h_lo
        m_lo = np.where(spans, 0, r_lo % seq)
        m_hi = np.where(spans, seq - 1, r_hi % seq)
        k_lo = h_lo * hd + lo["C"]
        k_hi = h_hi * hd + hi["C"] - 1
        ready0 = np.zeros(r_lo.shape, dtype=bool)
        return ({"K": k_lo, "P": m_lo, "Q": np.zeros_like(r_lo)},
                {"K": k_hi + 1, "P": m_hi + 1, "Q": np.ones_like(r_lo)},
                ready0)


class HeadUnfoldMap(CoordMap):
    """heads-folded producer (rows h*seq+m, K=hd cols) -> seq x (heads*hd)
    consumer. Consumer input coord (c, m): h=c//hd, j=c%hd -> producer
    (P=h*seq+m, K=j)."""

    def __init__(self, seq: int, hd: int):
        self.seq, self.hd = seq, hd

    def key(self):
        return ("headunfold", self.seq, self.hd)

    def to_producer(self, producer, consumer, lo, hi):
        seq, hd = self.seq, self.hd
        c_lo, c_hi = lo["C"], hi["C"] - 1
        h_lo, h_hi = c_lo // hd, c_hi // hd
        spans = h_hi > h_lo
        j_lo = np.where(spans, 0, c_lo % hd)
        j_hi = np.where(spans, hd - 1, c_hi % hd)
        p_lo = h_lo * seq + lo["P"]
        p_hi = h_hi * seq + hi["P"] - 1
        ready0 = np.zeros(c_lo.shape, dtype=bool)
        return ({"K": j_lo, "P": p_lo, "Q": np.zeros_like(c_lo)},
                {"K": j_hi + 1, "P": p_hi + 1, "Q": np.ones_like(c_lo)},
                ready0)


class WeightMap(CoordMap):
    """Consumer *weight* tile -> producer output. Used for attention edges
    where a matmul's stationary operand (K^T in QK, V in AV) is produced by
    a sibling layer. ``kc_to`` maps (k range, c range, head range from the
    row block) to producer (K, P) bounds. ``group`` models GQA/MQA: query
    head h reads KV head ``h // group`` (group = n_heads // n_kv_heads),
    so the producer K offset uses the *grouped* head index — monotone in
    h, which keeps the analytical max-corner argument intact."""

    def __init__(self, seq: int, hd: int, kind: str, group: int = 1):
        assert kind in ("qk_weight", "av_weight")
        assert group >= 1
        self.seq, self.hd, self.kind = seq, hd, kind
        self.group = group

    def key(self):
        return ("weight", self.kind, self.seq, self.hd, self.group)

    def to_producer(self, producer, consumer, lo, hi):
        seq, hd = self.seq, self.hd
        r_lo, r_hi = lo["P"], hi["P"] - 1
        h_lo, h_hi = (r_lo // seq) // self.group, \
            (r_hi // seq) // self.group
        ready0 = np.zeros(r_lo.shape, dtype=bool)
        if self.kind == "qk_weight":
            # weight element (k=n, c) of head h <- k_proj output (P=n,
            # K=(h//group)*hd+c)
            k_lo = h_lo * hd + lo["C"]
            k_hi = h_hi * hd + hi["C"] - 1
            return ({"K": k_lo, "P": lo["K"], "Q": np.zeros_like(r_lo)},
                    {"K": k_hi + 1, "P": hi["K"], "Q": np.ones_like(r_lo)},
                    ready0)
        # av_weight: weight element (k=j, c=m) of head h <- v_proj output
        # (P=m, K=(h//group)*hd+j)
        k_lo = h_lo * hd + lo["K"]
        k_hi = h_hi * hd + hi["K"] - 1
        return ({"K": k_lo, "P": lo["C"], "Q": np.zeros_like(r_lo)},
                {"K": k_hi + 1, "P": hi["C"], "Q": np.ones_like(r_lo)},
                ready0)


class FullMap(CoordMap):
    """Conservative edge: every consumer tile needs the producer's ENTIRE
    output before it can start. Used where the element-level mapping has
    no affine tile-to-tile structure — MoE routing/dispatch (which tokens
    land in which expert slot depends on router *values*), expert-combine
    scatter-adds, KV-cache appends in decode, SSD inter-chunk state
    recurrences and token<->spatial flattenings. The projected rectangle
    is the full [K, P, Q] output, so the ready step is the producer's
    last step under both the analytical and exhaustive analyses."""

    def key(self):
        return ("full",)

    def to_producer(self, producer, consumer, lo, hi):
        z = np.zeros_like(lo["P"])
        ready0 = np.zeros(z.shape, dtype=bool)
        return ({"K": z, "P": z, "Q": z},
                {"K": np.full_like(z, producer.K),
                 "P": np.full_like(z, producer.P),
                 "Q": np.full_like(z, producer.Q)},
                ready0)


@dataclasses.dataclass
class Edge:
    """Dependency edge: this layer consumes ``producer``'s outputs."""

    producer: int                 # index into the network's layer list
    cmap: CoordMap = dataclasses.field(default_factory=IdentityMap)


# ---------------------------------------------------------------------------
# Consumer tile rectangles (lo/hi arrays over the (bank, step) grid).
# ---------------------------------------------------------------------------

def consumer_tiles(m_c: Mapping) -> Tuple[Rect, Rect]:
    return rect_bounds(m_c)


# ---------------------------------------------------------------------------
# Ready-step computation: analytical (the paper) vs exhaustive (OverlaPIM).
# ---------------------------------------------------------------------------

def rect_loop_groups(m_p: Mapping):
    """Group ``rect_loops`` per output dim as ``(size, block, weight)``
    triples, plus the constant contribution of reduction/batch dims (taken
    at their last iteration). Shared preamble of ``max_step_in_rect`` and
    the engine's deduplicated scans."""
    per_dim: Dict[str, list] = {}
    const = 0
    for lp, blk, tstride, bstride in m_p.rect_loops:
        w = 0 if lp.spatial else tstride
        if lp.dim in OUTPUT_DIMS:
            per_dim.setdefault(lp.dim, []).append((lp.size, blk, w))
        else:  # reduction / batch dims: last iteration
            const += w * (lp.size - 1)
    return per_dim, const


def digit_scan(loops, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Exact maximum of one dim's weighted mixed-radix digit sum over the
    coordinate interval [lo, hi] (inclusive), via a closed-form digit scan
    (families: x==hi, x==lo, follow-hi-then-drop, follow-lo-then-raise —
    each with a free max suffix). This is the single canonical scan kernel:
    ``max_step_in_rect`` runs it on full rect arrays, the engine on
    deduplicated intervals."""
    shape = lo.shape
    m = len(loops)
    if m == 1:
        # single digit: lo <= hi implies digit(lo) <= digit(hi) (no wrap,
        # the loop spans the whole dim) and families 3/4 never beat w*b
        n1, blk, w1 = loops[0]
        return float(w1) * ((hi // blk) % n1)
    a = [(lo // blk) % n for (n, blk, w) in loops]
    b = [(hi // blk) % n for (n, blk, w) in loops]
    w = [float(wl) for (_, _, wl) in loops]
    n = [nl for (nl, _, _) in loops]
    # prefix weighted values (exclusive) + prefix digit equality
    pre_hi = np.zeros(shape)
    pre_lo = np.zeros(shape)
    eq = np.ones(shape, dtype=bool)
    # suffix free maxima (exclusive of position j)
    suf = [np.zeros(shape) for _ in range(m + 1)]
    for j in range(m - 1, -1, -1):
        suf[j] = suf[j + 1] + w[j] * (n[j] - 1)
    val_hi = np.zeros(shape)
    val_lo = np.zeros(shape)
    for j in range(m):
        val_hi = val_hi + w[j] * b[j]
        val_lo = val_lo + w[j] * a[j]
    best = np.maximum(val_hi, val_lo)
    for j in range(m):
        # family 3: follow hi's digits, drop at j, free suffix
        f3_ok = (b[j] >= 1) & (~eq | (b[j] - 1 > a[j]))
        f3 = pre_hi + w[j] * (b[j] - 1) + suf[j + 1]
        best = np.where(f3_ok, np.maximum(best, f3), best)
        # family 4: follow lo's digits, raise at j, free suffix
        f4_ok = (~eq) & (a[j] + 1 <= n[j] - 1)
        f4 = pre_lo + w[j] * (n[j] - 1) + suf[j + 1]
        best = np.where(f4_ok, np.maximum(best, f4), best)
        pre_hi = pre_hi + w[j] * b[j]
        pre_lo = pre_lo + w[j] * a[j]
        eq = eq & (a[j] == b[j])
    return best


def max_step_in_rect(m_p: Mapping, plo: Rect, phi: Rect) -> np.ndarray:
    """Latest producer time step touching the rectangle [plo, phi).

    The step index is separable across dims: T = sum_d T_d(coord_d) with
    T_d a weighted mixed-radix digit sum (temporal loops weigh their
    Eq (1) stride G, spatial loops weigh 0); per dim ``digit_scan`` takes
    the exact interval maximum. Reduction dims contribute their last
    iteration (output complete only after the whole reduction). Vectorized
    over arbitrary interval arrays."""
    per_dim, const = rect_loop_groups(m_p)
    shape = np.broadcast(*[plo[d] for d in OUTPUT_DIMS]).shape
    total = np.full(shape, float(const))
    for d, loops in per_dim.items():
        lo = np.broadcast_to(plo[d], shape)
        hi = np.broadcast_to(phi[d], shape) - 1     # inclusive
        total = total + digit_scan(loops, lo, hi)
    return total.astype(np.int64)


def ready_steps_analytical(m_p: Mapping, m_c: Mapping,
                           cmap: Optional[CoordMap] = None,
                           tiles: Optional[Tuple[Rect, Rect]] = None):
    """Per consumer (bank, step): the latest producer step that finishes
    any of its inputs, plus the always-ready mask. O(consumer spaces),
    fully vectorized (paper Section IV-H)."""
    cmap = cmap or IdentityMap()
    lo, hi = tiles if tiles is not None else consumer_tiles(m_c)
    plo, phi, ready0 = cmap.to_producer(m_p.layer, m_c.layer, lo, hi)
    plo = {d: np.clip(plo[d], 0, m_p.layer.dim(d) - 1)
           for d in OUTPUT_DIMS}
    phi = {d: np.clip(phi[d], 1, m_p.layer.dim(d)) for d in OUTPUT_DIMS}
    step = max_step_in_rect(m_p, plo, phi)
    return step, ready0


def ready_steps_exhaustive(m_p: Mapping, m_c: Mapping,
                           cmap: Optional[CoordMap] = None):
    """OverlaPIM baseline: compare every consumer space against every
    producer space (O(N*M) rectangle intersections, pure Python)."""
    cmap = cmap or IdentityMap()
    lo, hi = consumer_tiles(m_c)
    plo, phi, ready0 = cmap.to_producer(m_p.layer, m_c.layer, lo, hi)
    pds = generate_analytical(m_p)
    nbc, ntc = m_c.n_banks, m_c.n_steps
    step = np.zeros((nbc, ntc), dtype=np.int64)
    offs, ext = pds.offsets, pds.extent
    for bc in range(nbc):
        for tc in range(ntc):
            if ready0[bc, tc]:
                continue
            best_t = -1
            for bp in range(pds.n_banks):
                for tp in range(pds.n_steps):
                    ok = True
                    for d in OUTPUT_DIMS:
                        o = int(offs[d][bp, tp])
                        if not (o < phi[d][bc, tc]
                                and o + ext[d] > plo[d][bc, tc]):
                            ok = False
                            break
                    if ok and tp > best_t:
                        best_t = tp
            step[bc, tc] = best_t
    # a space whose projected rectangle intersects NO producer space needs
    # no producer data: ready at t=0, like the analytical path's ready0
    # mask. Leaving the -1 search sentinel would make ``fin_step[step]``
    # wrap to the LAST producer step ("ready at producer completion").
    none = step < 0
    if none.any():
        step[none] = 0
        ready0 = ready0 | none
    return step, ready0


# ---------------------------------------------------------------------------
# Scheduling with ready times.
# ---------------------------------------------------------------------------

def schedule_with_ready(ready_ns: np.ndarray, step_ns: float,
                        start_floor: float = 0.0) -> np.ndarray:
    """Finish time of each (bank, step) given per-space ready times.

    Per bank: ``end[t] = max(end[t-1], ready[t], floor) + L`` — closed form
    via running max (vectorized, O(n))."""
    nb, nt = ready_ns.shape
    t = np.arange(nt, dtype=np.float64)
    eff = np.maximum(ready_ns, start_floor)
    base = np.maximum.accumulate(eff - t[None, :] * step_ns, axis=1)
    return base + (t[None, :] + 1) * step_ns


def overlapped_end(ready_ns: np.ndarray, step_ns: float,
                   start_floor: float = 0.0) -> float:
    fin = schedule_with_ready(ready_ns, step_ns, start_floor)
    return float(fin[:, -1].max()) if fin.size else 0.0


def stream_tail_fraction(mapping: Mapping, samples: int = 5) -> float:
    """Mean completion fraction of a grid of output elements.

    ~0.5 for a raster-streaming production order (outputs complete
    uniformly over time — overlap-friendly for the NEXT layer), ~1.0 for
    reduction-outermost orders where every output completes only at the
    end. Used by the forward search as a successor-friendliness proxy
    (Section IV-K's observation that per-layer-optimal mappings are biased
    against later layers)."""
    layer = mapping.layer
    ks = np.full(samples * samples, layer.K - 1)
    ps = np.repeat(np.linspace(0, layer.P - 1, samples).astype(np.int64),
                   samples)
    qs = np.tile(np.linspace(0, layer.Q - 1, samples).astype(np.int64),
                 samples)
    _, steps = locate_finish(mapping, {"K": ks, "P": ps, "Q": qs})
    return float(steps.mean() + 1) / mapping.n_steps


def stream_tail_fractions(mappings, samples: int = 5) -> np.ndarray:
    """``stream_tail_fraction`` vectorized over K candidate mappings of one
    layer. The sampled output-coordinate grid depends only on the layer, so
    it is built once; per candidate only the temporal digit location runs
    (the bank half of ``locate_finish`` is dead weight for the tail).
    Bit-identical to the scalar function: the located steps are exact
    integers and the mean of int64 is order-independent."""
    if not len(mappings):
        return np.zeros(0, dtype=np.float64)
    layer = mappings[0].layer
    ps = np.repeat(np.linspace(0, layer.P - 1, samples).astype(np.int64),
                   samples)
    qs = np.tile(np.linspace(0, layer.Q - 1, samples).astype(np.int64),
                 samples)
    coords = {"P": ps, "Q": qs}
    out = np.empty(len(mappings), dtype=np.float64)
    for k, m in enumerate(mappings):
        # K samples are the constant K-1 and reduction/batch dims take
        # their last iteration, so only P/Q loops vary across the sample
        # grid — fold everything else into an integer constant (the summed
        # step indices are the same exact integers as the full loop)
        const = 0
        step = None
        for lp, blk, tstride, bstride in m.rect_loops:
            if lp.spatial:
                continue
            if lp.dim == "K":
                const += int(((layer.K - 1) // blk) % lp.size) * tstride
            elif lp.dim in coords:
                c = ((coords[lp.dim] // blk) % lp.size) * tstride
                step = c if step is None else step + c
            else:               # reduction / batch dims: last iteration
                const += (lp.size - 1) * tstride
        if step is None:
            out[k] = float(const + 1) / m.n_steps
        else:
            out[k] = float((step + const).mean() + 1) / m.n_steps
    return out
