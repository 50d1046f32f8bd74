"""Whole-network mapping search (paper Sections IV-J/K, V-B).

Modes (the paper's comparison points, Section V-A2):
  * ``original``  — Timeloop-style: best sequential latency, no overlap.
  * ``overlap``   — search on overlapped latency (no transformation).
  * ``transform`` — search on transformed overlapped latency
                    (= Fast-OverlaPIM's "Best Transform").

Strategies (Section IV-K): ``forward``, ``backward``, ``middle_output``
(start at the layer with the largest P*Q*K), ``middle_overall`` (largest
P*Q*C*K). Per layer the mapper samples a fixed number of valid candidate
mappings (termination criterion "similar to Timeloop": a fixed number of
valid mappings) and the succeeding/preceding layer is optimized against the
fixed choice — the linear method of Section IV-J (k*N instead of k^N).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from .arch import ArchSpec
from .mapping import Mapping, heuristic_mapping, random_mapping
from .overlap import (Edge, overlapped_end, ready_steps_analytical,
                      ready_steps_exhaustive, schedule_with_ready,
                      stream_tail_fraction)
from .perf_model import LayerPerf, analyze
from .transform import transform_schedule
from .workload import LayerSpec

MODES = ("original", "overlap", "transform")
STRATEGIES = ("forward", "backward", "middle_output", "middle_overall")
# energy-aware objectives (DESIGN.md Section 9): "latency" is the paper's
# objective; "energy" minimizes base + transform-movement energy; "edp" the
# energy-delay product; "blend" a weighted geometric mean of the two.
OBJECTIVES = ("latency", "energy", "edp", "blend")


def combine_objective(objective: str, latency_ns: float, energy_pj: float,
                      blend_alpha: float = 0.5) -> float:
    """Scalarize one (latency, energy) pair under a named objective.

    Used identically for candidate scores and whole-network refine
    comparisons, on both the engine and reference paths — any asymmetry
    would break the engine's bit-identity contract. ``blend`` is the
    weighted geometric mean ``latency^(1-a) * energy^a`` (scale-free, so
    the ns/pJ unit mismatch cannot silently weight one term)."""
    if objective == "latency":
        return latency_ns
    if objective == "energy":
        return energy_pj
    if objective == "edp":
        return latency_ns * energy_pj
    if objective == "blend":
        a = blend_alpha
        return latency_ns ** (1.0 - a) * energy_pj ** a
    raise ValueError(f"unknown objective {objective!r}")


@dataclasses.dataclass
class SearchConfig:
    n_candidates: int = 48
    seed: int = 0
    max_steps: int = 16384
    mode: str = "transform"
    strategy: str = "forward"
    use_exhaustive_overlap: bool = False  # OverlaPIM's analysis (slow)
    # beyond-paper: coordinate-descent passes re-optimizing each layer
    # against both committed neighbors (0 = the paper's linear search)
    refine_passes: int = 0
    refine_candidates: int = 8
    # batched/memoizing engine (core.engine); False = per-candidate
    # reference path, kept as the differential-test oracle
    use_engine: bool = True
    # scoring objective ("latency" reproduces the paper exactly);
    # blend_alpha is the energy weight of the "blend" objective
    objective: str = "latency"
    blend_alpha: float = 0.5

    def __post_init__(self):
        assert self.mode in MODES, self.mode
        assert self.strategy in STRATEGIES, self.strategy
        assert self.objective in OBJECTIVES, self.objective
        assert 0.0 <= self.blend_alpha <= 1.0, self.blend_alpha


@dataclasses.dataclass
class LayerResult:
    mapping: Mapping
    perf: LayerPerf
    start_ns: float
    end_ns: float
    finish_ns: np.ndarray          # (nb, nt) absolute space finish times
    transformed: bool = False
    moved_frac: float = 0.0
    moved_bytes: float = 0.0       # data relocated by the transformation
    move_energy_pj: float = 0.0

    @property
    def latency_ns(self) -> float:
        return self.end_ns - self.start_ns

    @property
    def energy_pj(self) -> float:
        """Full layer energy: mapping-invariant base + movement."""
        return self.perf.energy_pj + self.move_energy_pj


@dataclasses.dataclass
class NetworkResult:
    layers: List[LayerResult]
    total_ns: float
    mode: str
    per_layer_ns: List[float] = dataclasses.field(default_factory=list)
    objective: str = "latency"     # objective the search optimized

    @property
    def total_energy_pj(self) -> float:
        return sum(l.energy_pj for l in self.layers)

    def objective_value(self, objective: Optional[str] = None,
                        blend_alpha: float = 0.5) -> float:
        """The network-level scalar the refine loop compares."""
        return combine_objective(objective or self.objective,
                                 self.total_ns, self.total_energy_pj,
                                 blend_alpha)

    def summary(self) -> Dict[str, float]:
        compute = sum(l.perf.compute_energy_pj for l in self.layers)
        io = sum(l.perf.io_energy_pj for l in self.layers)
        move = sum(l.move_energy_pj for l in self.layers)
        energy = self.total_energy_pj
        return {"total_ns": self.total_ns,
                "n_layers": len(self.layers),
                "mode": self.mode,
                "objective": self.objective,
                "energy_pj": energy,
                "compute_energy_pj": compute,
                "io_energy_pj": io,
                "move_energy_pj": move,
                "moved_bytes": sum(l.moved_bytes for l in self.layers),
                "edp_ns_pj": self.total_ns * energy}


# ---------------------------------------------------------------------------
# Chain evaluation for a FIXED set of mappings.
# ---------------------------------------------------------------------------

def _ready_matrix(idx: int, mapping: Mapping, edges: Sequence[Edge],
                  done: Dict[int, LayerResult],
                  use_exhaustive: bool = False) -> np.ndarray:
    """Absolute ready time per (bank, step) of ``mapping``, max over
    dependency edges (paper Section IV-G: latest producing space).

    ``use_exhaustive`` switches the ready-step analysis to OverlaPIM's
    O(N*M) traversal (``SearchConfig.use_exhaustive_overlap``) — the
    baseline the paper compares against. Result-identical to the
    analytical path (property-tested), just slow."""
    nb, nt = mapping.n_banks, mapping.n_steps
    ready = np.zeros((nb, nt), dtype=np.float64)
    ready_steps = (ready_steps_exhaustive if use_exhaustive
                   else ready_steps_analytical)
    for e in edges:
        prod = done[e.producer]
        step, ready0 = ready_steps(prod.mapping, mapping, e.cmap)
        # synchronous-time-step semantics (paper Fig 3): a step completes
        # when all banks complete it
        fin_step = prod.finish_ns.max(axis=0)
        r = fin_step[step] + prod.perf.tile_move_ns
        r = np.where(ready0, 0.0, r)
        ready = np.maximum(ready, r)
    return ready


def evaluate_chain(mappings: Sequence[Mapping],
                   edges: Sequence[Sequence[Edge]],
                   mode: str,
                   use_exhaustive_overlap: bool = False) -> NetworkResult:
    """Run the whole network with fixed mappings under a given mode."""
    done: Dict[int, LayerResult] = {}
    per_layer = []
    for i, m in enumerate(mappings):
        perf = analyze(m)
        nb, nt = m.n_banks, m.n_steps
        if mode == "original":
            start = max((done[e.producer].end_ns for e in edges[i]),
                        default=0.0)
            t = np.arange(nt, dtype=np.float64)
            fin = start + np.broadcast_to(
                (t + 1) * perf.step_ns, (nb, nt)).copy()
            end = start + perf.compute_ns + perf.output_move_ns
            res = LayerResult(m, perf, start, end, fin)
        else:
            ready = _ready_matrix(i, m, edges[i], done,
                                  use_exhaustive_overlap)
            start = float(ready.min()) if ready.size else 0.0
            if mode == "transform" and edges[i]:
                tr = transform_schedule(
                    ready, perf.step_ns, perf.tile_move_ns,
                    tile_bytes=perf.tile_bytes,
                    move_pj_per_byte=perf.move_pj_per_byte)
                fin = tr.finish_ns
                end = tr.end_ns + perf.output_move_ns
                res = LayerResult(m, perf, start, end, fin,
                                  transformed=True,
                                  moved_frac=tr.moved_frac,
                                  moved_bytes=tr.moved_bytes,
                                  move_energy_pj=tr.move_energy_pj)
            else:
                fin = schedule_with_ready(ready, perf.step_ns)
                end = float(fin[:, -1].max()) + perf.output_move_ns
                res = LayerResult(m, perf, start, end, fin)
        done[i] = res
        per_layer.append(res.latency_ns)
    total = max(r.end_ns for r in done.values()) if done else 0.0
    return NetworkResult(layers=[done[i] for i in range(len(mappings))],
                         total_ns=total, mode=mode, per_layer_ns=per_layer)


# ---------------------------------------------------------------------------
# Per-layer candidate generation + greedy linear search.
# ---------------------------------------------------------------------------

def candidates(layer: LayerSpec, arch: ArchSpec,
               cfg: SearchConfig, salt: int) -> List[Mapping]:
    rng = random.Random((cfg.seed << 20) ^ salt)
    out = [heuristic_mapping(layer, arch, cfg.max_steps)]
    seen = {out[0].blocks}
    for _ in range(cfg.n_candidates - 1):
        m = random_mapping(layer, arch, rng, cfg.max_steps)
        if m.blocks not in seen:
            seen.add(m.blocks)
            out.append(m)
    return out


def _score_forward(i, m, edges, done, mode, has_consumer=True,
                   objective="latency", blend_alpha=0.5,
                   use_exhaustive=False) -> float:
    perf = analyze(m)
    if mode == "original":
        base = max((done[e.producer].end_ns for e in edges[i]), default=0.0)
        return combine_objective(objective, base + perf.sequential_ns,
                                 perf.energy_pj, blend_alpha)
    # successor-friendliness: penalize production orders whose outputs all
    # complete at the end (they deny the next layer any overlap)
    tail = stream_tail_fraction(m) if has_consumer else 0.0
    penalty = tail * perf.compute_ns
    if not edges[i]:
        return combine_objective(objective, perf.sequential_ns + penalty,
                                 perf.energy_pj, blend_alpha)
    ready = _ready_matrix(i, m, edges[i], done, use_exhaustive)
    if mode == "transform":
        tr = transform_schedule(ready, perf.step_ns, perf.tile_move_ns,
                                tile_bytes=perf.tile_bytes,
                                move_pj_per_byte=perf.move_pj_per_byte)
        return combine_objective(
            objective, tr.end_ns + perf.output_move_ns + penalty,
            perf.energy_pj + tr.move_energy_pj, blend_alpha)
    return combine_objective(
        objective,
        overlapped_end(ready, perf.step_ns) + perf.output_move_ns + penalty,
        perf.energy_pj, blend_alpha)


def _commit(i, m, edges, done, mode, use_exhaustive=False) -> LayerResult:
    perf = analyze(m)
    nb, nt = m.n_banks, m.n_steps
    if mode == "original" or not edges[i]:
        start = max((done[e.producer].end_ns for e in edges[i]),
                    default=0.0) if mode == "original" else 0.0
        t = np.arange(nt, dtype=np.float64)
        fin = start + np.broadcast_to((t + 1) * perf.step_ns,
                                      (nb, nt)).copy()
        end = start + perf.compute_ns + perf.output_move_ns
        return LayerResult(m, perf, start, end, fin)
    ready = _ready_matrix(i, m, edges[i], done, use_exhaustive)
    start = float(ready.min())
    if mode == "transform":
        tr = transform_schedule(ready, perf.step_ns, perf.tile_move_ns,
                                tile_bytes=perf.tile_bytes,
                                move_pj_per_byte=perf.move_pj_per_byte)
        return LayerResult(m, perf, start, tr.end_ns + perf.output_move_ns,
                           tr.finish_ns, transformed=True,
                           moved_frac=tr.moved_frac,
                           moved_bytes=tr.moved_bytes,
                           move_energy_pj=tr.move_energy_pj)
    fin = schedule_with_ready(ready, perf.step_ns)
    return LayerResult(m, perf, start,
                       float(fin[:, -1].max()) + perf.output_move_ns, fin)


def _consumers_of(edges: Sequence[Sequence[Edge]], i: int) -> List[int]:
    return [j for j, es in enumerate(edges)
            if any(e.producer == i for e in es)]


def _score_backward(i, m, edges, fixed: Dict[int, Mapping], mode,
                    objective="latency", blend_alpha=0.5,
                    use_exhaustive=False) -> float:
    """Score a producer candidate by the end time (scalarized under the
    objective) of its (fixed-mapping) consumers, assuming the producer
    starts stall-free at t=0."""
    perf = analyze(m)
    done = {i: LayerResult(
        m, perf, 0.0, perf.sequential_ns,
        np.broadcast_to((np.arange(m.n_steps) + 1.0) * perf.step_ns,
                        (m.n_banks, m.n_steps)).copy())}
    cons = [j for j in _consumers_of(edges, i) if j in fixed]
    if mode == "original" or not cons:
        return combine_objective(objective, perf.sequential_ns,
                                 perf.energy_pj, blend_alpha)
    worst = 0.0
    for j in cons:
        mc = fixed[j]
        pc = analyze(mc)
        es = [e for e in edges[j] if e.producer == i]
        ready = _ready_matrix(j, mc, es, done, use_exhaustive)
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
    return worst


def optimize_network(layers: Sequence[LayerSpec],
                     edges: Sequence[Sequence[Edge]],
                     arch: ArchSpec,
                     cfg: Optional[SearchConfig] = None) -> NetworkResult:
    cfg = cfg or SearchConfig()
    with obs.span("search.optimize", n_layers=len(layers), mode=cfg.mode,
                  strategy=cfg.strategy, objective=cfg.objective,
                  engine=cfg.use_engine
                  and not cfg.use_exhaustive_overlap):
        # the OverlaPIM-baseline analysis has no batched engine twin:
        # fall back to the reference path (the engine itself raises if
        # handed the flag directly)
        if cfg.use_engine and not cfg.use_exhaustive_overlap:
            from .engine import optimize_network_engine  # lazy: no cycle
            return optimize_network_engine(layers, edges, arch, cfg)
        return _optimize_network_reference(layers, edges, arch, cfg)


def _optimize_network_reference(layers: Sequence[LayerSpec],
                                edges: Sequence[Sequence[Edge]],
                                arch: ArchSpec,
                                cfg: SearchConfig) -> NetworkResult:
    """Pre-engine per-candidate path — the differential-test oracle."""
    n = len(layers)
    order, backward_part = _visit_order(layers, cfg.strategy)
    exh = cfg.use_exhaustive_overlap

    chosen: Dict[int, Mapping] = {}
    done: Dict[int, LayerResult] = {}
    for i in order:
        cands = candidates(layers[i], arch, cfg, salt=i)
        if i in backward_part:
            best = min(cands,
                       key=lambda m: _score_backward(i, m, edges, chosen,
                                                     cfg.mode,
                                                     cfg.objective,
                                                     cfg.blend_alpha,
                                                     exh))
        else:
            # forward scoring needs producers committed; producers missing
            # (backward half not yet visited) fall back to sequential score
            avail = all(e.producer in done for e in edges[i])
            has_cons = bool(_consumers_of(edges, i))
            if avail:
                best = min(cands, key=lambda m: _score_forward(
                    i, m, edges, done, cfg.mode, has_cons,
                    cfg.objective, cfg.blend_alpha, exh))
            else:
                def _seq_score(m):
                    p = analyze(m)
                    return combine_objective(cfg.objective,
                                             p.sequential_ns, p.energy_pj,
                                             cfg.blend_alpha)
                best = min(cands, key=_seq_score)
        chosen[i] = best
        if all(e.producer in done for e in edges[i]):
            done[i] = _commit(i, best, edges, done, cfg.mode, exh)
    result = evaluate_chain([chosen[i] for i in range(n)], edges,
                            cfg.mode, exh)
    # coordinate-descent refinement (beyond-paper): re-optimize each layer
    # against BOTH its committed producer and consumer — the paper's
    # linear pass is myopic about successors (Section IV-K motivates this)
    for _ in range(cfg.refine_passes if cfg.mode != "original" else 0):
        improved = False
        for i in range(n):
            rcfg = dataclasses.replace(
                cfg, n_candidates=cfg.refine_candidates)
            cands = candidates(layers[i], arch, rcfg, salt=i + 7919)
            cands.append(chosen[i])
            best_m = chosen[i]
            best_t = result.objective_value(cfg.objective, cfg.blend_alpha)
            for m in cands:
                trial = chosen.copy()
                trial[i] = m
                r = evaluate_chain([trial[j] for j in range(n)], edges,
                                   cfg.mode, exh)
                sc = r.objective_value(cfg.objective, cfg.blend_alpha)
                if sc < best_t - 1e-9:
                    best_m, best_t = m, sc
            if best_m is not chosen[i]:
                chosen[i] = best_m
                improved = True
        result = evaluate_chain([chosen[i] for i in range(n)], edges,
                                cfg.mode, exh)
        if not improved:
            break
    result.objective = cfg.objective
    return result


def _visit_order(layers: Sequence[LayerSpec],
                 strategy: str) -> Tuple[List[int], set]:
    n = len(layers)
    if strategy == "forward":
        return list(range(n)), set()
    if strategy == "backward":
        return list(range(n - 1, -1, -1)), set(range(n - 1))
    key = ((lambda l: l.output_size()) if strategy == "middle_output"
           else (lambda l: l.overall_size()))
    mid = max(range(n), key=lambda i: key(layers[i]))
    order = [mid] + list(range(mid - 1, -1, -1)) + list(range(mid + 1, n))
    return order, set(range(mid))
