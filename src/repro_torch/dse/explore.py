"""DSE explorers: grid / random / evolutionary search over arch spaces.

Each explorer proposes ``DesignPoint``s and scores them by running the
full overlap-driven mapping search (``optimize_network`` with the batched
engine) for the configured network/mode/strategy. Scoring goes through one
shared funnel (``_Evaluator``) that

* serves already-scored points from the ``RunJournal`` (content-keyed —
  re-running a finished sweep performs **zero** new mapping searches),
* in serial mode shares a single ``OverlapEngine`` across all arch points
  (per-arch cache bundles, see ``core.engine``; a point's bundle is
  evicted once scored — each arch is visited once per sweep — while the
  engine's content-keyed ``PerfCache`` persists), and
* with ``workers > 0`` fans evaluations out to a process pool. Workers
  receive the *built* ``ArchSpec`` (``to_dict`` round-trip), never the
  ``ParamSpace`` — custom spaces carry unpicklable constraint lambdas,
  and rebuilding a shipped space in the worker would silently diverge
  from a caller-supplied one. Each worker keeps a persistent engine;
  results are bit-identical to serial mode (differentially tested).

All explorers are deterministic in ``DSEConfig.seed``: the same config
proposes the same points in the same order (the evolutionary explorer
selects on journal-identical scores), which is what makes journal resume
exact rather than best-effort.

Proposal generation itself is a pure stream (``proposal_stream`` /
``ProposalStream``): generations are proposed through ``next_batch()``
and advanced only by ``observe()``d records, so *how* a generation got
scored — serial, process pool, or N distributed workers over a shared
journal (``repro_torch.dse.distrib``) — cannot influence what is proposed
next. The distributed coordinator drives exactly these streams.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .. import obs
from ..core.arch import ArchSpec
from ..core.engine import OverlapEngine, optimize_network_engine
from ..core.perf_model import arch_area_proxy, arch_power_proxy
from ..core.interface import describe
from ..core.search import (MODES, OBJECTIVES, STRATEGIES, NetworkResult,
                           SearchConfig, combine_objective)
from .pareto import ParetoFrontier
from .persist import RunJournal, content_key
from .space import DesignPoint, ParamSpace, get_space

EXPLORERS = ("grid", "random", "evolve")


@dataclasses.dataclass
class DSEConfig:
    """One sweep: which space to search, how, and how each point is
    scored. ``budget`` counts *proposed* points (journal hits included —
    a resumed sweep proposes the same points and evaluates none)."""

    family: str = "dram_pim"
    network: str = "resnet18"
    mode: str = "transform"
    strategy: str = "forward"
    explorer: str = "evolve"
    budget: int = 64
    seed: int = 1
    # per-point mapping-search budget
    n_candidates: int = 8
    max_steps: int = 2048
    refine_passes: int = 0
    # mapping-search objective (core.search.OBJECTIVES); non-latency
    # objectives get distinct journal keys and drive the evolutionary
    # explorer's fitness through the record's ``objective_value``
    objective: str = "latency"
    blend_alpha: float = 0.5
    # evolutionary knobs
    population: int = 8
    mutation_rate: float = 0.5
    # evaluation backend
    workers: int = 0              # 0 = serial, shared engine
    journal_path: Optional[str] = None

    def __post_init__(self):
        assert self.mode in MODES, self.mode
        assert self.strategy in STRATEGIES, self.strategy
        assert self.explorer in EXPLORERS, self.explorer
        assert self.objective in OBJECTIVES, self.objective
        assert 0.0 <= self.blend_alpha <= 1.0, \
            f"blend_alpha must be in [0, 1], got {self.blend_alpha}"
        assert self.budget >= 1, "budget must be >= 1"

    def search_config(self) -> SearchConfig:
        """The per-point mapping-search config (always engine-backed)."""
        return SearchConfig(n_candidates=self.n_candidates, seed=self.seed,
                            max_steps=self.max_steps, mode=self.mode,
                            strategy=self.strategy,
                            refine_passes=self.refine_passes,
                            use_engine=True, objective=self.objective,
                            blend_alpha=self.blend_alpha)

    def objective_token(self) -> str:
        """Journal-key token: "blend" depends on its alpha too."""
        if self.objective == "blend":
            return f"blend:{self.blend_alpha!r}"
        return self.objective


@dataclasses.dataclass
class DSEResult:
    config: DSEConfig
    records: List[Dict]                  # proposal order
    frontier: ParetoFrontier
    baseline: Dict                       # the space's default point
    stats: Dict[str, float]

    def best_within_area(self, area_mm2: Optional[float] = None) \
            -> Optional[Dict]:
        """Lowest-latency record with area proxy <= the given budget
        (default: the baseline's area) — the iso-area comparison."""
        cap = self.baseline["area_mm2"] if area_mm2 is None else area_mm2
        eligible = [r for r in self.records if r["area_mm2"] <= cap + 1e-12]
        return min(eligible, key=lambda r: r["total_ns"], default=None)

    def best_by(self, metric: str = "edp_ns_pj") -> Optional[Dict]:
        """Record minimizing one recorded metric. ``edp_ns_pj`` tolerates
        pre-energy journal records (``record_edp``)."""
        def val(r: Dict) -> float:
            if metric == "edp_ns_pj":
                return record_edp(r)
            return r[metric]
        return min(self.records, key=val, default=None)


# ---------------------------------------------------------------------------
# Point evaluation (one full mapping search).
# ---------------------------------------------------------------------------

def key_for(dcfg: DSEConfig, arch_key: str) -> str:
    """THE journal-key derivation — every scoring-relevant ``DSEConfig``
    field must appear here (and only here), or resumed sweeps would
    silently serve stale scores for changed evaluations."""
    return content_key(dcfg.network, dcfg.mode, dcfg.strategy, dcfg.seed,
                       dcfg.n_candidates, dcfg.max_steps,
                       dcfg.refine_passes, arch_key,
                       objective=dcfg.objective_token())


def point_key(space: ParamSpace, point: DesignPoint,
              dcfg: DSEConfig) -> str:
    """Journal key of one design point under one sweep config
    (``key_for`` over the built ``ArchSpec``'s content key)."""
    return key_for(dcfg, space.build(point).to_key())


def record_edp(rec: Dict) -> float:
    """THE energy-delay product of an evaluation record — every report
    and BENCH entry goes through here. Pre-energy journal records lack
    the ``edp_ns_pj`` column; it is recomputed from what they do carry."""
    if "edp_ns_pj" in rec:
        return rec["edp_ns_pj"]
    return rec["total_ns"] * rec["energy_pj"]


def network_energy_pj(result: NetworkResult) -> float:
    """Mapping-level network energy: base (compute + IO) plus the
    movement energy of transform-relocated tiles."""
    return float(sum(l.energy_pj for l in result.layers))


def _search_arch(arch, dcfg: DSEConfig,
                 engine: Optional[OverlapEngine] = None) -> Dict:
    """The mapping-search half of an evaluation (runs in workers too)."""
    desc = describe(dcfg.network)
    t0 = time.perf_counter()
    res = optimize_network_engine(desc.layers, desc.edges, arch,
                                  dcfg.search_config(), engine=engine)
    total_ns = float(res.total_ns)
    energy = network_energy_pj(res)
    return {
        "total_ns": total_ns,
        "energy_pj": energy,
        "move_energy_pj": float(sum(l.move_energy_pj
                                    for l in res.layers)),
        "edp_ns_pj": total_ns * energy,
        "n_layers": len(res.layers),
        "wall_s": time.perf_counter() - t0,
    }


def _make_record(point: DesignPoint, dcfg: DSEConfig,
                 arch: ArchSpec, search_fields: Dict) -> Dict:
    costs = {"area_mm2": arch_area_proxy(arch),
             "power_w": arch_power_proxy(arch)}
    return {
        "family": point.family,
        "point": point.as_dict(),
        "point_key": point.key(),
        "arch_name": arch.name,
        "network": dcfg.network,
        "mode": dcfg.mode,
        "strategy": dcfg.strategy,
        "seed": dcfg.seed,
        "n_candidates": dcfg.n_candidates,
        "max_steps": dcfg.max_steps,
        "objective": dcfg.objective,
        "objective_value": combine_objective(
            dcfg.objective, search_fields["total_ns"],
            search_fields["energy_pj"], dcfg.blend_alpha),
        "area_mm2": costs["area_mm2"],
        "power_w": costs["power_w"],
        **search_fields,
    }


def evaluate_point(space: ParamSpace, point: DesignPoint, dcfg: DSEConfig,
                   engine: Optional[OverlapEngine] = None) -> Dict:
    """Score one design point: build the arch, run the mapping search,
    attach the static cost proxies."""
    arch = space.build(point)
    return _make_record(point, dcfg, arch,
                        _search_arch(arch, dcfg, engine))


# Process-pool worker state: one engine per worker process, reused across
# every point that worker evaluates. Workers receive the *built*
# ``ArchSpec`` (via to_dict), never the ParamSpace: custom spaces carry
# unpicklable constraint lambdas, and rebuilding a shipped space in the
# worker would silently diverge from a caller-supplied one.
_WORKER_ENGINE: Optional[OverlapEngine] = None


def _pool_eval(payload: Tuple[Dict, Dict]) -> Dict:
    global _WORKER_ENGINE
    if _WORKER_ENGINE is None:
        _WORKER_ENGINE = OverlapEngine()
    dcfg_dict, arch_dict = payload
    dcfg = DSEConfig(**dcfg_dict)
    arch = ArchSpec.from_dict(arch_dict)
    fields = _search_arch(arch, dcfg, engine=_WORKER_ENGINE)
    # each arch point is scored once per sweep (explorers dedup, the
    # journal absorbs revisits) — evict its bundle to bound worker memory
    _WORKER_ENGINE.evict_arch(arch)
    return fields


class _Evaluator:
    """Journal-aware batch scorer (serial shared engine or process pool).

    ``engine`` may be caller-supplied (the mapping service shares ONE
    engine across requests so repeat arch families resume warm caches);
    then bundle *retention* is the caller's policy — the per-point
    ``evict_arch`` that bounds a one-shot sweep's memory is skipped, and
    the caller trims with ``OverlapEngine.evict_lru`` between sweeps."""

    def __init__(self, space: ParamSpace, dcfg: DSEConfig,
                 journal: RunJournal,
                 engine: Optional[OverlapEngine] = None):
        self.space = space
        self.dcfg = dcfg
        self.journal = journal
        self.engine = engine if engine is not None else OverlapEngine()
        self._evict_after_score = engine is None
        self.n_evaluated = 0
        self.n_from_journal = 0
        self._pool = None
        if dcfg.workers > 0:
            import concurrent.futures
            self._pool = concurrent.futures.ProcessPoolExecutor(
                max_workers=dcfg.workers)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        self.engine.publish_metrics()

    def __call__(self, points: Sequence[DesignPoint]) -> List[Dict]:
        """Scores in point order; journal hits cost nothing."""
        built = [self.space.build(p) for p in points]
        keys = [key_for(self.dcfg, a.to_key()) for a in built]
        out: List[Optional[Dict]] = [self.journal.get(k) for k in keys]
        misses = [i for i, r in enumerate(out) if r is None]
        self.n_from_journal += len(points) - len(misses)
        obs.inc("dse.proposed", len(points))
        obs.inc("dse.journal_hits", len(points) - len(misses))
        if misses:
            archs = [built[i] for i in misses]
            with obs.span("dse.evaluate_batch", n=len(misses),
                          network=self.dcfg.network, mode=self.dcfg.mode):
                if self._pool is not None:
                    dd = dataclasses.asdict(self.dcfg)
                    fields = list(self._pool.map(
                        _pool_eval, [(dd, a.to_dict()) for a in archs]))
                else:
                    fields = []
                    for a in archs:
                        fields.append(_search_arch(a, self.dcfg,
                                                   engine=self.engine))
                        # scored once per sweep: evict to bound memory
                        # while the engine's PerfCache keeps cross-arch
                        # reuse (shared engines retain — caller's policy)
                        if self._evict_after_score:
                            self.engine.evict_arch(a)
            for i, a, f in zip(misses, archs, fields):
                rec = _make_record(points[i], self.dcfg, a, f)
                out[i] = self.journal.record(keys[i], rec)
                obs.observe("dse.eval_seconds", f["wall_s"])
            self.n_evaluated += len(misses)
            obs.inc("dse.evaluated", len(misses))
            # no-op for file journals; shard-publish for shared-dir ones
            self.journal.publish()
        return out  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Proposal streams. Proposal generation is a *pure, seed-deterministic
# stream* decoupled from evaluation: next_batch() yields the next
# generation of fresh points, observe() feeds their scored records back
# in batch order — the ONLY channel through which evaluation influences
# later proposals. Identical observed records => identical proposal
# sequence, no matter who (or how many distributed workers) produced
# them; that is the distributed-sweep determinism argument (DESIGN.md
# Section 10): N workers reproduce the 1-worker frontier bit-exactly.
# ---------------------------------------------------------------------------

class ProposalStream:
    """Alternating ``next_batch()`` / ``observe()`` proposal protocol.

    ``next_batch`` returns the next generation of fresh, deduplicated
    ``DesignPoint``s (``None`` once the budget is spent or the space is
    exhausted); ``observe`` must then be called with the scored records
    of exactly that batch, in batch order, before the next generation
    can be proposed."""

    def __init__(self, space: ParamSpace, dcfg: DSEConfig):
        self.space = space
        self.dcfg = dcfg
        self.n_proposed = 0
        self._awaiting = False

    def next_batch(self) -> Optional[List[DesignPoint]]:
        """Propose the next generation (``None`` = stream exhausted)."""
        assert not self._awaiting, \
            "observe() the previous batch before proposing the next"
        batch = self._propose()
        if not batch:
            return None
        self.n_proposed += len(batch)
        self._awaiting = True
        return batch

    def observe(self, points: Sequence[DesignPoint],
                records: Sequence[Dict]) -> None:
        """Feed back the scored records of the pending batch, in batch
        order — the only channel from evaluation to later proposals."""
        assert self._awaiting, "observe() without a pending batch"
        assert len(points) == len(records)
        self._awaiting = False
        self._digest(points, records)

    def _propose(self) -> List[DesignPoint]:
        raise NotImplementedError

    def _digest(self, points: Sequence[DesignPoint],
                records: Sequence[Dict]) -> None:
        pass  # grid/random ignore scores


class _OneShotStream(ProposalStream):
    """grid/random: the whole proposal list is known upfront."""

    def __init__(self, space: ParamSpace, dcfg: DSEConfig,
                 points: List[DesignPoint]):
        super().__init__(space, dcfg)
        self._points = points

    def _propose(self) -> List[DesignPoint]:
        pts, self._points = self._points, []
        return pts


def _grid_list(space: ParamSpace, dcfg: DSEConfig) -> List[DesignPoint]:
    """Default point first (the baseline), then grid order."""
    out, seen = [space.default()], {space.default().key()}
    for p in space.enumerate():
        if len(out) >= dcfg.budget:
            break
        if p.key() not in seen:
            seen.add(p.key())
            out.append(p)
    return out


def _random_list(space: ParamSpace, dcfg: DSEConfig) -> List[DesignPoint]:
    rng = random.Random(dcfg.seed)
    out, seen = [space.default()], {space.default().key()}
    tries = 0
    while len(out) < dcfg.budget and tries < dcfg.budget * 64:
        p = space.sample(rng)
        tries += 1
        if p.key() not in seen:
            seen.add(p.key())
            out.append(p)
    return out


class _EvolveStream(ProposalStream):
    """(mu + lambda)-style evolution over arch genes.

    Generation 0 is the default point plus random samples. Parents are
    tournament-selected with Pareto-frontier membership beating raw
    latency; children are per-gene crossover then (p=mutation_rate) an
    adjacent-value mutation. Proposals are deduplicated against
    everything seen, so the budget is spent on distinct points. State
    advances exclusively through ``observe``d records — in a distributed
    sweep those come from the *merged* journal, so every worker count
    sees the same scores and the rng consumes the same sequence."""

    def __init__(self, space: ParamSpace, dcfg: DSEConfig):
        super().__init__(space, dcfg)
        self.rng = random.Random(dcfg.seed ^ 0x9E3779B9)
        self.pop_size = max(2, min(dcfg.population, dcfg.budget))
        self.seen: set = set()
        self.pool: List[Tuple[DesignPoint, Dict]] = []
        self.frontier = ParetoFrontier()
        self.front_keys: set = set()   # refreshed once per generation

    def _fitness(self, entry: Tuple[DesignPoint, Dict]) -> Tuple[int, float]:
        # frontier membership first, then the sweep's scoring objective
        # (pre-energy journal records lack objective_value; they can only
        # have been produced by a latency sweep, where it == total_ns)
        p, rec = entry
        return (0 if rec["point_key"] in self.front_keys else 1,
                rec.get("objective_value", rec["total_ns"]))

    def _select(self) -> DesignPoint:
        a, b = self.rng.choice(self.pool), self.rng.choice(self.pool)
        return min((a, b), key=self._fitness)[0]

    def _propose(self) -> List[DesignPoint]:
        if self.n_proposed == 0:
            init = [self.space.default()]
            self.seen.add(init[0].key())
            tries = 0
            while len(init) < self.pop_size and tries < self.pop_size * 64:
                p = self.space.sample(self.rng)
                tries += 1
                if p.key() not in self.seen:
                    self.seen.add(p.key())
                    init.append(p)
            return init[:self.dcfg.budget]
        batch: List[DesignPoint] = []
        attempts = 0
        want = min(self.pop_size, self.dcfg.budget - self.n_proposed)
        while len(batch) < want and attempts < want * 64:
            attempts += 1
            child = self.space.crossover(self._select(), self._select(),
                                         self.rng)
            if self.rng.random() < self.dcfg.mutation_rate:
                child = self.space.mutate(child, self.rng)
            if child.key() in self.seen:
                child = self.space.mutate(child, self.rng)
            if child.key() in self.seen:
                continue
            self.seen.add(child.key())
            batch.append(child)
        return batch  # empty => space exhausted => stream ends

    def _digest(self, points: Sequence[DesignPoint],
                records: Sequence[Dict]) -> None:
        for p, rec in zip(points, records):
            self.frontier.add_record(p.key(), rec)
        if not self.pool:          # generation 0: seed the parent pool
            self.pool = list(zip(points, records))
            self.front_keys = self.frontier.key_set()
            return
        self.front_keys = self.frontier.key_set()
        self.pool.extend(zip(points, records))
        self.pool.sort(key=self._fitness)
        del self.pool[max(self.pop_size, 2):]


def proposal_stream(space: ParamSpace, dcfg: DSEConfig) -> ProposalStream:
    """THE explorer factory — serial ``run_dse`` and the distributed
    coordinator drive the same streams, which is what makes them agree."""
    if dcfg.explorer == "grid":
        return _OneShotStream(space, dcfg, _grid_list(space, dcfg))
    if dcfg.explorer == "random":
        return _OneShotStream(space, dcfg, _random_list(space, dcfg))
    return _EvolveStream(space, dcfg)


def run_dse(dcfg: DSEConfig, space: Optional[ParamSpace] = None,
            journal: Optional[RunJournal] = None,
            deadline_s: Optional[float] = None,
            engine: Optional[OverlapEngine] = None) -> DSEResult:
    """Run one sweep; returns records, the Pareto frontier and stats.

    The space default point is always proposed first, so every result
    carries a baseline for iso-area comparisons.

    ``engine`` shares a caller-owned ``OverlapEngine`` across sweeps
    (bundle retention is then the caller's policy — see ``_Evaluator``);
    results are bit-identical either way, since every cache is
    content-keyed. Serial-only (``workers == 0``): the process pool
    keeps its per-worker engines.

    ``deadline_s`` bounds the sweep's wall clock: scoring switches to
    point-at-a-time and stops once the deadline passes, returning the
    best-so-far frontier (``stats["deadline_hit"]`` is then True). The
    baseline is always scored, deadline or not, so the result contract
    holds. Because proposal and evaluation order are deterministic, a
    deadline only truncates a deterministic evaluation sequence — and
    journal hits are near-free, so a warm re-request replays the prefix
    instantly and spends its deadline entirely on new points."""
    space = space or get_space(dcfg.family)
    journal = journal if journal is not None \
        else RunJournal(dcfg.journal_path)
    ev = _Evaluator(space, dcfg, journal, engine=engine)
    frontier = ParetoFrontier()
    records: List[Dict] = []
    t0 = time.perf_counter()
    deadline_hit = False

    def expired() -> bool:
        return (deadline_s is not None
                and time.perf_counter() - t0 >= deadline_s)

    sweep_span = obs.span("dse.sweep", family=dcfg.family,
                          network=dcfg.network, explorer=dcfg.explorer,
                          budget=dcfg.budget)
    sweep_span.__enter__()
    try:
        stream = proposal_stream(space, dcfg)
        while True:
            # at least one point (the baseline) is always scored
            if records and expired():
                deadline_hit = True
                break
            batch = stream.next_batch()
            if batch is None:
                break
            if deadline_s is None:
                recs = ev(batch)
            else:
                recs = []
                for p in batch:
                    recs.append(ev([p])[0])
                    if len(recs) < len(batch) and expired():
                        deadline_hit = True
                        break
            for p, rec in zip(batch, recs):
                records.append(rec)
                frontier.add_record(p.key(), rec)
            if deadline_hit:
                break   # partial batch: the stream is never observe()d
            stream.observe(batch, recs)
    finally:
        ev.close()
        sweep_span.__exit__(None, None, None)
    baseline = records[0]
    stats = {
        "proposed": len(records),
        "evaluated": ev.n_evaluated,
        "from_journal": ev.n_from_journal,
        "frontier": len(frontier),
        "wall_s": time.perf_counter() - t0,
        "deadline_hit": deadline_hit,
    }
    return DSEResult(config=dcfg, records=records, frontier=frontier,
                     baseline=baseline, stats=stats)
