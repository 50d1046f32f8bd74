"""Mapping-as-a-service: deployment requests answered by the DSE stack.

The paper's pitch is that overlap-driven search is fast enough to use
*on demand*; NicePIM/PIMSYN frame the same capability as a
deployment-time service — "best PIM config for this network under this
budget". ``MappingService`` is that service: a ``MappingRequest``
(network, arch family, objective, optional area budget and wall-clock
deadline) in, a ``MappingResponse`` (the best (arch, mapping) pair plus
the full latency/energy/area Pareto frontier) out. Both dataclasses
round-trip through plain dicts/JSON; ``benchmarks/run.py serve-dse`` is
the in-process client and ``repro_torch.serve.transport`` puts the same wire
forms behind HTTP (``run.py serve-http``). See DESIGN.md Sections 11
and 13.

Three layers make repeat traffic cheap:

* **Response memo** — an exact repeat of a completed request (same
  ``cache_key``) returns the stored ``MappingResponse`` without
  touching the queue. The memo (and the materialized loop-nest cache)
  is LRU-bounded and optionally persisted to ``persist_dir`` so a
  restarted server answers yesterday's traffic without re-sweeping.
* **Run journal** — all sweeps share one content-keyed ``RunJournal``
  (keys embed network/mode/strategy/seed/search budget/arch, so
  heterogeneous requests coexist in one store). A warm request — after
  a restart, from a second service instance on the same path, or a
  *bigger-budget* variant of an earlier request — re-proposes its
  points and serves every already-scored one from the journal with
  zero new mapping searches.
* **Request coalescing** — concurrent identical requests attach to one
  in-flight job (``repro_torch.serve.jobs``) and share a single sweep.

Below the caches, serial sweeps share one long-lived ``OverlapEngine``
(LRU-capped at ``engine_bundle_cap`` arch bundles), so *different*
requests in the same arch family warm each other's ``PerfCache`` and
overlap tables across requests — the cross-request analogue of the
paper's within-search reuse.

Admission control (``max_pending``): once that many distinct requests
are waiting for a worker, further non-coalescing submissions are shed
with ``QueueFull`` (HTTP 429 at the transport) and counted under
``serve.shed`` — bounded queues with explicit load-shed, per the
MLPerf offline-serving discipline, instead of an unbounded backlog.

Determinism: sweeps are seed-deterministic and journal records are
content-keyed, so the same request always yields a byte-identical
``frontier_json`` (the ``ParetoFrontier.canonical_json`` artifact) —
whether scored fresh, replayed from the journal, memoized, or
coalesced. Deadline requests truncate a deterministic evaluation
order, so their frontiers converge to the full-budget answer as the
journal warms; deadline-truncated responses are never memoized.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from .. import obs
from ..obs import Registry
from ..obs.flight import FlightRecorder
from ..obs.window import SLOTracker, WindowHistogram
from ..core.engine import OverlapEngine
from ..core.search import combine_objective
from ..dse.driver import (JOURNAL_ROOT, execute_sweep, frontier_points,
                          sweep_summary)
from ..dse.explore import DSEConfig, DSEResult
from ..dse.persist import RunJournal
from ..dse.space import ParamSpace, get_space
from .jobs import Job, JobQueue, QueueFull


@dataclasses.dataclass(frozen=True)
class MappingRequest:
    """One deployment request: "best (arch, mapping) for this network".

    The scoring-relevant fields mirror ``DSEConfig``; on top of them
    ``area_budget_mm2`` constrains the winner (iso-area deployment),
    ``deadline_s`` bounds the request's wall clock (best-so-far answer),
    ``distributed`` fans the sweep out over N local worker processes,
    and ``include_mapping`` materializes the winning arch's per-layer
    loop nests into the response (one extra deterministic mapping
    search the first time a winner is seen — cached per winning arch
    afterwards, shared across requests; it runs *after* the sweep, so
    it is not bounded by ``deadline_s`` and not counted in
    ``evaluated``)."""

    network: str
    family: str = "dram_pim"
    mode: str = "transform"
    strategy: str = "forward"
    objective: str = "latency"
    blend_alpha: float = 0.5
    explorer: str = "evolve"
    budget: int = 16
    seed: int = 1
    n_candidates: int = 8
    max_steps: int = 2048
    area_budget_mm2: Optional[float] = None
    deadline_s: Optional[float] = None
    distributed: int = 0
    include_mapping: bool = False

    def __post_init__(self):
        self.dse_config()   # delegate field validation to DSEConfig
        from ..core.interface import known_network
        if not known_network(self.network):
            raise ValueError(
                f"unknown network {self.network!r}: not a core network "
                "and not a zoo scenario "
                "('<arch>[:phase][@length][xblocks]', e.g. "
                "'deepseek_moe_16b:prefill@2048')")
        if self.deadline_s is not None and self.deadline_s < 0:
            raise ValueError("deadline_s must be >= 0")
        if self.deadline_s is not None and self.distributed:
            raise ValueError("deadline_s is serial-only; drop it or "
                             "drop distributed")

    def dse_config(self) -> DSEConfig:
        """The sweep this request asks for (journal-less: the service
        supplies its own shared journal)."""
        return DSEConfig(
            family=self.family, network=self.network, mode=self.mode,
            strategy=self.strategy, explorer=self.explorer,
            budget=self.budget, seed=self.seed,
            n_candidates=self.n_candidates, max_steps=self.max_steps,
            objective=self.objective, blend_alpha=self.blend_alpha)

    def to_dict(self) -> Dict:
        """Plain-dict wire form (JSON-safe)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "MappingRequest":
        """Inverse of ``to_dict``; unknown keys are an error (a typo'd
        constraint silently ignored would be a wrong deployment)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - fields)
        if unknown:
            raise ValueError(f"unknown request fields: {unknown}")
        return cls(**d)

    def cache_key(self) -> str:
        """Content identity of the request — the memo/coalescing key.
        Every field enters (two requests differing only in deadline or
        response shape must not share a memoized response)."""
        blob = json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha1(blob.encode()).hexdigest()


@dataclasses.dataclass
class MappingResponse:
    """The service's answer: winner, baseline, frontier, provenance.

    ``best`` is the full evaluation record of the chosen (arch, mapping)
    pair — ``None`` with ``status="infeasible"`` when no scored point
    fits ``area_budget_mm2``. ``frontier_json`` is the canonical
    frontier serialization (byte-identical across repeats — THE
    determinism artifact); ``served_from`` records how the answer was
    produced (``search`` / ``journal`` / ``memo``); ``summary`` is the
    ``sweep_summary`` dict minus ``frontier_points``, which is carried
    once, top-level.

    Provenance counts the work done for *this* answer: a memo replay
    reports ``evaluated=0``, ``from_journal=0`` and ``wall_s=0.0`` —
    the replay cost nothing — while the frontier/winner payload stays
    byte-identical to the originating response."""

    request_key: str
    status: str                       # "ok" | "infeasible"
    network: str
    family: str
    objective: str
    best: Optional[Dict]
    baseline: Dict
    frontier_points: List[Dict]
    frontier_json: str
    summary: Dict
    evaluated: int
    from_journal: int
    proposed: int
    deadline_hit: bool
    wall_s: float
    served_from: str
    mapping: Optional[List[Dict]] = None

    def to_dict(self) -> Dict:
        """Plain-dict wire form (JSON-safe)."""
        return dataclasses.asdict(self)

    def to_json(self, indent: Optional[int] = None) -> str:
        """JSON wire form of ``to_dict``."""
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent)

    @classmethod
    def from_dict(cls, d: Dict) -> "MappingResponse":
        """Inverse of ``to_dict`` — HTTP clients and the persisted-memo
        reload path; unknown keys are an error so schema drift between
        a persisted memo and the running code surfaces loudly."""
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - fields)
        if unknown:
            raise ValueError(f"unknown response fields: {unknown}")
        return cls(**d)


class _LRU:
    """Tiny bounded least-recently-used map (``get`` refreshes recency,
    ``put`` evicts the oldest entries past ``cap``). Not itself locked —
    the service touches it only under its own ``_lock``."""

    def __init__(self, cap: int):
        self.cap = max(1, int(cap))
        self._d: "OrderedDict[str, Any]" = OrderedDict()

    def get(self, key: str, default=None):
        """Value for ``key`` (refreshing its recency) or ``default``."""
        if key not in self._d:
            return default
        self._d.move_to_end(key)
        return self._d[key]

    def put(self, key: str, value) -> None:
        """Insert/overwrite ``key``, evicting the LRU tail past cap."""
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.cap:
            self._d.popitem(last=False)

    def items(self) -> List[Tuple[str, Any]]:
        """Snapshot of (key, value) pairs, oldest first."""
        return list(self._d.items())

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: str) -> bool:
        return key in self._d


class MappingService:
    """Request/response engine over the DSE stack (module docstring).

    One instance owns one ``RunJournal`` (``journal_path``; in-memory
    when None — tests, throwaway services), an LRU response memo
    (``memo_cap``) and loop-nest cache (``nest_cap``), a shared serial
    ``OverlapEngine`` capped at ``engine_bundle_cap`` arch bundles, and
    a staged ``JobQueue`` of ``max_workers`` sweep threads admitting at
    most ``max_pending`` waiting requests (None = unbounded; beyond it
    ``submit`` raises ``QueueFull``). ``space_overrides`` maps family
    names to caller-built ``ParamSpace``s (restricted search spaces,
    tests); families not overridden resolve through
    ``repro_torch.dse.space.get_space``. ``shared_root`` hosts the
    per-request shared directories of ``distributed`` requests (each
    request key gets its own, so concurrent distributed sweeps never
    share a STOP file, while identical re-requests reuse their shards).
    ``persist_dir`` write-throughs the memo and nest caches to JSONL so
    a restart starts warm; ``compact_every_s`` runs ``compact()`` (the
    journal and both persisted caches) on a background cadence.

    Observability (purely observational — DESIGN.md Sections 12/14):
    ``flight_cap`` bounds the per-request flight-recorder ring (0
    disables it), with full detail retained for requests slower than
    ``slow_threshold_s``; ``window_s`` sizes the sliding window behind
    the recent-latency p50/p99 gauges (0 disables); ``slo_target_s``
    (when set) tracks an availability SLO at ``slo_goal`` — per-request
    ok/breach counters plus a windowed burn-rate gauge."""

    def __init__(self, journal_path: Optional[str] = None,
                 journal: Optional[RunJournal] = None,
                 max_workers: int = 1,
                 space_overrides: Optional[Dict[str, ParamSpace]] = None,
                 shared_root: Optional[str] = None,
                 max_pending: Optional[int] = None,
                 memo_cap: int = 256,
                 nest_cap: int = 256,
                 persist_dir: Optional[str] = None,
                 compact_every_s: Optional[float] = None,
                 engine_bundle_cap: int = 8,
                 flight_cap: int = 256,
                 slow_threshold_s: float = 1.0,
                 window_s: float = 60.0,
                 slo_target_s: Optional[float] = None,
                 slo_goal: float = 0.99):
        assert journal_path is None or journal is None, \
            "pass a journal_path or a journal, not both"
        self.journal = journal if journal is not None \
            else RunJournal(journal_path)
        self.shared_root = shared_root or os.path.join(
            JOURNAL_ROOT, "service_shared")
        self._spaces = dict(space_overrides or {})
        self._memo: _LRU = _LRU(memo_cap)
        # materialized loop nests, keyed by the winning record's journal
        # content key — deterministic, so one search serves every
        # request (deadline repeats, warm restarts) that picks the same
        # (network, search config, arch) winner
        self._mappings: _LRU = _LRU(nest_cap)
        self._persist_dir = persist_dir
        # service metrics live in the process-global registry when
        # telemetry is enabled at construction time, else in a private
        # one — either way the ``stats`` property always counts
        self._reg: Registry = obs.registry() or Registry()
        # _lock guards every piece of cross-request mutable state the
        # worker threads share: the memo, the nest cache, the journal's
        # compound check-then-record in _absorb, and the persist files
        self._lock = threading.Lock()
        # the shared serial-sweep engine is NOT thread-safe; sweeps and
        # nest materialization take _engine_lock for their whole run
        # (scoring is GIL-bound, so serializing it costs little and the
        # cross-request PerfCache warming is worth far more)
        self._engine = OverlapEngine()
        self._engine_lock = threading.Lock()
        self.engine_bundle_cap = engine_bundle_cap
        # flight recorder + sliding windows: observational only — no
        # request-path code reads them, so any setting produces
        # byte-identical responses (pinned by the determinism tests)
        self.flight = FlightRecorder(cap=flight_cap,
                                     slow_threshold_s=slow_threshold_s)
        self._window = WindowHistogram(window_s=window_s) \
            if window_s and window_s > 0 else None
        self._slo = SLOTracker(slo_target_s, goal=slo_goal,
                               window_s=window_s or 60.0) \
            if slo_target_s is not None else None
        self._load_persisted()
        self._queue = JobQueue(
            max_workers=max_workers, max_pending=max_pending,
            depth_gauge=self._reg.gauge("serve.queue.depth"))
        self.compact_every_s = compact_every_s
        self._stop = threading.Event()
        self._compactor: Optional[threading.Thread] = None
        if compact_every_s is not None and compact_every_s > 0:
            self._compactor = threading.Thread(
                target=self._compact_loop, daemon=True,
                name="mapping-compact")
            self._compactor.start()

    @property
    def stats(self) -> Dict[str, int]:
        """Legacy counter view (requests / memo_hits / coalesced /
        sweeps / shed) backed by the ``serve.*`` registry counters."""
        c = self._reg.counter
        return {"requests": int(c("serve.requests").value),
                "memo_hits": int(c("serve.memo_hits").value),
                "coalesced": int(c("serve.coalesced").value),
                "sweeps": int(c("serve.sweeps").value),
                "shed": int(c("serve.shed").value)}

    def metrics_snapshot(self) -> Dict:
        """Full snapshot of the service's metrics registry (counters,
        queue-depth gauge, request-latency histogram), refreshed with
        the sliding-window recent-latency gauges and the SLO burn rate
        (computed at scrape time, not on the request path), plus the
        flight-recorder ring under the ``"flight"`` key (ignored by
        ``render_prometheus``; rendered by ``render_report``)."""
        self._publish_window_gauges()
        snap = self._reg.snapshot()
        if self.flight.enabled:
            snap["flight"] = self.flight.snapshot()
        return snap

    def _publish_window_gauges(self) -> None:
        if self._window is not None:
            g = self._reg.gauge
            g("serve.request_seconds.window.count").set(
                float(self._window.count()))
            g("serve.request_seconds.window.p50").set(
                self._window.quantile(0.50))
            g("serve.request_seconds.window.p99").set(
                self._window.quantile(0.99))
        if self._slo is not None:
            self._reg.gauge("serve.slo.burn_rate").set(
                self._slo.burn_rate())
            self._reg.gauge("serve.slo.target_s").set(self._slo.target_s)

    def _observe_request(self, dur_s: float) -> None:
        """One per-submission latency observation, fanned out to the
        all-time histogram, the sliding window, and the SLO tracker."""
        self._reg.histogram("serve.request_seconds").observe(dur_s)
        if self._window is not None:
            self._window.observe(dur_s)
        if self._slo is not None:
            self._slo.observe(dur_s)
            self._reg.counter(
                "serve.slo.ok" if dur_s <= self._slo.target_s
                else "serve.slo.breach").inc()

    @property
    def registry(self) -> Registry:
        """The registry this service counts into (the process-global
        one when telemetry was enabled at construction, else private);
        ``GET /v1/metrics`` renders a snapshot of it."""
        return self._reg

    # -- client surface -----------------------------------------------------

    def submit(self, req: MappingRequest) -> Job:
        """Enqueue a request; returns immediately with a ``Job`` whose
        ``result()`` is the ``MappingResponse``. Memoized requests get
        a pre-completed job; identical in-flight requests coalesce
        (exempt from admission control). Raises ``QueueFull`` — after
        counting the arrival under ``serve.shed`` — when ``max_pending``
        distinct requests are already waiting."""
        key = req.cache_key()
        t0 = time.perf_counter()
        self._reg.counter("serve.requests").inc()
        with self._lock:
            memo = self._memo.get(key)
        if memo is not None:
            self._reg.counter("serve.memo_hits").inc()
            self._reg.counter("serve.served_from.memo").inc()
            dur = time.perf_counter() - t0
            self._observe_request(dur)
            # provenance counts work done for THIS answer: a replay
            # evaluated nothing and took no wall clock
            resp = dataclasses.replace(
                memo, served_from="memo", evaluated=0, from_journal=0,
                wall_s=0.0)
            self.flight.record(self._flight_rec(
                req, key, served_from="memo", outcome="ok",
                status=resp.status, total_s=dur, resp=resp))
            return Job.completed(key, resp)
        extra: Dict[str, Any] = {}
        try:
            job, coalesced = self._queue.submit(
                key, lambda: self._run(req, key, t0, extra))
        except QueueFull:
            self._reg.counter("serve.shed").inc()
            self.flight.record(self._flight_rec(
                req, key, served_from="shed", outcome="shed",
                status="shed", total_s=time.perf_counter() - t0))
            raise
        if coalesced:
            self._reg.counter("serve.coalesced").inc()
            self._reg.counter("serve.served_from.coalesced").inc()
            # the originating submission's t0 flows through _run; this
            # attachment records its own wait so coalesced waiters are
            # visible in the latency histogram too
            def _on_done(done_job: Job, _t0: float = t0) -> None:
                dur = time.perf_counter() - _t0
                self._observe_request(dur)
                self.flight.record(self._flight_rec(
                    req, key, served_from="coalesced",
                    outcome="error" if done_job.status == "failed"
                    else "ok",
                    status="error" if done_job.status == "failed"
                    else "ok",
                    admit_wait_s=dur, total_s=dur))
            job.add_done_callback(_on_done)
        else:
            job.add_done_callback(
                lambda done_job: self._flight_finish(req, key, done_job,
                                                     extra))
        return job

    def request(self, req: MappingRequest,
                timeout: Optional[float] = None) -> MappingResponse:
        """Blocking convenience: ``submit(req).result(timeout)``."""
        return self.submit(req).result(timeout)

    def compact(self) -> None:
        """One maintenance pass: compact the journal's backing store
        and rewrite the persisted memo/nest files to their live LRU
        contents (dropping evicted and superseded lines). Safe to call
        concurrently with serving; counted under ``serve.compactions``."""
        self.journal.compact()
        with self._lock:
            if self._persist_dir is not None:
                self._rewrite_jsonl(
                    self._memo_path(),
                    [{"key": k, "resp": r.to_dict()}
                     for k, r in self._memo.items()])
                self._rewrite_jsonl(
                    self._nests_path(),
                    [{"key": k, "mapping": m}
                     for k, m in self._mappings.items()])
        self._reg.counter("serve.compactions").inc()

    def close(self) -> None:
        """Drain in-flight sweeps, stop the worker and maintenance
        threads, and publish the engine's final counter deltas."""
        self._stop.set()
        if self._compactor is not None:
            self._compactor.join()
            self._compactor = None
        self._queue.shutdown(wait=True)
        self._engine.publish_metrics(self._reg)

    # -- internals ----------------------------------------------------------

    def _space(self, family: str) -> ParamSpace:
        return self._spaces.get(family) or get_space(family)

    def _flight_rec(self, req: MappingRequest, key: str, *,
                    served_from: str, outcome: str, status: str,
                    admit_wait_s: float = 0.0, evaluate_s: float = 0.0,
                    respond_s: float = 0.0, total_s: float = 0.0,
                    resp: Optional[MappingResponse] = None) -> Dict:
        """One compact flight record (``obs.flight.CORE_FIELDS``)."""
        rec = {"key": key, "network": req.network, "family": req.family,
               "objective": req.objective, "served_from": served_from,
               "outcome": outcome, "status": status,
               "admit_wait_s": admit_wait_s, "evaluate_s": evaluate_s,
               "respond_s": respond_s, "total_s": total_s,
               "evaluated": 0, "from_journal": 0, "proposed": 0,
               "deadline_hit": False}
        if resp is not None:
            rec.update(evaluated=resp.evaluated,
                       from_journal=resp.from_journal,
                       proposed=resp.proposed,
                       deadline_hit=resp.deadline_hit)
        return rec

    def _flight_finish(self, req: MappingRequest, key: str, job: Job,
                       extra: Dict) -> None:
        """Done-callback for fresh (non-coalesced) jobs: turn the job's
        stage timestamps into one flight record. By construction
        ``admit_wait + evaluate + respond == t_finish - t_submit``; the
        published ``serve.request_seconds`` observation happens at the
        end of ``_run`` (the evaluate stage), so it equals
        admit_wait + evaluate up to the submit-side epsilon — respond
        is the documented slack (DESIGN.md Section 14)."""
        ts, te0 = job.t_submit, job.t_eval_start
        te1, tf = job.t_eval_end, job.t_finish
        admit = (te0 - ts) if ts is not None and te0 is not None else 0.0
        evaluate = (te1 - te0) \
            if te0 is not None and te1 is not None else 0.0
        respond = (tf - te1) if te1 is not None and tf is not None else 0.0
        total = (tf - ts) if ts is not None and tf is not None else 0.0
        resp: Optional[MappingResponse] = None
        err: Optional[str] = None
        if job.status == "failed":
            try:
                job.result(timeout=0)
            except BaseException as e:   # the job's stored exception
                err = f"{type(e).__name__}: {e}"
        else:
            resp = job._result
        rec = self._flight_rec(
            req, key,
            served_from=resp.served_from if resp is not None else "error",
            outcome="ok" if err is None else "error",
            status=resp.status if resp is not None else "error",
            admit_wait_s=admit, evaluate_s=evaluate, respond_s=respond,
            total_s=total, resp=resp)
        detail: Dict[str, Any] = {"request": req.to_dict()}
        if err is not None:
            detail["error"] = err
        if resp is not None:
            detail["summary"] = resp.summary
            detail["wall_s"] = resp.wall_s
            detail["frontier_size"] = len(resp.frontier_points)
        if extra.get("engine_delta") is not None:
            detail["engine_delta"] = extra["engine_delta"]
        self.flight.record(rec, detail)

    def _run(self, req: MappingRequest, key: str,
             t0: Optional[float] = None,
             extra: Optional[Dict] = None) -> MappingResponse:
        self._reg.counter("serve.sweeps").inc()
        with obs.span("serve.request", network=req.network,
                      family=req.family, budget=req.budget):
            cfg = req.dse_config()
            if req.distributed > 0:
                if req.family in self._spaces:
                    raise ValueError("space_overrides are serial-only "
                                     "(spaces do not pickle to workers)")
                res = execute_sweep(
                    cfg, distributed=req.distributed,
                    shared_dir=os.path.join(self.shared_root, key[:16]))
                self._absorb(res)
            else:
                # the shared engine retains this family's arch bundles
                # (and the content-keyed PerfCache), so the next
                # same-family request starts warm; the LRU cap keeps a
                # many-tenant server's memory bounded
                with self._engine_lock:
                    before = dict(self._engine.stats)
                    res = execute_sweep(
                        cfg, space=self._space(req.family),
                        journal=self.journal,
                        deadline_s=req.deadline_s,
                        engine=self._engine)
                    self._engine.evict_lru(self.engine_bundle_cap)
                    # publish inside the lock so the before/after stats
                    # diff is this sweep's alone (publish folds the
                    # PerfCache hit/miss totals into ``stats`` first)
                    self._engine.publish_metrics(self._reg)
                    after = dict(self._engine.stats)
                if extra is not None:
                    extra["engine_delta"] = {
                        k: after[k] - before.get(k, 0)
                        for k in sorted(after)
                        if after[k] != before.get(k, 0)}
            resp = self._respond(req, key, res)
        # deadline-truncated answers are NOT memoized: a repeat must
        # re-run (replaying the journal prefix near-free) so repeated
        # deadline requests make monotone progress toward the
        # full-budget frontier instead of freezing at the first cut
        if not resp.deadline_hit:
            with self._lock:
                self._memo.put(key, resp)
                self._append_jsonl(self._memo_path(),
                                   {"key": key, "resp": resp.to_dict()})
        self._reg.counter("serve.served_from." + resp.served_from).inc()
        if t0 is not None:
            self._observe_request(time.perf_counter() - t0)
        return resp

    def _absorb(self, res: DSEResult) -> None:
        """Merge a distributed sweep's records into the service journal
        so later serial requests reuse them (records carry their
        content key; re-absorbing an existing key is skipped to keep
        the journal file from accreting duplicates). Runs under the
        service lock: the contains-then-record pair must be atomic
        against other workers absorbing overlapping result sets."""
        with self._lock:
            for rec in res.records:
                if rec["key"] not in self.journal:
                    self.journal.record(rec["key"], rec)
            self.journal.publish()

    def _best(self, req: MappingRequest, res: DSEResult) -> Optional[Dict]:
        """The winning record: lowest search-objective value, restricted
        to the area budget when one is given (None if nothing fits).
        The objective is recomputed from each record's latency/energy —
        never read from a stored ``objective_value`` — so records
        journaled under an older schema (or a different objective) rank
        correctly for THIS request's objective."""
        eligible = res.records
        if req.area_budget_mm2 is not None:
            eligible = [r for r in eligible
                        if r["area_mm2"] <= req.area_budget_mm2 + 1e-12]
        return min(eligible,
                   key=lambda r: combine_objective(
                       req.objective, r["total_ns"], r["energy_pj"],
                       req.blend_alpha),
                   default=None)

    def _respond(self, req: MappingRequest, key: str,
                 res: DSEResult) -> MappingResponse:
        best = self._best(req, res)
        mapping = None
        if req.include_mapping and best is not None:
            with self._lock:
                mapping = self._mappings.get(best["key"])
            if mapping is None:
                # materialization runs unlocked (it is a real mapping
                # search); a racing worker may do the same search, but
                # both produce the identical deterministic nest
                mapping = self._materialize_mapping(req, best)
                with self._lock:
                    self._mappings.put(best["key"], mapping)
                    self._append_jsonl(self._nests_path(),
                                       {"key": best["key"],
                                        "mapping": mapping})
        # the frontier is carried once, top-level; the summary keeps
        # every other sweep_summary column (the BENCH-compatible shape)
        summary = dict(sweep_summary(res))
        pts = summary.pop("frontier_points")
        return MappingResponse(
            request_key=key,
            status="ok" if best is not None else "infeasible",
            network=req.network, family=req.family,
            objective=req.objective,
            best=best, baseline=res.baseline,
            frontier_points=pts,
            frontier_json=res.frontier.canonical_json(),
            summary=summary,
            evaluated=int(res.stats["evaluated"]),
            from_journal=int(res.stats["from_journal"]),
            proposed=int(res.stats["proposed"]),
            deadline_hit=bool(res.stats.get("deadline_hit", False)),
            wall_s=float(res.stats["wall_s"]),
            served_from="journal" if res.stats["evaluated"] == 0
            else "search",
            mapping=mapping)

    def _materialize_mapping(self, req: MappingRequest,
                             best: Dict) -> List[Dict]:
        """Re-derive the winner's per-layer loop nests. Deterministic —
        the same search that scored the record — so the nests *are* the
        scored mapping; costs one extra mapping search on a cold
        request (the memo answers repeats). Runs on the shared engine:
        the sweep that just crowned this winner left its arch bundle
        and perf entries warm."""
        from ..core.engine import optimize_network_engine
        from ..core.interface import describe
        space = self._space(req.family)
        arch = space.build(space.point(**best["point"]))
        desc = describe(req.network)
        cfg = req.dse_config()
        with self._engine_lock:
            net = optimize_network_engine(desc.layers, desc.edges, arch,
                                          cfg.search_config(),
                                          engine=self._engine)
            self._engine.evict_lru(self.engine_bundle_cap)
        return [
            {"layer": getattr(lr.mapping.layer, "name", f"layer{i}"),
             "nest": lr.mapping.pretty(),
             "latency_ns": float(lr.latency_ns),
             "energy_pj": float(lr.energy_pj),
             "transformed": bool(lr.transformed),
             "moved_frac": float(lr.moved_frac)}
            for i, lr in enumerate(net.layers)]

    # -- persistence --------------------------------------------------------

    def _memo_path(self) -> Optional[str]:
        return None if self._persist_dir is None \
            else os.path.join(self._persist_dir, "memo.jsonl")

    def _nests_path(self) -> Optional[str]:
        return None if self._persist_dir is None \
            else os.path.join(self._persist_dir, "nests.jsonl")

    def _append_jsonl(self, path: Optional[str], entry: Dict) -> None:
        """Write-through one cache entry (no-op without persist_dir).
        Callers hold ``_lock``, so appends never interleave."""
        if path is None:
            return
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(entry, sort_keys=True,
                                separators=(",", ":")) + "\n")

    @staticmethod
    def _rewrite_jsonl(path: Optional[str], entries: List[Dict]) -> None:
        """Atomically replace a persist file with the live entries."""
        if path is None:
            return
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            for entry in entries:
                fh.write(json.dumps(entry, sort_keys=True,
                                    separators=(",", ":")) + "\n")
        os.replace(tmp, path)

    def _load_persisted(self) -> None:
        """Reload the memo and nest caches from ``persist_dir`` (append
        order = recency order, later lines win, so replaying into the
        LRU keeps exactly the ``cap`` most recent entries)."""
        if self._persist_dir is None:
            return
        os.makedirs(self._persist_dir, exist_ok=True)
        for path, lru, decode in (
                (self._memo_path(), self._memo,
                 lambda e: MappingResponse.from_dict(e["resp"])),
                (self._nests_path(), self._mappings,
                 lambda e: e["mapping"])):
            if not os.path.exists(path):
                continue
            with open(path, "r", encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        entry = json.loads(line)
                        lru.put(entry["key"], decode(entry))
                    except (ValueError, KeyError, TypeError):
                        # a torn tail (crash mid-append) or a
                        # stale-schema line loses one cache entry, not
                        # the server start; compact() rewrites it away
                        continue

    def _compact_loop(self) -> None:
        while not self._stop.wait(self.compact_every_s):
            self.compact()
