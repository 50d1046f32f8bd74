"""Distributed sweep worker: claim batches, evaluate, publish.

A worker is stateless with respect to the sweep: everything it needs is
in the shared directory. It polls ``batches/`` for manifests, skips any
whose keys are already all in the merged journal (marking them done so
nobody else bothers), claims the rest through the ``LeaseBoard`` —
stealing expired leases of crashed peers — evaluates each point with a
long-lived per-worker ``OverlapEngine`` (per-arch cache bundles evicted
after scoring, so memory stays bounded across an arbitrarily long
sweep), publishes the records as one atomic shard, and marks the batch
done. It exits when the coordinator posts ``STOP`` (or after
``max_idle_s`` without work, for fire-and-forget deployments).

Manifests carry *built* ``ArchSpec`` dicts, never ``ParamSpace``s — the
same rule as the PR-2 process pool: spaces can hold unpicklable
constraint lambdas, and rebuilding one worker-side could silently
diverge from the caller's. A worker therefore never needs the space at
all, which is what lets ``dse-worker`` processes on other machines join
a sweep knowing nothing but the shared directory.
"""
from __future__ import annotations

import dataclasses
import os
import time
import uuid
from typing import Dict, Optional

from ...core.arch import ArchSpec
from ...core.engine import OverlapEngine
from ...obs import Registry
from ..explore import DSEConfig, _make_record, _search_arch
from ..persist import RunJournal, SharedDirBackend
from ..space import DesignPoint
from .lease import LeaseBoard, ManifestCache, atomic_write_json, stop_token

METRICS_DIRNAME = "metrics"


def metrics_dir(root: str) -> str:
    """The shared-dir subdirectory holding per-worker metrics shards."""
    return os.path.join(root, METRICS_DIRNAME)


def write_metrics_shard(root: str, worker_id: str, stats: Dict,
                        registry: Registry) -> str:
    """Publish one worker's metrics shard (atomic rename) into
    ``<root>/metrics/<worker_id>.json``: the loop counters plus a full
    registry snapshot. The worker uses a *worker-local* registry — never
    the process-global one — so thread-mode fleets (coordinator workers
    in one process) cannot double-count when the coordinator merges the
    shards back into a fleet summary."""
    path = os.path.join(metrics_dir(root), f"{worker_id}.json")
    atomic_write_json(path, {"worker": worker_id, "stats": stats,
                             "snapshot": registry.snapshot()})
    return path


@dataclasses.dataclass
class WorkerConfig:
    root: str
    worker_id: Optional[str] = None
    poll_s: float = 0.05
    lease_ttl_s: float = 60.0
    # exit after this long with no claimable work even without STOP
    # (None = run until the coordinator says stop)
    max_idle_s: Optional[float] = None
    # optional semaphore bounding concurrently *active* local workers:
    # when a host runs more workers than cores, letting every process
    # compute at once just timeslices the same cores at a large
    # scheduling cost — and on sandboxed filesystems even the surplus
    # workers' polling competes with the productive ones' compute, so
    # the whole scan-claim-evaluate iteration is gated and the surplus
    # blocks on the semaphore (a kernel wait, not a poll). Acquisition
    # uses a timeout, so a crashed gate-holder degrades the fleet to
    # slow polling instead of deadlocking it, and STOP is still seen.
    compute_gate: Optional[object] = None

    def resolved_id(self) -> str:
        """The configured worker id, or a fresh pid-random one."""
        return self.worker_id or f"w{os.getpid()}-{uuid.uuid4().hex[:6]}"


def dcfg_from_manifest(man: Dict) -> DSEConfig:
    """The manifest's sweep config, sanitized for worker-side scoring:
    a distributed worker is itself the unit of parallelism (no nested
    process pool) and journals through the shared dir, not a file."""
    d = dict(man["dcfg"])
    d["workers"] = 0
    d["journal_path"] = None
    return DSEConfig(**d)


def evaluate_manifest_item(item: Dict, dcfg: DSEConfig,
                           engine: Optional[OverlapEngine]) -> Dict:
    """One full mapping search for one manifest item — bit-identical to
    the serial evaluator's record for the same content key."""
    arch = ArchSpec.from_dict(item["arch"])
    point = DesignPoint.make(item["family"], item["point"])
    fields = _search_arch(arch, dcfg, engine=engine)
    if engine is not None:
        # scored once per sweep: evict the bundle to bound worker memory
        engine.evict_arch(arch)
    return _make_record(point, dcfg, arch, fields)


def worker_loop(wcfg: WorkerConfig) -> Dict[str, int]:
    """Run until STOP (or ``max_idle_s``); returns counters for tests
    and the ``dse-worker`` CLI: batches completed, points evaluated,
    expired leases stolen, batches skipped because the merged journal
    already had every key."""
    wid = wcfg.resolved_id()
    backend = SharedDirBackend(wcfg.root, writer_id=wid)
    journal = RunJournal(backend=backend)
    board = LeaseBoard(wcfg.root, wid, ttl_s=wcfg.lease_ttl_s)
    manifest_cache = ManifestCache(wcfg.root)
    engine = OverlapEngine()
    # worker-LOCAL registry: fleet metrics flow only through the shard
    # this worker publishes at exit (see ``write_metrics_shard``)
    reg = Registry()
    stats = {"batches": 0, "evaluated": 0, "stolen": 0,
             "skipped_done": 0}
    idle_since = time.monotonic()
    sleep_s = wcfg.poll_s
    gate = wcfg.compute_gate
    # a STOP left behind by a previous sweep on a reused directory is
    # stale: only a *different* token (the coordinator clears STOP at
    # start and re-posts with a fresh one) means this sweep is over
    stale_stop = stop_token(wcfg.root)

    def stopped() -> bool:
        tok = stop_token(wcfg.root)
        return tok is not None and tok != stale_stop

    gate_failures = 0
    while True:
        acquired = True
        if gate is not None:
            acquired = gate.acquire(timeout=0.2)
            if not acquired:
                gate_failures += 1
                if stopped():
                    break
                if gate_failures < 50:
                    continue  # no slot: block again, touch no shared files
                # ~10s without a slot: every holder may have crashed
                # (a dead process never releases its semaphore slot).
                # Proceed ungated at this degraded cadence so expired
                # leases still get re-stolen — liveness beats the
                # oversubscription guard.
                gate_failures = 0
        try:
            progressed = _work_pass(wcfg, board, manifest_cache, journal,
                                    engine, stats, reg)
        finally:
            if gate is not None and acquired:
                gate.release()
        stats["stolen"] = board.n_stolen
        now = time.monotonic()
        if progressed:
            idle_since = now
            sleep_s = wcfg.poll_s
            continue
        if stopped():
            break
        if wcfg.max_idle_s is not None \
                and now - idle_since > wcfg.max_idle_s:
            break
        time.sleep(sleep_s)
        # idle backoff: a worker with nothing claimable must not flood
        # the shared filesystem while its peers compute
        sleep_s = min(sleep_s * 1.5, max(wcfg.poll_s, 0.25))
    stats["claims"] = board.n_claims
    stats["expired"] = board.n_expired
    for k in ("batches", "evaluated", "stolen", "skipped_done",
              "claims", "expired"):
        if stats[k]:
            reg.counter("fleet." + k).inc(stats[k])
    engine.publish_metrics(registry=reg)
    write_metrics_shard(wcfg.root, wid, stats, reg)
    return stats


def _work_pass(wcfg: WorkerConfig, board: LeaseBoard,
               manifest_cache: ManifestCache, journal: RunJournal,
               engine: OverlapEngine, stats: Dict[str, int],
               reg: Optional[Registry] = None) -> bool:
    """One scan over the published manifests; returns True if anything
    was completed (evaluated or dedup-marked done)."""
    progressed = False
    manifests = manifest_cache.scan()
    if manifests:
        # one merge per scan pass (shards are immutable, so this is
        # O(new shards)); per-item dedup below is then dict lookups
        journal.refresh()
    for man in manifests:
        bid = man["batch_id"]
        if board.is_done(bid):
            continue
        # dedup against the merged journal before doing any work:
        # a resumed or overlapping sweep must cost zero searches
        todo = [it for it in man["items"] if it["key"] not in journal]
        if not todo:
            board.mark_done(bid, {"n_evaluated": 0, "deduped": True})
            stats["skipped_done"] += 1
            progressed = True
            continue
        if not board.try_claim(bid):
            continue
        try:
            # claimed: re-merge once — a peer may have published
            # some of these keys between the scan and the claim
            journal.refresh()
            todo = [it for it in todo if it["key"] not in journal]
            if not todo:
                board.mark_done(bid, {"n_evaluated": 0, "deduped": True})
                stats["skipped_done"] += 1
                progressed = True
                continue
            dcfg = dcfg_from_manifest(man)
            stolen_midway = False
            n_done = 0
            t_batch = time.perf_counter()
            for it in todo:
                rec = evaluate_manifest_item(it, dcfg, engine)
                journal.record(it["key"], rec)
                stats["evaluated"] += 1
                n_done += 1
                # still alive on long batches; a False renewal means the
                # lease expired and a peer stole the batch — back off
                # and let the thief finish it (our records publish
                # anyway; the merge dedups)
                if not board.renew(bid):
                    stolen_midway = True
                    break
            if reg is not None and n_done:
                reg.histogram("fleet.batch_eval_seconds").observe(
                    time.perf_counter() - t_batch)
            journal.publish()          # one atomic shard per batch
            if not stolen_midway:
                board.mark_done(bid, {"n_evaluated": n_done})
                stats["batches"] += 1
        finally:
            board.release(bid)
        progressed = True
    return progressed


def worker_entry(root: str, lease_ttl_s: float = 60.0,
                 poll_s: float = 0.05,
                 max_idle_s: Optional[float] = None,
                 compute_gate: Optional[object] = None) -> Dict[str, int]:
    """Plain-args entry point (multiprocessing / CLI)."""
    return worker_loop(WorkerConfig(root=root, lease_ttl_s=lease_ttl_s,
                                    poll_s=poll_s, max_idle_s=max_idle_s,
                                    compute_gate=compute_gate))
