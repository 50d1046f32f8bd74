"""Work-stealing coordinator: distribute one sweep over many workers.

The coordinator owns exactly what the serial ``run_dse`` owns — the
seed-deterministic proposal stream — and *only* that. For every
generation the stream proposes, it

1. content-keys each point (``key_for`` over the built arch),
2. refreshes the merged shared-dir journal and drops every key already
   present (resumed and overlapping sweeps dispatch zero redundant
   mapping searches),
3. partitions the misses, in proposal order, into content-keyed batches
   (``batch_id`` = SHA-1 over the member keys, so a re-posted batch in a
   crashed-and-restarted sweep collides with its previous done marker
   instead of duplicating work) and publishes their manifests,
4. waits until the merged journal holds every key of the generation —
   workers claim batches under expiring leases, so a crashed worker's
   batch is re-stolen by a peer rather than wedging the sweep — then
5. feeds the generation's records, in proposal order, back into the
   stream and repeats.

Because the stream advances only on merged-journal records and every
evaluation is deterministic and content-keyed, N workers produce the
same record sequence — and therefore the byte-identical Pareto
frontier — as one worker or the serial path (differentially tested in
``tests/test_dse_distrib.py``; DESIGN.md Section 10).

Worker placement is orthogonal: ``worker_mode="process"`` forks local
worker processes (the ``--distributed N`` CLI), ``"thread"`` runs them
in-process (tests, and sweeps whose cost is outside the GIL),
``"external"`` spawns none and waits for ``dse-worker`` processes —
possibly on other machines sharing the directory — to show up.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Dict, List, Optional, Sequence

from ... import obs
from ...obs import merge_snapshots, quantile
from ..explore import (DSEConfig, DSEResult, ProposalStream, key_for,
                       proposal_stream)
from ..pareto import ParetoFrontier
from ..persist import RunJournal, SharedDirBackend
from ..space import ParamSpace, get_space
from .lease import clear_stop, post_manifest, read_json, request_stop
from .worker import WorkerConfig, metrics_dir, worker_entry, worker_loop

WORKER_MODES = ("process", "thread", "external")


def clear_metrics(root: str) -> None:
    """Drop metrics shards a previous sweep left in a reused shared dir
    (coordinator start-up — mirrors ``clear_stop``), so the end-of-sweep
    fleet summary covers exactly this sweep's workers."""
    mdir = metrics_dir(root)
    try:
        names = os.listdir(mdir)
    except FileNotFoundError:
        return
    for n in names:
        if n.endswith(".json"):
            try:
                os.remove(os.path.join(mdir, n))
            except FileNotFoundError:
                pass


def collect_fleet(root: str) -> Optional[Dict]:
    """Merge every worker's metrics shard under ``<root>/metrics/`` into
    the coordinator's fleet-health view.

    Returns ``{"summary": ..., "snapshot": ...}`` — the summary sums the
    workers' loop counters (batches, evaluated, lease claims/steals/
    expiries, dedup skips) and adds batch-evaluate latency percentiles;
    the snapshot is the element-wise metrics merge, ready for
    ``obs.render_report``. None when no worker published a shard."""
    mdir = metrics_dir(root)
    try:
        names = sorted(os.listdir(mdir))
    except FileNotFoundError:
        return None
    shards = []
    for n in names:
        if n.endswith(".json"):
            body = read_json(os.path.join(mdir, n))
            if body is not None:
                shards.append(body)
    if not shards:
        return None
    snap = merge_snapshots([s.get("snapshot") or {} for s in shards])
    totals: Dict[str, float] = {}
    for s in shards:
        for k, v in (s.get("stats") or {}).items():
            totals[k] = totals.get(k, 0) + v
    summary: Dict = {"workers_reported": len(shards)}
    summary.update({k: int(v) for k, v in sorted(totals.items())})
    h = (snap.get("histograms") or {}).get("fleet.batch_eval_seconds")
    if h and h.get("count"):
        summary["batch_eval_p50_s"] = quantile(h["bounds"], h["counts"],
                                               0.50)
        summary["batch_eval_p99_s"] = quantile(h["bounds"], h["counts"],
                                               0.99)
        summary["batch_eval_mean_s"] = h["sum"] / h["count"]
    snap["gauges"]["fleet.workers"] = float(len(shards))
    return {"summary": summary, "snapshot": snap}


@dataclasses.dataclass
class DistribConfig:
    """How one sweep is spread over workers (the *what* lives in
    ``DSEConfig``). ``batch_size`` trades scheduling granularity against
    lease traffic; 1 maximizes load balance on small sweeps."""

    root: str
    n_workers: int = 2
    batch_size: int = 1
    lease_ttl_s: float = 60.0
    poll_s: float = 0.02
    timeout_s: float = 3600.0
    worker_mode: str = "process"
    # cap on concurrently *active* local workers; the default (0)
    # resolves to cpu_count. Oversubscribed hosts (n_workers > cores)
    # timeslice the same cores at a large scheduling cost — and surplus
    # workers' polling traffic competes with productive compute — so
    # surplus workers block on a shared semaphore until a slot frees
    # (with an acquire timeout: a crashed holder degrades the fleet to
    # slow polling, never deadlock). None disables the gate. External
    # workers (other machines) are never gated — they have their own
    # CPUs.
    compute_slots: Optional[int] = 0

    def __post_init__(self):
        assert self.worker_mode in WORKER_MODES, self.worker_mode
        assert self.batch_size >= 1, "batch_size must be >= 1"
        assert self.n_workers >= 0, "n_workers must be >= 0"

    def resolved_slots(self) -> Optional[int]:
        """Effective compute-gate width (None = gate can never bind)."""
        slots = self.compute_slots
        if slots == 0:
            slots = os.cpu_count() or 1
        if slots is not None and slots >= self.n_workers:
            return None   # gate can never bind: skip the semaphore
        return slots


def batch_id_for(keys: Sequence[str]) -> str:
    """Content key of a work batch: the SHA-1 of its member keys."""
    return hashlib.sha1(",".join(keys).encode()).hexdigest()[:20]


def _spawn_workers(dist: DistribConfig) -> List:
    """Start the requested local workers; external mode starts none."""
    handles: List = []
    if dist.worker_mode == "external" or dist.n_workers == 0:
        return handles
    slots = dist.resolved_slots()
    if dist.worker_mode == "thread":
        import threading
        gate = None if slots is None else threading.Semaphore(slots)
        for i in range(dist.n_workers):
            t = threading.Thread(
                target=worker_loop,
                args=(WorkerConfig(root=dist.root, worker_id=f"thread-{i}",
                                   poll_s=dist.poll_s,
                                   lease_ttl_s=dist.lease_ttl_s,
                                   compute_gate=gate),),
                daemon=True)
            t.start()
            handles.append(t)
        return handles
    import multiprocessing
    try:                       # fork shares the warmed interpreter
        ctx = multiprocessing.get_context("fork")
    except ValueError:         # pragma: no cover - non-POSIX fallback
        ctx = multiprocessing.get_context("spawn")
    gate = None if slots is None else ctx.Semaphore(slots)
    for _ in range(dist.n_workers):
        p = ctx.Process(target=worker_entry,
                        args=(dist.root, dist.lease_ttl_s, dist.poll_s,
                              None, gate),
                        daemon=True)
        p.start()
        handles.append(p)
    return handles


def _workers_alive(handles: List) -> int:
    return sum(1 for h in handles if h.is_alive())


def _join_workers(handles: List, timeout_s: float = 30.0) -> None:
    deadline = time.monotonic() + timeout_s
    for h in handles:
        h.join(timeout=max(0.0, deadline - time.monotonic()))
    for h in handles:
        if h.is_alive() and hasattr(h, "terminate"):
            h.terminate()


def _wait_for_keys(journal: RunJournal, keys: Sequence[str],
                   dist: DistribConfig, handles: List) -> None:
    """Block until the merged journal holds every key of the generation.

    Progress is the workers' job (including re-stealing expired leases);
    the coordinator only detects the two unrecoverable states: every
    local worker died, or the timeout lapsed."""
    deadline = time.monotonic() + dist.timeout_s
    while True:
        journal.refresh()
        missing = [k for k in keys if k not in journal]
        if not missing:
            return
        if handles and dist.worker_mode != "external" \
                and _workers_alive(handles) == 0:
            raise RuntimeError(
                f"all {len(handles)} workers exited with "
                f"{len(missing)} evaluations outstanding")
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"distributed sweep timed out ({dist.timeout_s:.0f}s) "
                f"with {len(missing)} evaluations outstanding; "
                f"first missing key: {missing[0]}")
        time.sleep(dist.poll_s)


def run_distributed(dcfg: DSEConfig, dist: DistribConfig,
                    space: Optional[ParamSpace] = None) -> DSEResult:
    """Run one sweep over the shared directory; same result contract as
    ``run_dse`` (records in proposal order, baseline first)."""
    space = space or get_space(dcfg.family)
    os.makedirs(dist.root, exist_ok=True)
    clear_stop(dist.root)      # a finished sweep leaves STOP behind
    clear_metrics(dist.root)   # ... and its workers' metrics shards
    backend = SharedDirBackend(dist.root, writer_id="coordinator")
    journal = RunJournal(backend=backend)
    stream: ProposalStream = proposal_stream(space, dcfg)
    frontier = ParetoFrontier()
    records: List[Dict] = []
    n_dispatched = 0
    n_from_journal = 0
    n_batches = 0
    t0 = time.perf_counter()
    handles = _spawn_workers(dist)
    try:
        while True:
            batch = stream.next_batch()
            if batch is None:
                break
            built = [space.build(p) for p in batch]
            keys = [key_for(dcfg, a.to_key()) for a in built]
            journal.refresh()
            miss = [i for i, k in enumerate(keys) if k not in journal]
            n_from_journal += len(batch) - len(miss)
            n_dispatched += len(miss)
            for lo in range(0, len(miss), dist.batch_size):
                chunk = miss[lo:lo + dist.batch_size]
                bkeys = [keys[i] for i in chunk]
                post_manifest(dist.root, {
                    "batch_id": batch_id_for(bkeys),
                    "dcfg": dataclasses.asdict(dcfg),
                    "items": [{"key": keys[i],
                               "family": batch[i].family,
                               "point": batch[i].as_dict(),
                               "arch": built[i].to_dict()}
                              for i in chunk],
                })
                n_batches += 1
            _wait_for_keys(journal, keys, dist, handles)
            recs = [journal.get(k) for k in keys]
            for p, rec in zip(batch, recs):
                records.append(rec)
                frontier.add_record(p.key(), rec)
            stream.observe(batch, recs)
    finally:
        request_stop(dist.root)
        _join_workers(handles)
    stats = {
        "proposed": len(records),
        "evaluated": n_dispatched,
        "from_journal": n_from_journal,
        "frontier": len(frontier),
        "wall_s": time.perf_counter() - t0,
        "workers": dist.n_workers,
        "batches": n_batches,
    }
    # fold the workers' metrics shards into the end-of-sweep summary
    # (previously the workers computed these counters and dropped them)
    fleet = collect_fleet(dist.root)
    if fleet is not None:
        stats["fleet"] = fleet["summary"]
        reg = obs.registry()
        if reg is not None:
            reg.merge_snapshot(fleet["snapshot"])
    return DSEResult(config=dcfg, records=records, frontier=frontier,
                     baseline=records[0], stats=stats)


def run_coordinator(dcfg: DSEConfig, dist: DistribConfig,
                    space: Optional[ParamSpace] = None) -> DSEResult:
    """``dse-coordinator`` entry: drive the sweep, spawn no workers —
    external ``dse-worker`` processes (any machine sharing the
    directory) supply the compute."""
    dist = dataclasses.replace(dist, worker_mode="external", n_workers=0)
    return run_distributed(dcfg, dist, space=space)
