"""Staged job queue with request coalescing and admission control.

A ``Job`` is one unit of background work identified by a content key;
a ``JobQueue`` runs jobs through three dedicated stages joined by
bounded queues — the MLPerf offline-serving discipline, where one slow
stage backpressures its upstream instead of stalling the rest:

* **admit** — runs on the *caller's* thread inside ``submit``: coalesce
  onto an in-flight job for the same key, or append to the bounded
  pending queue. Once ``max_pending`` distinct jobs are waiting, admit
  refuses with ``QueueFull`` (the service maps this to an HTTP 429 and
  a ``serve.shed`` counter) — an explicit load-shed answer instead of
  an unbounded thread-pool backlog.
* **evaluate** — ``max_workers`` dedicated threads pop pending jobs and
  run their callables. Results go into a *bounded* respond queue, so a
  slow respond stage backpressures evaluation rather than piling up
  unfinished results.
* **respond** — one dedicated thread finishes each job (storing the
  result, waking waiters, firing done-callbacks) and only *then* drops
  it from the in-flight table, so a racing submit either coalesces onto
  a finished job (``result()`` returns immediately) or starts fresh.

Coalescing: while a job for key K is in flight (queued or running),
every further ``submit`` with key K attaches to the same ``Job`` object
instead of enqueueing duplicate work — N concurrent identical
deployment requests cost one sweep. Once a job finishes it leaves the
in-flight table; whether a *later* identical submission re-runs is the
caller's concern (the mapping service answers it from its response
memo and the run journal, so the re-run costs zero mapping searches).

Threads, not processes: a DSE sweep is numpy/pure-Python compute that
the service runs at most ``max_workers`` at a time, and results are
plain dicts shared by reference. For process-scale parallelism the
service dispatches through the distributed sweep subsystem instead
(``repro_torch.dse.distrib``).
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

#: job lifecycle states (``Job.status``)
PENDING, RUNNING, DONE, FAILED = "pending", "running", "done", "failed"

#: respond-queue sentinel that stops the responder thread
_STOP = object()


class QueueFull(RuntimeError):
    """Admission refused: the pending queue is at ``max_pending``.

    The load-shed signal of the serving stack — callers answer it
    immediately (HTTP transports as a 429) instead of queueing
    unboundedly. Coalescing submissions are never shed: attaching to an
    in-flight job costs no queue slot."""


class QueueShutdown(RuntimeError):
    """The queue no longer accepts work (``shutdown`` was called)."""


class Job:
    """Handle on one submitted unit of work.

    ``result(timeout)`` blocks until completion and returns the value
    (re-raising the job's exception if it failed); ``done()`` polls.
    ``n_attached`` counts how many submissions this job absorbed — 1
    for a lone request, more when concurrent identical requests were
    coalesced onto it. ``add_done_callback`` registers a callable fired
    exactly once with the job after it finishes (immediately if it
    already has) — the service records per-submission latency through
    it, so coalesced waiters are not invisible to the histograms.

    Stage timestamps (``time.perf_counter`` values, set by the queue's
    stage threads; ``None`` until the stage is reached) let the flight
    recorder attribute a request's wall clock to its pipeline stages:
    ``t_submit`` (admitted to the pending queue), ``t_eval_start`` /
    ``t_eval_end`` (the evaluate stage ran the callable), ``t_finish``
    (the respond stage made the result readable). They are telemetry —
    nothing in the queue branches on them."""

    def __init__(self, key: str):
        self.key = key
        self.status = PENDING
        self.n_attached = 1
        self.t_submit: Optional[float] = None
        self.t_eval_start: Optional[float] = None
        self.t_eval_end: Optional[float] = None
        self.t_finish: Optional[float] = None
        self._event = threading.Event()
        self._result: Any = None
        self._exc: Optional[BaseException] = None
        self._cb_lock = threading.Lock()
        self._cbs: List[Callable[["Job"], None]] = []

    @classmethod
    def completed(cls, key: str, result: Any) -> "Job":
        """A pre-finished job (memo hits: the answer already exists)."""
        job = cls(key)
        job._finish(result=result)
        return job

    def done(self) -> bool:
        """True once the job has finished (successfully or not)."""
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block until the job finishes; return its value or re-raise
        its exception. Raises ``TimeoutError`` on expiry."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"job {self.key} not done in {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result

    def add_done_callback(self, cb: Callable[["Job"], None]) -> None:
        """Run ``cb(job)`` once the job finishes — immediately when it
        already has. Callbacks fire on the respond thread (or the
        registering thread for already-finished jobs) and must not
        block."""
        with self._cb_lock:
            if not self._event.is_set():
                self._cbs.append(cb)
                return
        cb(self)

    def _finish(self, result: Any = None,
                exc: Optional[BaseException] = None) -> None:
        if self.t_finish is None:
            self.t_finish = time.perf_counter()
        self._result = result
        self._exc = exc
        self.status = FAILED if exc is not None else DONE
        self._event.set()
        with self._cb_lock:
            cbs, self._cbs = self._cbs, []
        for cb in cbs:
            cb(self)


class JobQueue:
    """Keyed staged executor: bounded admit -> evaluate -> respond."""

    def __init__(self, max_workers: int = 1,
                 max_pending: Optional[int] = None,
                 depth_gauge=None):
        self._lock = threading.Lock()
        self._have_work = threading.Condition(self._lock)
        self._pending: Deque[Tuple[Job, Callable[[], Any]]] = deque()
        self._inflight: Dict[str, Job] = {}
        self._closed = False
        self.max_pending = max_pending
        self.n_submitted = 0
        self.n_coalesced = 0
        self.n_shed = 0
        # optional ``repro_torch.obs`` Gauge tracking the in-flight depth
        # (set under the queue lock on every enqueue/finish)
        self._depth_gauge = depth_gauge
        # evaluate -> respond: bounded so a stalled responder
        # backpressures the evaluate stage instead of hoarding results
        self._respond_q: "queue.Queue" = queue.Queue(
            maxsize=max(2, 2 * max_workers))
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"mapping-job-{i}")
            for i in range(max(1, max_workers))]
        self._responder = threading.Thread(
            target=self._respond_loop, daemon=True, name="mapping-respond")
        for t in self._workers:
            t.start()
        self._responder.start()

    def submit(self, key: str, fn: Callable[[], Any]) -> "tuple[Job, bool]":
        """Enqueue ``fn`` under ``key``; returns ``(job, coalesced)``.
        An in-flight job with the same key is returned (``coalesced``
        True) instead of enqueueing a duplicate — ``fn`` is then never
        called, and coalescing is exempt from admission control. A
        fresh key is refused with ``QueueFull`` once ``max_pending``
        jobs are already waiting, and with ``QueueShutdown`` after
        ``shutdown`` — the flag/exception is this call's own outcome,
        so callers never have to read the shared counters racily."""
        with self._lock:
            self.n_submitted += 1
            job = self._inflight.get(key)
            if job is not None:
                job.n_attached += 1
                self.n_coalesced += 1
                return job, True
            if self._closed:
                raise QueueShutdown("submit after shutdown")
            if (self.max_pending is not None
                    and len(self._pending) >= self.max_pending):
                self.n_shed += 1
                raise QueueFull(
                    f"{len(self._pending)} jobs pending >= "
                    f"max_pending={self.max_pending}")
            job = Job(key)
            job.t_submit = time.perf_counter()
            self._inflight[key] = job
            self._pending.append((job, fn))
            self._set_depth_locked()
            self._have_work.notify()
        return job, False

    def inflight(self) -> int:
        """How many distinct keys are currently queued or running."""
        with self._lock:
            return len(self._inflight)

    def pending(self) -> int:
        """How many admitted jobs are waiting for an evaluate thread
        (the quantity ``max_pending`` bounds)."""
        with self._lock:
            return len(self._pending)

    def shutdown(self, wait: bool = True) -> None:
        """Stop accepting work. ``wait=True`` drains every admitted job
        (pending and running) and joins the stage threads; ``wait=False``
        fails still-pending jobs with ``QueueShutdown`` — the
        ``_finish(exc=...)`` path, so their waiters unblock instead of
        hanging — and leaves running jobs to finish on the daemon
        threads."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            cancelled = []
            if not wait:
                cancelled = list(self._pending)
                self._pending.clear()
            self._have_work.notify_all()
        for job, _fn in cancelled:
            job._finish(exc=QueueShutdown(
                "job queue shut down before the job ran"))
            with self._lock:
                self._inflight.pop(job.key, None)
                self._set_depth_locked()
        if wait:
            for t in self._workers:
                t.join()
            self._respond_q.put(_STOP)
            self._responder.join()

    # -- stage threads ------------------------------------------------------

    def _set_depth_locked(self) -> None:
        if self._depth_gauge is not None:
            self._depth_gauge.set(len(self._inflight))

    def _worker_loop(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._have_work.wait()
                if not self._pending:   # closed and drained
                    return
                job, fn = self._pending.popleft()
                job.status = RUNNING
            job.t_eval_start = time.perf_counter()
            try:
                result, exc = fn(), None
            except BaseException as e:  # surfaced via Job.result
                result, exc = None, e
            job.t_eval_end = time.perf_counter()
            # bounded: blocks (backpressure) when the responder lags
            self._respond_q.put((job, result, exc))

    def _respond_loop(self) -> None:
        while True:
            item = self._respond_q.get()
            if item is _STOP:
                return
            job, result, exc = item
            job._finish(result=result, exc=exc)
            # drop from the table only after the result is readable, so
            # a racing submit either coalesces onto a finished job
            # (result() returns immediately) or starts a fresh one
            with self._lock:
                self._inflight.pop(job.key, None)
                self._set_depth_locked()
