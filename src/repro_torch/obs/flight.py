"""Request flight recorder: a bounded ring of per-request records.

Aggregate counters say *that* serving latency moved; the flight
recorder says *where a given request's milliseconds went*. Every
request through ``MappingService`` leaves one compact record — stage
timings (admit-wait / evaluate / respond, threaded through the staged
``JobQueue``), ``served_from`` provenance, work counters, outcome —
in a fixed-capacity ring buffer (``collections.deque``), so memory is
bounded no matter how long the server runs.

Slow-request retention: records whose ``total_s`` meets
``slow_threshold_s`` keep their **full detail** (the request dict, the
engine cache-hit stats delta of the sweep, the sweep summary) in a
second, separate ring — the interesting requests survive long after
ordinary traffic has rotated them out of the main ring. Both surfaces
are read-only snapshots: ``GET /v1/debug/requests`` lists the recent
ring, ``GET /v1/debug/requests/<key>`` returns the fullest record held
for one request key (prefix match, newest first).

Determinism contract (DESIGN.md Section 12): the recorder *observes* —
nothing reads it on the request path, so enabling/disabling it changes
no produced number (pinned by the serve determinism tests). A
``FlightRecorder(cap=0)`` is a shared no-op.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

#: record fields every entry carries (detail fields ride on top)
CORE_FIELDS = ("key", "seq", "t_wall", "network", "family", "objective",
               "served_from", "outcome", "status", "admit_wait_s",
               "evaluate_s", "respond_s", "total_s", "evaluated",
               "from_journal", "proposed", "deadline_hit", "slow")


class FlightRecorder:
    """Bounded ring of per-request records with slow-request retention.

    ``cap`` bounds the main ring (0 disables recording entirely);
    ``slow_cap`` bounds the separate full-detail ring;
    ``slow_threshold_s`` is the total-latency bar for full-detail
    retention (``None`` = never). All methods are thread-safe; records
    are plain JSON-safe dicts."""

    def __init__(self, cap: int = 256, slow_threshold_s: float = 1.0,
                 slow_cap: int = 32):
        self.cap = max(0, int(cap))
        self.slow_threshold_s = slow_threshold_s
        self._ring: "deque[Dict]" = deque(maxlen=max(1, self.cap))
        self._slow: "deque[Dict]" = deque(maxlen=max(1, int(slow_cap)))
        self._lock = threading.Lock()
        self._seq = 0

    @property
    def enabled(self) -> bool:
        """False for a ``cap=0`` recorder (every call is a no-op)."""
        return self.cap > 0

    def record(self, rec: Dict, detail: Optional[Dict] = None) -> None:
        """Append one request record. ``rec`` is the compact record
        (stage timings, provenance, counters); ``detail`` holds the
        expensive extras kept only for slow requests. A record at or
        above ``slow_threshold_s`` total latency is flagged ``slow``
        and retained with full detail in the slow ring."""
        if not self.cap:
            return
        slow = (self.slow_threshold_s is not None
                and rec.get("total_s", 0.0) >= self.slow_threshold_s)
        with self._lock:
            self._seq += 1
            entry = dict(rec)
            entry.setdefault("t_wall", time.time())
            entry["seq"] = self._seq
            entry["slow"] = bool(slow)
            self._ring.append(entry)
            if slow:
                full = dict(entry)
                if detail:
                    full.update(detail)
                self._slow.append(full)

    def snapshot(self, limit: Optional[int] = None,
                 slow_only: bool = False) -> List[Dict]:
        """Recent records, newest first (``limit`` caps the list).
        ``slow_only`` reads the full-detail slow ring instead."""
        with self._lock:
            src = self._slow if slow_only else self._ring
            out = [dict(r) for r in reversed(src)]
        return out[:limit] if limit is not None else out

    def get(self, key_prefix: str) -> Optional[Dict]:
        """The fullest record held for a request key (prefix match,
        newest first): the slow ring's full-detail entry when one
        exists, else the compact ring entry; None when unknown."""
        if not key_prefix:
            return None
        with self._lock:
            for src in (self._slow, self._ring):
                for rec in reversed(src):
                    if str(rec.get("key", "")).startswith(key_prefix):
                        return dict(rec)
        return None

    def __len__(self) -> int:
        return len(self._ring)


#: a shared disabled recorder for "no flight recorder" call sites
NULL_RECORDER = FlightRecorder(cap=0)
