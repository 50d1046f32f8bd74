"""Sliding time-window metrics: recent quantiles and SLO burn rate.

The all-time histograms (``repro_torch.obs.metrics``) answer "how has this
process behaved since boot"; a latency regression investigation needs
"how is it behaving *now*". ``WindowHistogram`` keeps a **bucket
ring**: the window of the last ``window_s`` seconds is divided into
``n_slots`` time slots, each holding one fixed-bounds bucket-count
array (the same log-spaced bounds as ``Histogram``, so quantile math
is shared). An observation lands in the slot owning the current time;
slots older than the window are lazily zeroed on the next touch, so
the whole structure is O(slots x buckets) memory and O(1) per
observation — no per-sample storage, no background thread.

``quantile``/``count``/``mean`` merge the live slots on demand, which
makes the published ``serve.request_seconds.window.p50``/``p99``
gauges *recent* percentiles (the last ``window_s`` seconds of
traffic), published next to the all-time histogram by
``MappingService.metrics_snapshot`` — computed at scrape time, never
in the request path.

``SLOTracker`` layers a latency SLO on top: a target latency plus a
goal fraction (e.g. 99% of requests under 2 s). Per observation it
counts ok/breach (all-time counters); ``burn_rate()`` is the windowed
breach fraction divided by the error budget ``1 - goal`` — the
standard SRE multiplier where 1.0 means "consuming budget exactly as
fast as allowed", >1 means the SLO will be violated if the window's
behavior persists.

Determinism contract (DESIGN.md Section 12): windows *observe* — no
code path branches on a windowed value, so enabling them changes no
produced number.
"""
from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .metrics import DEFAULT_BOUNDS, quantile


class WindowHistogram:
    """Fixed-bucket histogram over a sliding time window (bucket ring).

    ``window_s`` seconds divided into ``n_slots`` slots; each slot
    holds a counts array over ``bounds`` plus its observation count and
    value sum. A slot is reused once its absolute index falls out of
    the window (lazily cleared on write/read), so stale traffic ages
    out within one slot width (``window_s / n_slots`` seconds)."""

    def __init__(self, window_s: float = 60.0, n_slots: int = 12,
                 bounds: Optional[Sequence[float]] = None,
                 clock=time.monotonic):
        assert window_s > 0 and n_slots > 0
        self.window_s = float(window_s)
        self.n_slots = int(n_slots)
        self.slot_s = self.window_s / self.n_slots
        self.bounds: Tuple[float, ...] = \
            tuple(bounds) if bounds is not None else DEFAULT_BOUNDS
        self._clock = clock
        self._lock = threading.Lock()
        n = len(self.bounds) + 1
        self._counts = [[0] * n for _ in range(self.n_slots)]
        self._slot_count = [0] * self.n_slots
        self._slot_sum = [0.0] * self.n_slots
        # absolute slot index each ring position last held (-1 = never)
        self._epoch = [-1] * self.n_slots

    def _slot(self, now: float) -> int:
        """Ring position for ``now``, cleared if it held an old slot.
        Caller holds the lock."""
        idx = int(now // self.slot_s)
        s = idx % self.n_slots
        if self._epoch[s] != idx:
            self._counts[s] = [0] * (len(self.bounds) + 1)
            self._slot_count[s] = 0
            self._slot_sum[s] = 0.0
            self._epoch[s] = idx
        return s

    def observe(self, v: float) -> None:
        """Record one observation at the current time (thread-safe)."""
        now = self._clock()
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            s = self._slot(now)
            self._counts[s][i] += 1
            self._slot_count[s] += 1
            self._slot_sum[s] += v

    def _merged(self) -> Tuple[List[int], int, float]:
        """(counts, count, sum) over the slots still inside the window.
        Caller holds the lock."""
        now = self._clock()
        idx = int(now // self.slot_s)
        live = range(idx - self.n_slots + 1, idx + 1)
        counts = [0] * (len(self.bounds) + 1)
        total, vsum = 0, 0.0
        for s in range(self.n_slots):
            if self._epoch[s] in live and self._slot_count[s]:
                for i, c in enumerate(self._counts[s]):
                    counts[i] += c
                total += self._slot_count[s]
                vsum += self._slot_sum[s]
        return counts, total, vsum

    def snapshot(self) -> Dict:
        """JSON-safe merged view of the live window: ``count``,
        ``sum``, and the merged bucket ``counts`` (same shape as an
        all-time histogram snapshot, plus ``window_s``)."""
        with self._lock:
            counts, total, vsum = self._merged()
        return {"window_s": self.window_s, "bounds": list(self.bounds),
                "counts": counts, "count": total, "sum": vsum}

    def quantile(self, q: float) -> float:
        """Approximate ``q``-quantile over the live window (0.0 when
        the window is empty)."""
        with self._lock:
            counts, _total, _vsum = self._merged()
        return quantile(self.bounds, counts, q)

    def count(self) -> int:
        """Observations inside the live window."""
        with self._lock:
            return self._merged()[1]

    def mean(self) -> float:
        """Mean over the live window (0.0 when empty)."""
        with self._lock:
            _counts, total, vsum = self._merged()
        return vsum / total if total else 0.0


class SLOTracker:
    """Latency SLO accounting: target seconds + goal fraction.

    ``observe(v)`` classifies one request (ok when ``v <= target_s``)
    into all-time counters and a windowed breach ring.
    ``burn_rate()`` = windowed breach fraction / ``(1 - goal)`` — the
    error-budget burn multiplier over the last ``window_s`` seconds
    (0.0 while the window is empty)."""

    def __init__(self, target_s: float, goal: float = 0.99,
                 window_s: float = 60.0, n_slots: int = 12,
                 clock=time.monotonic):
        assert target_s > 0
        assert 0.0 < goal < 1.0, "goal is a fraction like 0.99"
        self.target_s = float(target_s)
        self.goal = float(goal)
        # two-bucket ring: bound at target_s splits ok from breach
        self._ring = WindowHistogram(window_s=window_s, n_slots=n_slots,
                                     bounds=(target_s,), clock=clock)
        self.n_ok = 0
        self.n_breach = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        """Classify one request latency (thread-safe)."""
        self._ring.observe(v)
        with self._lock:
            if v <= self.target_s:
                self.n_ok += 1
            else:
                self.n_breach += 1

    def window_breach_rate(self) -> float:
        """Breach fraction over the live window (0.0 when empty)."""
        snap = self._ring.snapshot()
        if not snap["count"]:
            return 0.0
        return snap["counts"][1] / snap["count"]

    def burn_rate(self) -> float:
        """Windowed breach rate over the error budget ``1 - goal``."""
        return self.window_breach_rate() / (1.0 - self.goal)

    def snapshot(self) -> Dict:
        """JSON-safe state: target/goal, all-time ok/breach counts,
        and the windowed breach/burn rates."""
        with self._lock:
            ok, breach = self.n_ok, self.n_breach
        return {"target_s": self.target_s, "goal": self.goal,
                "ok": ok, "breach": breach,
                "window_breach_rate": self.window_breach_rate(),
                "burn_rate": self.burn_rate()}
