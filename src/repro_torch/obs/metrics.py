"""Mergeable metrics: counters, gauges, fixed-bucket histograms.

A ``Registry`` is a named, get-or-create store of the three metric
kinds. Everything here is stdlib-only and cheap enough to stay on in
production paths:

* ``Counter`` / ``Gauge`` — one float cell behind a tiny lock.
* ``Histogram`` — fixed, immutable bucket bounds chosen at creation
  (default: log-spaced seconds from 1 µs to ~100 s, ~1.47x resolution),
  so two histograms of the same metric are *mergeable* by element-wise
  addition. Percentiles (``quantile``) interpolate within the bucket.
* ``Registry.snapshot()`` — a plain JSON-safe dict; ``merge_snapshot``
  folds another process's snapshot in (counters add, gauges take the
  max, histogram counts add). This is how the distributed fleet's
  per-worker metric shards become one fleet-health view
  (``repro_torch.dse.distrib``).
* ``render_prometheus`` — the standard text exposition
  (``repro_<name>_total`` counters, ``_bucket{le=...}`` histograms),
  so any scraper can consume a snapshot without bespoke glue.

Metric names are dotted lowercase ``subsystem.object.event`` (e.g.
``engine.tiles.hit``, ``serve.request_seconds``); the Prometheus
renderer maps dots to underscores. Determinism contract: metrics only
*observe* — no code path may branch on a metric value, so enabling or
disabling collection can never change a produced number (DESIGN.md
Section 12).
"""
from __future__ import annotations

import bisect
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: default histogram bounds (seconds): log-spaced, 6 buckets per decade
#: from 1 µs to ~100 s — fine enough for p50/p99 reporting (~1.47x
#: bucket resolution) while staying mergeable across processes
DEFAULT_BOUNDS: Tuple[float, ...] = tuple(
    round(10.0 ** (e / 6.0), 12) for e in range(-36, 13))


class Counter:
    """Monotonically increasing count (float-valued for summed times)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (thread-safe)."""
        with self._lock:
            self.value += n


class Gauge:
    """Last-written instantaneous value (queue depth, bundle count)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        """Overwrite the current value (thread-safe)."""
        with self._lock:
            self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with an overflow bucket.

    Bucket ``i`` counts observations in ``(bounds[i-1], bounds[i]]``
    (the first bucket is ``(-inf, bounds[0]]``); one trailing bucket
    counts everything above ``bounds[-1]``. Bounds are immutable after
    construction, which is what makes histograms of the same metric
    mergeable across processes by adding counts element-wise."""

    __slots__ = ("name", "bounds", "counts", "total", "sum", "_lock")

    def __init__(self, name: str,
                 bounds: Optional[Sequence[float]] = None):
        self.name = name
        self.bounds = tuple(bounds) if bounds is not None else DEFAULT_BOUNDS
        assert list(self.bounds) == sorted(self.bounds), \
            "histogram bounds must be ascending"
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        """Record one observation (thread-safe)."""
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.total += 1
            self.sum += v

    def quantile(self, q: float) -> float:
        """Approximate ``q``-quantile (linear interpolation within the
        bucket; 0.0 when empty; the last bound for overflow mass)."""
        return quantile(self.bounds, self.counts, q)


def quantile(bounds: Sequence[float], counts: Sequence[int],
             q: float) -> float:
    """``q``-quantile of a fixed-bucket histogram's counts.

    Linear interpolation inside the containing bucket (lower edge 0.0
    for the first bucket); the top bound for mass in the overflow
    bucket; 0.0 for an empty histogram."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target and c > 0:
            if i >= len(bounds):        # overflow bucket: no upper edge
                return float(bounds[-1])
            lo = float(bounds[i - 1]) if i > 0 else 0.0
            hi = float(bounds[i])
            frac = (target - (cum - c)) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
    return float(bounds[-1]) if bounds else 0.0


class Registry:
    """Named get-or-create store of counters, gauges and histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        """The counter named ``name`` (created on first use)."""
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        """The gauge named ``name`` (created on first use)."""
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        """The histogram named ``name`` (created on first use with the
        given bounds; later calls must not pass different bounds)."""
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, Histogram(name, bounds))
        if bounds is not None and tuple(bounds) != h.bounds:
            raise ValueError(f"histogram {name!r} already exists with "
                             "different bounds")
        return h

    def snapshot(self) -> Dict:
        """JSON-safe dict of every metric's current state."""
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            hists = {n: {"bounds": list(h.bounds),
                         "counts": list(h.counts),
                         "count": h.total, "sum": h.sum}
                     for n, h in self._hists.items()}
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    def merge_snapshot(self, snap: Dict) -> None:
        """Fold another registry's ``snapshot()`` into this one:
        counters add, gauges keep the max, histogram counts add
        (bounds must match — they do for same-named metrics created
        through this module's defaults)."""
        for n, v in (snap.get("counters") or {}).items():
            self.counter(n).inc(v)
        for n, v in (snap.get("gauges") or {}).items():
            g = self.gauge(n)
            g.set(max(g.value, v))
        for n, h in (snap.get("histograms") or {}).items():
            mine = self.histogram(n, h.get("bounds"))
            with mine._lock:
                for i, c in enumerate(h.get("counts") or []):
                    mine.counts[i] += c
                mine.total += int(h.get("count", 0))
                mine.sum += float(h.get("sum", 0.0))


def merge_snapshots(snaps: Iterable[Dict]) -> Dict:
    """Merge many ``Registry.snapshot()`` dicts into one (the fleet
    coordinator's view over per-worker metric shards)."""
    reg = Registry()
    for s in snaps:
        if s:
            reg.merge_snapshot(s)
    return reg.snapshot()


def _prom_name(name: str) -> str:
    return "repro_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def escape_label_value(value: str) -> str:
    """Escape one label value per the Prometheus text exposition format:
    backslash, double-quote and newline must be escaped inside the
    quoted value (``\\\\``, ``\\"``, ``\\n``) — anything else through a
    scraper unescaped silently corrupts the series."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labels: Optional[Dict[str, str]],
               extra: Optional[Tuple[str, str]] = None) -> str:
    """Render a ``{k="v",...}`` label block (empty string when none).
    Values pass through ``escape_label_value``; the ``extra`` pair (the
    histogram ``le`` bound, already exposition-safe) renders last."""
    pairs = [(k, escape_label_value(v))
             for k, v in sorted((labels or {}).items())]
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


def render_prometheus(snap: Dict,
                      labels: Optional[Dict[str, str]] = None) -> str:
    """Prometheus text exposition of one ``Registry.snapshot()``.

    ``labels`` attaches constant labels (e.g. ``{"instance": ...}``) to
    every emitted series, values escaped per the exposition format.
    Histograms emit the full conformant series set: cumulative
    ``_bucket{le=...}`` lines, a ``+Inf`` bucket equal to ``_count``,
    and the ``_sum``/``_count`` pair."""
    out: List[str] = []
    base = _label_str(labels)
    for n in sorted(snap.get("counters") or {}):
        pn = _prom_name(n)
        out.append(f"# TYPE {pn}_total counter")
        out.append(f"{pn}_total{base} {snap['counters'][n]:g}")
    for n in sorted(snap.get("gauges") or {}):
        pn = _prom_name(n)
        out.append(f"# TYPE {pn} gauge")
        out.append(f"{pn}{base} {snap['gauges'][n]:g}")
    for n in sorted(snap.get("histograms") or {}):
        h = snap["histograms"][n]
        pn = _prom_name(n)
        out.append(f"# TYPE {pn} histogram")
        cum = 0
        for bound, c in zip(h["bounds"], h["counts"]):
            cum += c
            ls = _label_str(labels, extra=("le", f"{bound:g}"))
            out.append(f"{pn}_bucket{ls} {cum}")
        inf = _label_str(labels, extra=("le", "+Inf"))
        out.append(f'{pn}_bucket{inf} {h["count"]}')
        out.append(f"{pn}_sum{base} {h['sum']:g}")
        out.append(f"{pn}_count{base} {h['count']}")
    return "\n".join(out) + ("\n" if out else "")
