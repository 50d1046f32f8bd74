"""Span tracing and the process-global telemetry switch.

Telemetry is **off by default**: the module-global current telemetry
is a ``NullTelemetry`` whose ``span()``/``event()`` return shared
no-op singletons, so the disabled cost of an instrumented call site is
one dict/attribute lookup and a truthiness test. ``enable()`` swaps in
a live ``Telemetry`` (optionally with a JSONL ``TraceSink`` and a
``sample_every`` span-sampling stride); ``disable()`` restores the
null default and closes the sink.

Spans nest: each ``with obs.span("dse.sweep", budget=8):`` writes one
JSONL line at exit with the span name, wall-clock duration, nesting
depth (tracked per-thread) and any keyword attributes. Sampling is
*counter-based* (every Nth span of a given name), never RNG-based, so
tracing can never perturb the deterministic search results —
the DESIGN.md Section 12 contract.

Module-level helpers (``inc``, ``observe``, ``set_gauge``, ``event``,
``span``) always dispatch through the *current* telemetry, so call
sites instrumented at import time pick up a registry enabled later at
runtime.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional

from .metrics import Registry


class TraceSink:
    """Append-only JSONL event writer (lazily opened, line-flushed)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None
        self._lock = threading.Lock()

    def write(self, ev: Dict) -> None:
        """Serialize one event dict as a JSON line and flush it."""
        line = json.dumps(ev, sort_keys=True)
        with self._lock:
            if self._fh is None:
                self._fh = open(self.path, "a", encoding="utf-8")
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        """Close the underlying file (later writes reopen it)."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class _Span:
    """Context manager timing one named span; writes JSONL on exit."""

    __slots__ = ("_tel", "_name", "_attrs", "_t0", "_wall0")

    def __init__(self, tel: "Telemetry", name: str, attrs: Dict):
        self._tel = tel
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> "_Span":
        self._tel._depth().append(self._name)
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dur = time.perf_counter() - self._t0
        stack = self._tel._depth()
        stack.pop()
        self._tel._emit_span(self._name, dur, len(stack), self._attrs,
                             self._wall0)


class _NoopSpan:
    """Shared do-nothing span for disabled/sampled-out call sites."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


class Telemetry:
    """Live telemetry: a metrics ``Registry`` plus optional span sink.

    ``sample_every=N`` keeps every Nth span per span-name (a plain
    per-name counter, deterministic across runs); metrics are never
    sampled."""

    enabled = True

    def __init__(self, registry: Optional[Registry] = None,
                 sink: Optional[TraceSink] = None,
                 sample_every: int = 1):
        self.registry = registry if registry is not None else Registry()
        self.sink = sink
        self.sample_every = max(1, int(sample_every))
        self._seen: Dict[str, int] = {}
        self._seen_lock = threading.Lock()
        self._local = threading.local()

    def _depth(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **attrs):
        """A timing context manager for ``name``; no-op when the span
        is sampled out or there is no sink (metrics still flow)."""
        if self.sink is None:
            return _NOOP_SPAN
        if self.sample_every > 1:
            with self._seen_lock:
                n = self._seen.get(name, 0)
                self._seen[name] = n + 1
            if n % self.sample_every:
                return _NOOP_SPAN
        return _Span(self, name, attrs)

    def _emit_span(self, name: str, dur_s: float, depth: int,
                   attrs: Dict, wall0: Optional[float] = None) -> None:
        # ``ts`` (end) and ``ts0`` (start) share one wall-clock base, so
        # trace analytics never reconstruct starts by mixing the
        # ``time.time`` and ``perf_counter`` bases; ``tid`` keys the
        # per-thread span streams for call-tree/Chrome-trace export.
        # Older traces lack ``ts0``/``tid`` — ``repro_torch.obs.profile``
        # falls back to ``ts - dur_s`` and a single implicit thread.
        end = time.time()
        ev = {"ev": "span", "name": name, "ts": end,
              "ts0": wall0 if wall0 is not None else end - dur_s,
              "dur_s": dur_s, "depth": depth,
              "tid": threading.get_ident()}
        ev.update(attrs)
        self.sink.write(ev)
        self.registry.histogram("span." + name).observe(dur_s)

    def event(self, name: str, **attrs) -> None:
        """Write one point-in-time JSONL event (no-op without a sink)."""
        if self.sink is None:
            return
        ev = {"ev": "event", "name": name, "ts": time.time()}
        ev.update(attrs)
        self.sink.write(ev)


class NullTelemetry:
    """Disabled telemetry: every operation is a shared no-op."""

    enabled = False
    registry = None
    sink = None

    def span(self, name: str, **attrs):
        """Return the shared no-op span."""
        return _NOOP_SPAN

    def event(self, name: str, **attrs) -> None:
        """Drop the event."""


_NULL = NullTelemetry()
_current = _NULL


def current():
    """The process-global telemetry (``NullTelemetry`` when disabled)."""
    return _current


def enabled() -> bool:
    """True when telemetry collection is on."""
    return _current.enabled


def registry() -> Optional[Registry]:
    """The live metrics registry, or None when telemetry is disabled."""
    return _current.registry


def enable(trace_path: Optional[str] = None, sample_every: int = 1,
           registry: Optional[Registry] = None) -> Telemetry:
    """Turn telemetry on process-wide and return the live instance.

    ``trace_path`` adds a JSONL span/event sink; ``sample_every=N``
    keeps every Nth span per name; ``registry`` reuses an existing
    metrics registry (a fresh one is created otherwise)."""
    global _current
    sink = TraceSink(trace_path) if trace_path else None
    _current = Telemetry(registry=registry, sink=sink,
                         sample_every=sample_every)
    return _current


def disable() -> None:
    """Restore the no-op default and close any open trace sink."""
    global _current
    sink = getattr(_current, "sink", None)
    _current = _NULL
    if sink is not None:
        sink.close()


def inc(name: str, n: float = 1.0) -> None:
    """Increment counter ``name`` on the current registry (no-op when
    telemetry is disabled)."""
    reg = _current.registry
    if reg is not None:
        reg.counter(name).inc(n)


def observe(name: str, value: float) -> None:
    """Record ``value`` into histogram ``name`` (no-op when disabled)."""
    reg = _current.registry
    if reg is not None:
        reg.histogram(name).observe(value)


def set_gauge(name: str, value: float) -> None:
    """Set gauge ``name`` to ``value`` (no-op when disabled)."""
    reg = _current.registry
    if reg is not None:
        reg.gauge(name).set(value)


def event(name: str, **attrs) -> None:
    """Emit a point-in-time trace event through the current telemetry."""
    _current.event(name, **attrs)


def span(name: str, **attrs):
    """A span context manager through the current telemetry (a shared
    no-op object when telemetry is disabled)."""
    return _current.span(name, **attrs)
