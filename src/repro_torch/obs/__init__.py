"""Stdlib-only telemetry: metrics registry, span tracing, reporting.

The observability layer for the whole reproduction (DESIGN.md
Section 12). Three parts:

* :mod:`repro_torch.obs.metrics` — ``Registry`` of counters / gauges /
  fixed-bucket mergeable histograms, snapshot/merge, Prometheus text
  exposition.
* :mod:`repro_torch.obs.trace` — nestable ``span()`` timing with a JSONL
  ``TraceSink``, counter-based deterministic sampling, and the
  process-global enable/disable switch (off ⇒ shared no-ops).
* :mod:`repro_torch.obs.report` — ``render_report`` turns a snapshot into
  the ``run.py obs-report`` terminal summary.
* :mod:`repro_torch.obs.profile` — span-trace analytics (call tree, self/
  total-time attribution, critical path, Chrome trace-event JSON and
  folded-flamegraph export) behind ``run.py obs-profile``.
* :mod:`repro_torch.obs.flight` — ``FlightRecorder``, the bounded ring of
  per-request serving records (stage timings, provenance, slow-request
  full-detail retention) behind ``GET /v1/debug/requests``.
* :mod:`repro_torch.obs.window` — ``WindowHistogram``/``SLOTracker``,
  sliding time-window quantiles and SLO burn rate published as recent
  p50/p99 gauges next to the all-time histograms.

Typical call-site usage::

    from repro_torch import obs
    obs.inc("dse.evaluated", 3)
    with obs.span("dse.sweep", budget=8):
        ...

All helpers dispatch through the *current* telemetry, so modules
instrumented at import time see a registry enabled later via
``obs.enable(trace_path=..., sample_every=...)``. Hard contract:
telemetry observes, it never steers — results are byte-identical with
telemetry on, off, or sampled (enforced by ``tests/test_obs.py``).
"""
from .flight import FlightRecorder
from .metrics import (Counter, Gauge, Histogram, Registry,
                      escape_label_value, merge_snapshots, quantile,
                      render_prometheus)
from .profile import (Trace, attribution, chrome_trace, critical_path,
                      folded_stacks, parse_trace, render_profile)
from .report import render_report
from .trace import (NullTelemetry, Telemetry, TraceSink, current, disable,
                    enable, enabled, event, inc, observe, registry,
                    set_gauge, span)
from .window import SLOTracker, WindowHistogram

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry",
    "escape_label_value", "merge_snapshots", "quantile",
    "render_prometheus",
    "render_report",
    "Trace", "attribution", "chrome_trace", "critical_path",
    "folded_stacks", "parse_trace", "render_profile",
    "FlightRecorder", "SLOTracker", "WindowHistogram",
    "NullTelemetry", "Telemetry", "TraceSink",
    "current", "disable", "enable", "enabled", "event",
    "inc", "observe", "registry", "set_gauge", "span",
]
