"""The traced run: spans from the benchmark's own files, the profiler's
device trace, and their reduction to what the per-layer readers read.

Spans are ``torch.profiler.record_function`` ranges the benchmark wraps
around attributes of the program (``Spans``); a name that is gone is
skipped and its readers find nothing. ``Trace`` profiles the host and
the card over the traced window and reduces the events to:

* ``window_s``: the window span's length on the profiler's clock;
* ``busy_s``: the union of the device operations' intervals in it;
* ``device_ops``: seconds by device operation name;
* ``spans``: per span name, its count, host seconds, and the device
  seconds of the operations launched inside it (by the launch's
  correlation id);
* ``idle``: the gaps with no device operation, by the innermost
  benchmark span the host was in when each began.
"""
from __future__ import annotations

import functools
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

PREFIX = "bench."
WINDOW = PREFIX + "window"


class Spans:
    """Wrap ``(owner, attribute, name)`` targets in record_function
    ranges named ``bench.<name>`` while installed."""

    def __init__(self, targets):
        self.targets = targets
        self.saved: List[Tuple[object, str, object]] = []

    def __enter__(self):
        for owner, attr, name in self.targets:
            if not hasattr(owner, attr):
                continue
            fn = getattr(owner, attr)
            self.saved.append((owner, attr, owner.__dict__.get(attr)))
            setattr(owner, attr, _wrap(fn, PREFIX + name))
        return self

    def __exit__(self, *exc):
        for owner, attr, before in reversed(self.saved):
            if before is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, before)
        self.saved.clear()


def _wrap(fn, name):
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with record_function(name):
            return fn(*args, **kw)
    return wrapped


def span(name: str):
    """A benchmark span around a block of the benchmark's own code."""
    return record_function(PREFIX + name)


class Trace:
    """The profiler over a traced window (a context manager)."""

    def __init__(self):
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    def reduce(self) -> dict:
        return reduce_events(self.prof.profiler.kineto_results.events())


def _is_device(e) -> bool:
    """A device operation: a kernel, copy or set on the card; not the
    card-side copy of a host annotation (a span)."""
    return (e.device_type() != torch.autograd.DeviceType.CPU
            and not e.is_user_annotation()
            and not e.name().startswith(PREFIX))


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events) -> dict:
    """The summary above from a list of kineto events."""
    cpu = [e for e in events
           if e.device_type() == torch.autograd.DeviceType.CPU]
    dev = [e for e in events if _is_device(e)]
    win = [e for e in cpu if e.name() == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0 = min(e.start_ns() for e in win)
    w1 = max(e.end_ns() for e in win)
    dev = [e for e in dev if e.end_ns() > w0 and e.start_ns() < w1]
    busy = _merge([(max(e.start_ns(), w0), min(e.end_ns(), w1))
                   for e in dev])
    busy_ns = sum(e - s for s, e in busy)
    ops: Dict[str, float] = defaultdict(float)
    for e in dev:
        ops[e.name()] += e.duration_ns() / 1e9

    spans = [e for e in cpu if e.name().startswith(PREFIX)
             and e.name() != WINDOW]
    launch_at = {e.correlation_id(): e.start_ns() for e in cpu
                 if e.correlation_id()}
    starts = sorted((e.start_ns(), e.end_ns(), e.name()) for e in spans)
    summary: Dict[str, dict] = {}
    for s, e, name in starts:
        d = summary.setdefault(name[len(PREFIX):], {
            "count": 0, "host_s": 0.0, "device_s": 0.0})
        d["count"] += 1
        d["host_s"] += (e - s) / 1e9
    # device seconds of the operations launched inside each span
    launched = []
    for ev in dev:
        t = launch_at.get(ev.correlation_id(),
                          launch_at.get(ev.linked_correlation_id()))
        if t is not None:
            launched.append((t, ev.duration_ns() / 1e9))
    for name, (_, secs) in zip(_innermost(starts, [t for t, _ in launched]),
                               launched):
        if name is not None:
            summary[name[len(PREFIX):]]["device_s"] += secs

    gaps = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])
    for name, (s, e) in zip(_innermost(starts, [s for s, _ in gaps]), gaps):
        label = "outside spans" if name is None else name[len(PREFIX):]
        rec = idle[label]
        rec[0] += 1
        rec[1] += (e - s) / 1e9
        rec[2] = max(rec[2], (e - s) / 1e9)
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "device_ops": dict(ops), "spans": summary,
            "idle": {k: tuple(v) for k, v in idle.items()}}


def _innermost(starts, times):
    """For each time of ``times``, the name of the innermost span of
    ``starts`` ((start, end, name), sorted by start; spans nest) that
    contains it, or None: one sweep with a stack of open spans."""
    out = [None] * len(times)
    stack, j = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(starts) and starts[j][0] <= t:
            stack.append(starts[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if stack:
            out[i] = stack[-1][2]
    return out


def breakdown(summary: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time, and the idle time by what the host was in."""
    ops = sorted(summary["device_ops"].items(), key=lambda kv: -kv[1])
    gaps = sorted(summary["idle"].items(), key=lambda kv: -kv[1][1])
    return {"device_ops": [[n[:160], s] for n, s in ops[:top]],
            "idle_gaps": [[f"{label} ({n} gaps, longest {mx * 1e3:.3f} ms)",
                           total] for label, (n, total, mx) in gaps[:top]]}
