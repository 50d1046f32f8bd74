"""Trace analytics: call trees, time attribution, flamegraph export.

Turns the span JSONL a traced run leaves behind (``--trace-out``) into
the artifacts a latency investigation actually needs:

* a **call tree** per thread, reconstructed from the spans' exit order
  and per-thread nesting depth (spans are written at *exit*, so a
  parent line always follows its children's lines);
* **self/total-time attribution** per span name — total time is the
  summed duration of every span with that name, self time is total
  minus time spent in child spans, so the self-time column answers
  "where did the milliseconds actually go" and sums exactly to the
  root spans' duration;
* the **critical path** — from the longest root span, repeatedly
  descend into the longest child — the single chain a perf fix must
  shorten to move the end-to-end number;
* **Chrome trace-event JSON** (``ph: "X"`` complete events) loadable
  in Perfetto / ``chrome://tracing``;
* **folded-stack text** (``root;child;leaf <self_us>`` lines), the
  input format of the standard flamegraph toolchain.

All surfaced as ``benchmarks/run.py obs-profile --trace <file>
[--chrome-out P] [--folded-out P] [--top N]``.

Trace-format tolerance: spans written before the start-timestamp fix
carry only the end wall clock (``ts``) — starts fall back to
``ts - dur_s`` — and no ``tid`` (all spans parse onto one implicit
thread). Unparsable lines (a truncated tail from a killed run) are
counted and skipped, never fatal; an empty or span-free trace renders
a message instead of a stack trace.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple


class SpanNode:
    """One span occurrence in the reconstructed call tree."""

    __slots__ = ("name", "ts0", "ts", "dur_s", "depth", "tid", "attrs",
                 "children")

    def __init__(self, name: str, ts0: float, ts: float, dur_s: float,
                 depth: int, tid: int, attrs: Dict):
        self.name = name
        self.ts0 = ts0
        self.ts = ts
        self.dur_s = dur_s
        self.depth = depth
        self.tid = tid
        self.attrs = attrs
        self.children: List["SpanNode"] = []

    def self_s(self) -> float:
        """Duration not attributable to any child span (floored at 0 —
        sampled-out parents can leave children summing past ``dur_s``)."""
        return max(0.0, self.dur_s - sum(c.dur_s for c in self.children))


#: span-event keys that are structural, not user attributes
_STRUCT_KEYS = frozenset(("ev", "name", "ts", "ts0", "dur_s", "depth",
                          "tid"))


class Trace:
    """A parsed span trace: the per-thread call forest plus parse stats.

    ``roots`` holds every depth-0 (or orphaned) span across all
    threads; ``n_events`` / ``n_spans`` / ``n_bad_lines`` describe what
    the file held. Empty and truncated files parse to an empty trace —
    callers render a message, not a traceback."""

    def __init__(self, roots: List[SpanNode], n_events: int,
                 n_spans: int, n_bad_lines: int):
        self.roots = roots
        self.n_events = n_events
        self.n_spans = n_spans
        self.n_bad_lines = n_bad_lines

    def total_s(self) -> float:
        """Summed duration of the root spans (the attribution base)."""
        return sum(r.dur_s for r in self.roots)

    def walk(self):
        """Yield every node, parents before children."""
        stack = list(self.roots)
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children)


def _span_node(ev: Dict) -> Optional[SpanNode]:
    try:
        name = ev["name"]
        dur = float(ev["dur_s"])
        depth = int(ev["depth"])
        ts = float(ev.get("ts", 0.0))
    except (KeyError, TypeError, ValueError):
        return None
    if dur < 0 or depth < 0:
        return None
    # pre-fix traces carry only the end wall clock: reconstruct the
    # start from the same base instead of mixing clock bases
    ts0 = float(ev.get("ts0", ts - dur))
    tid = int(ev.get("tid", 0))
    attrs = {k: v for k, v in ev.items() if k not in _STRUCT_KEYS}
    return SpanNode(name, ts0, ts, dur, depth, tid, attrs)


def parse_trace(path: str) -> Trace:
    """Parse a span JSONL file into a :class:`Trace`.

    Reconstruction: spans are written at exit, so within one thread a
    span at depth ``d`` adopts every not-yet-adopted span at depth
    ``> d`` as its children (deeper-than-``d+1`` levels only appear
    when sampling dropped the intermediate parent — they attach
    flattened rather than vanish). Spans still unadopted at EOF (their
    parent never closed, or the file was truncated) become roots.
    Malformed lines and non-span events are skipped and counted."""
    n_events = n_spans = n_bad = 0
    # per-tid: depth -> completed nodes awaiting a parent
    pending: Dict[int, Dict[int, List[SpanNode]]] = {}
    try:
        fh = open(path, "r", encoding="utf-8")
    except OSError:
        return Trace([], 0, 0, 0)
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
                if not isinstance(ev, dict):
                    raise ValueError
            except ValueError:
                n_bad += 1
                continue
            n_events += 1
            if ev.get("ev") != "span":
                continue
            node = _span_node(ev)
            if node is None:
                n_bad += 1
                continue
            n_spans += 1
            by_depth = pending.setdefault(node.tid, {})
            # adopt every pending deeper span in this thread
            deeper = sorted(d for d in by_depth if d > node.depth)
            for d in deeper:
                node.children.extend(by_depth.pop(d))
            node.children.sort(key=lambda c: c.ts0)
            by_depth.setdefault(node.depth, []).append(node)
    roots: List[SpanNode] = []
    for by_depth in pending.values():
        for d in sorted(by_depth):
            roots.extend(by_depth[d])
    roots.sort(key=lambda r: r.ts0)
    return Trace(roots, n_events, n_spans, n_bad)


def attribution(trace: Trace) -> List[Dict]:
    """Per-span-name time attribution, heaviest self time first.

    Each row: ``name``, ``count``, ``total_s`` (summed durations),
    ``self_s`` (durations minus child time) and ``self_pct`` of the
    root total. Self times sum to the root spans' total duration by
    construction — the "where did it go" invariant."""
    rows: Dict[str, Dict] = {}
    for node in trace.walk():
        row = rows.setdefault(node.name, {"name": node.name, "count": 0,
                                          "total_s": 0.0, "self_s": 0.0})
        row["count"] += 1
        row["total_s"] += node.dur_s
        row["self_s"] += node.self_s()
    base = trace.total_s()
    out = sorted(rows.values(), key=lambda r: -r["self_s"])
    for row in out:
        row["self_pct"] = 100.0 * row["self_s"] / base if base > 0 else 0.0
    return out


def critical_path(trace: Trace) -> List[Dict]:
    """The longest chain: from the longest root, descend into the
    longest child at every level. Rows carry ``name``/``dur_s``/
    ``self_s``/``depth`` — the spans a fix must shorten to move the
    end-to-end wall clock."""
    if not trace.roots:
        return []
    node = max(trace.roots, key=lambda r: r.dur_s)
    path = []
    while node is not None:
        path.append({"name": node.name, "dur_s": node.dur_s,
                     "self_s": node.self_s(), "depth": node.depth})
        node = max(node.children, key=lambda c: c.dur_s, default=None)
    return path


def chrome_trace(trace: Trace) -> Dict:
    """Chrome trace-event JSON (the ``chrome://tracing`` / Perfetto
    load format): one ``ph: "X"`` complete event per span, timestamps
    in microseconds relative to the earliest span start, thread ids
    preserved, span attributes in ``args``."""
    events: List[Dict] = []
    t_base = min((n.ts0 for n in trace.walk()), default=0.0)
    for node in trace.walk():
        events.append({
            "name": node.name,
            "ph": "X",
            "ts": round((node.ts0 - t_base) * 1e6, 3),
            "dur": round(node.dur_s * 1e6, 3),
            "pid": 1,
            "tid": node.tid,
            "args": node.attrs,
        })
    events.sort(key=lambda e: (e["tid"], e["ts"]))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def folded_stacks(trace: Trace) -> List[str]:
    """Folded-stack lines (``a;b;c <self_us>``) — the collapsed input
    of the standard flamegraph toolchain; zero-self frames are kept
    only when they are leaves, so every microsecond appears exactly
    once."""
    lines: Dict[str, int] = {}

    def rec(node: SpanNode, prefix: str) -> None:
        stack = f"{prefix};{node.name}" if prefix else node.name
        self_us = int(round(node.self_s() * 1e6))
        if self_us > 0 or not node.children:
            lines[stack] = lines.get(stack, 0) + self_us
        for child in node.children:
            rec(child, stack)

    for root in trace.roots:
        rec(root, "")
    return [f"{stack} {us}" for stack, us in sorted(lines.items())]


def render_profile(trace: Trace, top: int = 15) -> str:
    """The ``obs-profile`` terminal report: parse stats, the self-time
    table (heaviest ``top`` names), and the critical path."""
    if trace.n_spans == 0:
        msg = "(no spans in trace"
        if trace.n_bad_lines:
            msg += f"; {trace.n_bad_lines} unparsable lines skipped"
        return msg + ")\n"
    lines = [f"spans={trace.n_spans} roots={len(trace.roots)} "
             f"total={trace.total_s() * 1e3:.3f}ms"
             + (f" bad_lines={trace.n_bad_lines}"
                if trace.n_bad_lines else "")]
    rows = attribution(trace)
    lines.append("")
    lines.append(f"{'name':<28} {'count':>6} {'total_ms':>10} "
                 f"{'self_ms':>10} {'self%':>6}")
    for row in rows[:top]:
        lines.append(f"{row['name']:<28} {row['count']:>6} "
                     f"{row['total_s'] * 1e3:>10.3f} "
                     f"{row['self_s'] * 1e3:>10.3f} "
                     f"{row['self_pct']:>5.1f}%")
    shown = sum(r["self_s"] for r in rows[:top])
    lines.append(f"{'(shown)':<28} {'':>6} {'':>10} "
                 f"{shown * 1e3:>10.3f} "
                 f"{100.0 * shown / trace.total_s() if trace.total_s() else 0.0:>5.1f}%")
    lines.append("")
    lines.append("critical path:")
    for step in critical_path(trace):
        indent = "  " * (step["depth"] + 1)
        lines.append(f"{indent}{step['name']}  "
                     f"{step['dur_s'] * 1e3:.3f}ms "
                     f"(self {step['self_s'] * 1e3:.3f}ms)")
    return "\n".join(lines) + "\n"


def write_chrome_trace(trace: Trace, path: str) -> None:
    """Write the Chrome trace-event JSON to ``path``."""
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(chrome_trace(trace), fh, sort_keys=True)
        fh.write("\n")


def write_folded(trace: Trace, path: str) -> None:
    """Write the folded flamegraph stacks to ``path``."""
    with open(path, "w", encoding="utf-8") as fh:
        for line in folded_stacks(trace):
            fh.write(line + "\n")
