"""Where the card sat idle in a traced run of a benchmark cell, put down to
the program's own spans (``repro_torch.launch.spans``).

    python3 scripts/span_idle.py --workload olmo_1b.decode --seed 7 \
        [--seconds 30] [--out span_idle.json]

Needs a CUDA GPU. Runs the cell once as ``bench/run.py --trace 1`` does
(``bench.harness``) and keeps the profiler's events of the traced window.
Each gap of the window in which no device operation ran is put down to
the innermost program range open on any host thread when the gap began:
of the ranges open then (``trainer.*``, ``engine.*``, ``model.*``,
``moe.*``, ``kernel.*``), the one that began last. Prints, and writes to ``--out`` as
JSON, the run's result line and, by range name, the gaps' count, seconds
and longest gap ("outside" where no program range was open), and the
program's span table of the window.
"""
from __future__ import annotations

import argparse
import heapq
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
PROGRAM = ("trainer.", "engine.", "model.", "moe.", "kernel.")


def idle_by_range(events) -> dict:
    """{range name: [gaps, seconds, longest]} of the window's idle gaps
    (``bench.trace.reduce_events``'s window and device operations)."""
    import torch
    from bench import trace
    cpu = [e for e in events
           if e.device_type() == torch.autograd.DeviceType.CPU]
    win = [e for e in cpu if e.name() == trace.WINDOW]
    w0 = min(e.start_ns() for e in win)
    w1 = max(e.end_ns() for e in win)
    busy = trace._merge([(max(e.start_ns(), w0), min(e.end_ns(), w1))
                         for e in events if trace._is_device(e)
                         and e.end_ns() > w0 and e.start_ns() < w1])
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    ranges = sorted((e.start_ns(), e.end_ns(), e.name()) for e in cpu
                    if e.name().startswith(PROGRAM))
    out = defaultdict(lambda: [0, 0.0, 0.0])
    open_, j = [], 0            # heap of (-start, end, name)
    for s, e in gaps:
        while j < len(ranges) and ranges[j][0] <= s:
            heapq.heappush(open_, (-ranges[j][0], ranges[j][1],
                                   ranges[j][2]))
            j += 1
        while open_ and open_[0][1] <= s:
            heapq.heappop(open_)
        rec = out[open_[0][2] if open_ else "outside"]
        rec[0] += 1
        rec[1] += (e - s) / 1e9
        rec[2] = max(rec[2], (e - s) / 1e9)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


def run(cell, seed: int, seconds: float, device="cuda", t0=None) -> dict:
    """One traced run of ``cell``: its result line, the idle gaps by
    program range and the program's span table of the window."""
    from bench import harness, program_spans, trace
    kept = {}
    reduce, table = trace.Trace.reduce, program_spans.table

    def keep_events(self):
        kept["events"] = self.prof.profiler.kineto_results.events()
        return trace.reduce_events(kept["events"])

    def keep_table(ctx):
        kept["table"] = table(ctx)
        return kept["table"]

    trace.Trace.reduce, program_spans.table = keep_events, keep_table
    try:
        result, _ = harness.run(cell, seed, seconds, True, device, t0)
    finally:
        trace.Trace.reduce, program_spans.table = reduce, table
    if "table" not in kept:         # no reader of the cell took it
        from repro_torch.launch import spans
        kept["table"] = spans.table()
    return {"result": result, "idle_by_range": idle_by_range(kept["events"]),
            "table": kept["table"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("span_idle: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from bench import manifest
    out = run(manifest.cell(args.workload, ROOT), args.seed, args.seconds,
              "cuda", T0)
    window = out["result"]["device"]["window_s"]
    print(f"{args.workload}: window {window:.6f} s, busy "
          f"{out['result']['device']['busy_s']:.6f} s")
    for name, (n, secs, longest) in out["idle_by_range"].items():
        print(f"  idle in {name}: {n} gaps, {secs:.6f} s "
              f"({100 * secs / window:.3f}% of the window), longest "
              f"{1e3 * longest:.3f} ms")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
