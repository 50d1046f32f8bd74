"""Readings that the limits in ``bench/limits`` are set from, at a cell's
own size on the card, many seeds in one process:

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 --mode M

``M`` is ``program`` (the program as the configuration states: the lower
readings), ``control`` (the reference in the program's place with float8
operands, one precision below the configurations' bfloat16) or
``fault:<name>`` (``bench.faults``). Training cells read their checked
steps and need no window; serving cells run a window of ``--seconds``
and at least as many calls as the checked sample needs, and the control
judges the float8 reference's own first choices at the positions the
program served. One JSON line per seed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, mode: str, seconds: float, device="cuda"):
    """{number: reading} of one seed in ``mode``."""
    from bench import faults, harness, judge
    from bench.reference import model as ref_model
    fault = mode.split(":", 1)[1] if mode.startswith("fault:") else None
    if cell.kind == "train":
        if mode == "control":
            low = harness.train_readings_reference(
                cell.config, cell.traffic, seed, device,
                ref_model.Dots(fp8=True))
        else:
            with (faults.FAULTS[fault]() if fault else contextlib.nullcontext()):
                tr, low = harness.train_program(cell, seed, device)
            del tr
            harness._free()
        ref = harness.train_readings_reference(
            cell.config, cell.traffic, seed, device, ref_model.Dots())
        numbers = judge.train_numbers(low, ref)
        leaves = judge.live_leaves(ref["raw_grad"])
        for key in ("grad", "change"):  # the median leaf, the worst three
            gaps = judge.leaf_gaps(low[key], ref[key], leaves)
            numbers[f"{key}_gap_median"] = float(np.median(list(
                gaps.values())))
            numbers[f"{key}_worst"] = sorted(gaps, key=gaps.get)[-3:]
        return numbers
    calls = -(-cell.traffic["check_requests"] // cell.traffic["batch"])
    with (faults.FAULTS[fault]() if fault else contextlib.nullcontext()):
        _, outs = harness.serve_program(cell, seed, seconds, False, device,
                                        time.perf_counter(), calls)
    harness._free()
    _, numbers = harness.serve_check(cell, seed, outs, device,
                                     control=mode == "control")
    if mode == "control":
        numbers = {"logit_gap": numbers["control_gap"]}
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench import manifest
    cell = manifest.cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        numbers = readings(cell, seed, args.mode, args.seconds)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "numbers": numbers,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
