"""Sizes of the benchmark's cells for the CPU tests: the same families and
code paths at widths a test can hold, found by name in ``bench/sizes``.

``bench/sizes/<config>.json`` holds a configuration's smoke widths, every
cell's test size. ``bench/sizes/<workload>.json``, where present, holds
``config`` and ``traffic`` overrides for the cell's control test: larger
where the control's float8 error has to reach a serving cell's limit,
which was set at the cell's own size (a served token's widest logit gap
grows with depth, width and the number of positions judged).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

SIZES = Path(__file__).resolve().parent / "sizes"
CAPS = {"batch": 2, "seq": 32, "prompt": 64, "new_tokens": 8,
        "check_requests": 8}


def shrink(cell, **traffic):
    """``cell`` at its configuration's smoke widths, its mix capped at
    ``CAPS`` and then updated with ``traffic``."""
    t = {k: min(v, CAPS[k]) if k in CAPS else v
         for k, v in cell.traffic.items()}
    t.update(traffic)
    smoke = json.loads((SIZES / f"{cell.config['name']}.json").read_text())
    return dataclasses.replace(cell, config={**cell.config, **smoke},
                               traffic=t)


def control_size(cell):
    """``cell`` at the size its control test runs."""
    small = shrink(cell)
    path = SIZES / f"{cell.name}.json"
    if not path.exists():
        return small
    over = json.loads(path.read_text())
    return dataclasses.replace(
        small, config={**small.config, **over.get("config", {})},
        traffic={**small.traffic, **over.get("traffic", {})})
