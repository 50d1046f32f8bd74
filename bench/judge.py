"""How ``correct`` is decided: the numbers compared with the plain
reference, each against its limit from ``bench/limits/<workload>.json``.

Training: ``loss_gap``, the largest relative gap of a checked step's
loss; ``grad_gap``, the worst leaf's gap between the program's and the
reference's norm of the first step's gradient as the optimizer received
it (clipped), over the larger of that leaf's reference norm and the
median leaf's; ``change_gap``, the same of the parameters' change over
the checked steps. A leaf is one layer's slice of a stacked weight.
Leaves whose reference gradient norm is under a thousandth of the
median leaf's are left out of both (their update is round-off).

Serving: ``logit_gap``, the widest gap by which a served token's logit
lies below the reference's best logit at its position, over the checked
requests; a token outside the vocabulary reads infinite.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

DEAD = 1e-3


def _rel(a: float, b: float, base: float) -> float:
    return abs(a - b) / base if base > 0 else (0.0 if a == b else math.inf)


def live_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = float(np.median(list(ref_grad.values())))
    return [k for k, v in ref_grad.items() if v >= DEAD * med]


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              leaves: List[str]) -> Dict[str, float]:
    """Each leaf's gap of norms, over the larger of its reference norm and
    the median leaf's; a leaf the program lacks reads infinite."""
    med = float(np.median([want[k] for k in leaves]))
    out = {}
    for k in leaves:
        gap = _rel(got.get(k, math.nan), want[k], max(want[k], med))
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """Readings are {"loss": [per step], "grad": {leaf: norm}, "change":
    {leaf: norm}}; the reference's also "raw_grad" (before clipping)."""
    loss = max((_rel(p, r, abs(r)) for p, r in zip(prog["loss"],
                                                   ref["loss"])),
               default=math.inf)
    if len(prog["loss"]) != len(ref["loss"]):
        loss = math.inf
    leaves = live_leaves(ref["raw_grad"])
    out = {"loss_gap": loss}
    for key in ("grad", "change"):
        gaps = leaf_gaps(prog[key], ref[key], leaves).values()
        out[f"{key}_gap"] = max(gaps, default=math.inf)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number finite and at or under its limit, and every limit
    read."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= lim for k, lim in limits.items())


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"check {k} {numbers.get(k, math.nan)!r} limit {lim!r}"
            for k, lim in limits.items()]


def as_json(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    out = {}
    for k, lim in limits.items():
        v = numbers.get(k, math.nan)
        out[k] = {"value": v if math.isfinite(v) else str(v), "limit": lim}
    return out
