"""Incremental Pareto frontier with dominance pruning.

All objectives are minimized. The frontier is maintained incrementally:
``add`` rejects dominated candidates in one pass over the current frontier
and evicts any incumbents the new point dominates, so the structure is
always exactly the non-dominated set of everything offered so far.
Duplicate-objective points are kept only once (first writer wins), which
makes resumed sweeps idempotent.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_OBJECTIVES = ("total_ns", "energy_pj", "area_mm2")


@dataclasses.dataclass(frozen=True)
class FrontierPoint:
    key: str                        # DesignPoint.key()
    objectives: Tuple[float, ...]   # aligned with frontier.names
    payload: Optional[Dict] = None  # full evaluation record


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """``a`` dominates ``b``: <= everywhere, < somewhere (minimization)."""
    strict = False
    for x, y in zip(a, b):
        if x > y:
            return False
        if x < y:
            strict = True
    return strict


class ParetoFrontier:
    """The non-dominated set under per-name minimization objectives."""

    def __init__(self, names: Sequence[str] = DEFAULT_OBJECTIVES):
        self.names: Tuple[str, ...] = tuple(names)
        self._points: List[FrontierPoint] = []

    def __len__(self) -> int:
        return len(self._points)

    def __iter__(self):
        return iter(self.points)

    @property
    def points(self) -> List[FrontierPoint]:
        """Frontier sorted by the first objective."""
        return sorted(self._points, key=lambda p: p.objectives)

    def key_set(self) -> set:
        """Keys of the current frontier (O(F); membership tests O(1))."""
        return {p.key for p in self._points}

    def objectives_of(self, record: Dict) -> Tuple[float, ...]:
        """This frontier's objective vector of an evaluation record."""
        return tuple(float(record[n]) for n in self.names)

    def add_record(self, key: str, record: Dict) -> bool:
        """``add`` with objectives pulled out of an evaluation record."""
        return self.add(key, self.objectives_of(record), record)

    def add(self, key: str, objectives: Sequence[float],
            payload: Optional[Dict] = None) -> bool:
        """Offer a point; returns True iff it joins the frontier.

        Dominated candidates are rejected; incumbents dominated by the
        candidate are evicted. A candidate with exactly the objectives of
        an incumbent is redundant and rejected (idempotent resume)."""
        objs = tuple(float(v) for v in objectives)
        if len(objs) != len(self.names):
            raise ValueError(
                f"expected {len(self.names)} objectives, got {len(objs)}")
        for p in self._points:
            if p.objectives == objs or dominates(p.objectives, objs):
                return False
        self._points = [p for p in self._points
                        if not dominates(objs, p.objectives)]
        self._points.append(FrontierPoint(key, objs, payload))
        return True

    def dominated(self, objectives: Sequence[float]) -> bool:
        """True iff the frontier already dominates (or equals) the
        given objective vector — ``add`` would reject it."""
        objs = tuple(float(v) for v in objectives)
        return any(dominates(p.objectives, objs) or p.objectives == objs
                   for p in self._points)

    def best(self, name: str) -> Optional[FrontierPoint]:
        """Frontier point minimizing one named objective."""
        if not self._points:
            return None
        i = self.names.index(name)
        return min(self._points, key=lambda p: p.objectives[i])

    def canonical_json(self) -> str:
        """Canonical serialization for byte-comparing frontiers across
        runs and worker counts (payloads carry wall-clock noise and are
        excluded; key + objectives are the frontier's identity). Exact
        duplicate objective vectors are rejected on ``add``, so sorting
        by (objectives, key) is a total order."""
        pts = sorted(self._points, key=lambda p: (p.objectives, p.key))
        return json.dumps(
            {"names": list(self.names),
             "points": [{"key": p.key, "objectives": list(p.objectives)}
                        for p in pts]},
            sort_keys=True, separators=(",", ":"))
