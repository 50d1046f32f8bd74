"""``BENCHMARK.json`` and the files it names, found by name.

A cell (workload) names a configuration, whose file the manifest gives,
and a traffic mix, ``bench/traffic/<traffic>.json``. Its limits are
``bench/limits/<workload>.json``. Every metric, end to end or per layer,
is read by ``bench/metrics/<metric>.py``'s ``read(ctx)``. A metric with a
``workloads`` key belongs to those cells only. Adding a cell, a mix or a
metric is adding files and a manifest entry: nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def metrics(self, traced: bool) -> List[dict]:
        return self.per_layer if traced else self.end_to_end


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def _mine(metrics: List[dict], workload: str) -> List[dict]:
    return [m for m in metrics
            if "workloads" not in m or workload in m["workloads"]]


def cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` with its files read; KeyError if the manifest
    has no such cell."""
    root = Path(root)
    man = load(root)
    by_name = {w["name"]: w for w in man["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r}; have {sorted(by_name)}")
    w = by_name[workload]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    return Cell(name=workload, chips=w["chips"],
                config=_read(root / conf["file"]),
                traffic=_read(root / "bench" / "traffic"
                              / f"{w['traffic']}.json"),
                limits=_read(root / "bench" / "limits" / f"{workload}.json"),
                end_to_end=_mine(man["end_to_end"], workload),
                per_layer=_mine(man["per_layer"], workload), root=root)


def reader(metric: str, root: Path = ROOT) -> Callable:
    """``read`` of ``bench/metrics/<metric>.py``."""
    path = Path(root) / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
