"""Sweep driver: the library face of ``benchmarks/run.py dse``.

Everything that used to live between ``argparse`` and ``print`` in the
CLI — journal naming, serial-vs-distributed dispatch, and the
machine-readable sweep summary — lives here, so the CLI, the
benchmarks, and the mapping service (``repro_torch.serve.service``) drive
sweeps through one code path and can never disagree on where a journal
lives or what a summary means.

``execute_sweep`` is the single entry point: it runs ``run_dse``
serially (optionally under a wall-clock deadline) or fans the same
config out through the distributed subsystem (``repro_torch.dse.distrib``),
returning the same ``DSEResult`` contract either way.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Optional

from .explore import DSEConfig, DSEResult, record_edp, run_dse
from .persist import RunJournal
from .space import ParamSpace

#: default directory for CLI/service journals (relative to the cwd)
JOURNAL_ROOT = "dse_runs"


def objective_tag(objective: str, blend_alpha: float = 0.5) -> str:
    """Filename/BENCH-key token of a sweep objective.

    Empty for ``latency`` (the implicit objective of every pre-energy
    journal, so their paths stay stable); ``blend`` carries its alpha so
    differently-weighted sweeps never share a journal or a BENCH entry.
    """
    if objective == "latency":
        return ""
    if objective == "blend":
        return f"blend{blend_alpha:g}"
    return objective


def journal_template(family: str, objective: str = "latency",
                     blend_alpha: float = 0.5,
                     root: str = JOURNAL_ROOT) -> str:
    """THE journal-path template: ``<root>/<family>_{network}_{mode}
    [_<objective>].jsonl``. A caller-supplied literal path simply has no
    placeholders and formats to itself."""
    tag = objective_tag(objective, blend_alpha)
    return os.path.join(
        root, family + "_{network}_{mode}" + (f"_{tag}" if tag else "")
        + ".jsonl")


def network_token(network: str) -> str:
    """Filesystem token of a network/scenario name: the zoo scenario
    grammar's ``:``/``@`` (``deepseek_moe_16b:prefill@2048``) and any
    other shell-hostile character become ``-``. Identity for the core
    network names, so their journal paths are unchanged."""
    return re.sub(r"[^A-Za-z0-9_.\-]", "-", network)


def journal_path_for(cfg: DSEConfig, root: str = JOURNAL_ROOT) -> str:
    """Resolved journal path of one sweep (``cfg.journal_path`` wins if
    set; otherwise the shared naming scheme)."""
    template = cfg.journal_path or journal_template(
        cfg.family, cfg.objective, cfg.blend_alpha, root)
    return template.format(network=network_token(cfg.network),
                           mode=cfg.mode)


def shared_dir_for(journal_path: str) -> str:
    """Default distributed shared-dir of a journal path: ``.jsonl`` ->
    ``.shared`` (a sibling directory, so the two stores sit together)."""
    if journal_path.endswith(".jsonl"):
        return journal_path[:-len(".jsonl")] + ".shared"
    return journal_path + ".shared"


def execute_sweep(cfg: DSEConfig, *,
                  space: Optional[ParamSpace] = None,
                  journal: Optional[RunJournal] = None,
                  deadline_s: Optional[float] = None,
                  engine=None,
                  distributed: int = 0,
                  shared_dir: Optional[str] = None,
                  batch_size: int = 1,
                  lease_ttl_s: float = 60.0,
                  timeout_s: float = 3600.0) -> DSEResult:
    """Run one sweep — serial or distributed — under one contract.

    Serial (``distributed == 0``): ``run_dse`` with an optional
    wall-clock ``deadline_s`` (best-so-far frontier on expiry) and an
    optional caller-owned shared ``OverlapEngine`` (the mapping
    service's cross-request cache warming).
    Distributed (``distributed == N > 0``): the shared-dir work-stealing
    subsystem with N local worker processes; ``shared_dir`` defaults to
    the sweep's journal path with ``.jsonl`` -> ``.shared``. Deadlines
    and caller-supplied journals/spaces/engines are serial-only (workers
    build their own view from the shared directory; spaces and engines
    do not pickle).
    """
    if distributed <= 0:
        return run_dse(cfg, space=space, journal=journal,
                       deadline_s=deadline_s, engine=engine)
    if deadline_s is not None:
        raise ValueError("deadline_s is serial-only; a distributed "
                         "sweep runs to completion of its budget")
    if space is not None or journal is not None or engine is not None:
        raise ValueError("distributed sweeps derive space, journal and "
                         "engines from the config/shared dir; pass none")
    from .distrib import DistribConfig, run_distributed
    root = shared_dir or shared_dir_for(journal_path_for(cfg))
    dist = DistribConfig(root=root, n_workers=distributed,
                         batch_size=batch_size, lease_ttl_s=lease_ttl_s,
                         timeout_s=timeout_s)
    return run_distributed(dataclasses.replace(cfg, journal_path=None),
                           dist)


def sweep_summary(res: DSEResult) -> Dict:
    """Machine-readable summary of one sweep — THE schema behind
    ``BENCH_search.json["dse"]`` entries and service responses: stats,
    baseline, iso-area and EDP winners, and the full frontier with the
    EDP-dominance flag against the latency-only baseline."""
    best = res.best_within_area() or res.baseline
    best_edp = res.best_by("edp_ns_pj") or res.baseline
    return {
        "explorer": res.config.explorer,
        "objective": res.config.objective,
        "blend_alpha": res.config.blend_alpha,
        "budget": res.config.budget,
        "evaluated": res.stats["evaluated"],
        "from_journal": res.stats["from_journal"],
        "frontier": res.stats["frontier"],
        "wall_s": round(res.stats["wall_s"], 2),
        "baseline_arch": res.baseline["arch_name"],
        "baseline_total_ns": res.baseline["total_ns"],
        "baseline_energy_pj": res.baseline["energy_pj"],
        "baseline_edp_ns_pj": record_edp(res.baseline),
        "best_iso_area_arch": best["arch_name"],
        "best_iso_area_total_ns": best["total_ns"],
        "best_iso_area_point": best["point"],
        "best_edp_arch": best_edp["arch_name"],
        "best_edp_ns_pj": record_edp(best_edp),
        "best_edp_total_ns": best_edp["total_ns"],
        "best_edp_energy_pj": best_edp["energy_pj"],
        # True iff some frontier point beats the latency-only search
        # on the default arch (the baseline) on EDP
        "frontier_dominates_baseline_on_edp": any(
            p.objectives[0] * p.objectives[1] < record_edp(res.baseline)
            for p in res.frontier.points),
        # the energy-aware frontier itself (latency/energy/area all
        # minimized), so BENCH_search.json records the trade-off
        "frontier_points": frontier_points(res),
    }


def frontier_points(res: DSEResult) -> list:
    """The frontier as plain dicts (latency/energy/area plus the arch
    identity), the wire format of summaries and service responses."""
    return [
        {"arch_name": (p.payload or {}).get("arch_name", p.key),
         "point": (p.payload or {}).get("point"),
         "total_ns": p.objectives[0],
         "energy_pj": p.objectives[1],
         "area_mm2": p.objectives[2],
         "move_energy_pj": (p.payload or {}).get("move_energy_pj"),
         "edp_ns_pj": p.objectives[0] * p.objectives[1]}
        for p in res.frontier.points]
