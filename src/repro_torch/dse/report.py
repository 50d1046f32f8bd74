"""Human-readable DSE reports: frontier tables and best-arch summaries.

``frontier_table`` renders one sweep's Pareto frontier; ``summarize``
prints sweep stats, the baseline (the space's default architecture — for
``dram_pim`` that is the paper's 2-channel x 8-bank config) and the
iso-area winner. ``sweep_networks`` is the multi-network driver behind
``benchmarks/run.py dse --network all``: one frontier per (network, mode)
plus a cross-network best-arch table.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

from .explore import DSEConfig, DSEResult, record_edp, run_dse
from .pareto import ParetoFrontier


def _fmt_point(params: Dict) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(params.items()))


def _table(headers: Sequence[str], rows: List[Sequence[str]]) -> str:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    def line(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip()
    out = [line(headers), line(["-" * w for w in widths])]
    out += [line(r) for r in rows]
    return "\n".join(out)


def frontier_table(frontier: ParetoFrontier) -> str:
    """The non-dominated set, best latency first.

    Both energy columns use the same pJ -> J conversion (1e12 pJ/J):
    ``energy_J`` is the full mapping-level energy (compute + IO + tile
    movement), ``move_energy_J`` the transform-relocation share of it
    (absent in pre-energy journal records, shown as ``-``)."""
    rows = []
    for p in frontier.points:
        rec = p.payload or {}
        move_pj = rec.get("move_energy_pj")
        rows.append((
            rec.get("arch_name", p.key),
            f"{p.objectives[0] / 1e6:.3f}",
            f"{p.objectives[1] / 1e12:.1f}",
            "-" if move_pj is None else f"{move_pj / 1e12:.2e}",
            f"{p.objectives[2]:.2f}",
            f"{rec.get('power_w', float('nan')):.2f}",
            _fmt_point(rec.get("point", {})),
        ))
    return _table(("arch", "latency_ms", "energy_J", "move_energy_J",
                   "area_mm2", "power_W", "point"), rows)


def summarize(result: DSEResult) -> str:
    """Stats + baseline-vs-best lines for one sweep."""
    st, base = result.stats, result.baseline
    c = result.config
    lines = [
        f"dse: family={c.family} network={c.network} mode={c.mode} "
        f"strategy={c.strategy} explorer={c.explorer} "
        f"objective={c.objective}",
        f"dse: proposed={st['proposed']} evaluated={st['evaluated']} "
        f"from_journal={st['from_journal']} frontier={st['frontier']} "
        f"wall_s={st['wall_s']:.1f}",
        f"dse: baseline {base['arch_name']} "
        f"latency_ms={base['total_ns'] / 1e6:.3f} "
        f"energy_J={base['energy_pj'] / 1e12:.1f} "
        f"area_mm2={base['area_mm2']:.2f}",
    ]
    best_edp = result.best_by("edp_ns_pj")
    if best_edp is not None:
        edp = record_edp(best_edp)
        lines.append(
            f"dse: best-EDP {best_edp['arch_name']} edp={edp:.4e} "
            f"latency_ms={best_edp['total_ns'] / 1e6:.3f} "
            f"energy_J={best_edp['energy_pj'] / 1e12:.1f}")
    best = result.best_within_area()
    if best is not None and best is not result.baseline:
        speedup = base["total_ns"] / best["total_ns"]
        lines.append(
            f"dse: best@iso-area {best['arch_name']} "
            f"latency_ms={best['total_ns'] / 1e6:.3f} "
            f"area_mm2={best['area_mm2']:.2f} speedup={speedup:.2f}x "
            f"({_fmt_point(best['point'])})")
        lines.append(
            "dse: improved=" +
            ("True" if best["total_ns"] < base["total_ns"] else "False"))
    else:
        lines.append("dse: improved=False (baseline is iso-area best)")
    return "\n".join(lines)


def sweep_networks(base: DSEConfig,
                   networks: Iterable[str] = ("resnet18", "vgg16",
                                              "bert_encoder"),
                   modes: Iterable[str] = ("original", "overlap",
                                           "transform"),
                   ) -> Dict[Tuple[str, str], DSEResult]:
    """One sweep per (network, mode), sharing journal naming through the
    per-sweep ``journal_path`` template (``{network}``/``{mode}`` are
    substituted when present)."""
    out: Dict[Tuple[str, str], DSEResult] = {}
    for net in networks:
        for mode in modes:
            path = base.journal_path
            if path:
                path = path.format(network=net, mode=mode)
            cfg = dataclasses.replace(base, network=net, mode=mode,
                                      journal_path=path)
            out[(net, mode)] = run_dse(cfg)
    return out


def best_arch_table(results: Dict[Tuple[str, str], DSEResult]) -> str:
    """Per-(network, mode) winner: lowest latency at iso-area vs the
    family default, with the frontier size alongside."""
    rows = []
    for (net, mode), res in sorted(results.items()):
        best = res.best_within_area() or res.baseline
        base = res.baseline
        rows.append((
            net, mode, best["arch_name"],
            f"{best['total_ns'] / 1e6:.3f}",
            f"{base['total_ns'] / 1e6:.3f}",
            f"{base['total_ns'] / best['total_ns']:.2f}x",
            str(len(res.frontier)),
        ))
    return _table(("network", "mode", "best_arch", "best_ms",
                   "baseline_ms", "speedup", "frontier"), rows)
