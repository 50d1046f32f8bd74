"""Quickstart: co-search PIM architecture x overlap mapping (DSE), through
the PyTorch port's copy of the mapper (``repro_torch.dse``; numpy).

    PYTHONPATH=src python examples/torch_dse_sweep.py [--budget 12]
    PYTHONPATH=src python examples/torch_dse_sweep.py --objective edp

Sweeps a small grid of ``dram_pim`` variants for resnet18, scoring each
architecture point with the full overlap-driven mapping search (batched
engine, one shared instance across all points), and prints the
latency/energy/area Pareto frontier plus the iso-area winner against the
paper's default 2-channel x 8-bank configuration. ``--objective`` makes
the per-point mapping search energy-aware (``energy`` / ``edp`` /
``blend`` — see DESIGN.md Section 9); the frontier then trades
mapping-level energy, including the movement energy of
transform-relocated tiles, not just the arch-level proxies. Pass
``--journal`` to make the sweep resumable (re-running serves every point
from the journal and performs zero new mapping searches).
"""
import argparse

from repro_torch.core import OBJECTIVES
from repro_torch.dse import (DSEConfig, ParamSpace, frontier_table,
                             record_edp, run_dse, summarize)


def small_dram_space() -> ParamSpace:
    """A restricted dram_pim space so the quickstart finishes in ~10 s:
    channel/bank/column allocation only, default point = ``dram_pim()``."""
    return ParamSpace(
        family="dram_pim",
        axes={
            "channels_per_layer": (1, 2, 4),
            "banks_per_channel": (4, 8, 16),
            "columns_per_bank": (4096, 8192),
        },
        constraints=[
            lambda p: (p["channels_per_layer"] * p["banks_per_channel"]
                       <= 32),
        ],
        defaults={"channels_per_layer": 2, "banks_per_channel": 8,
                  "columns_per_bank": 8192},
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=int, default=12,
                    help="design points to score")
    ap.add_argument("--candidates", type=int, default=6,
                    help="mapping candidates per layer per point")
    ap.add_argument("--objective", default="edp", choices=OBJECTIVES,
                    help="mapping-search objective (default: edp — the "
                         "energy-aware search the frontier is built on)")
    ap.add_argument("--journal", default=None,
                    help="JSONL journal path (makes the sweep resumable)")
    args = ap.parse_args()

    space = small_dram_space()
    cfg = DSEConfig(network="resnet18", mode="transform", explorer="grid",
                    budget=args.budget, n_candidates=args.candidates,
                    max_steps=1024, objective=args.objective,
                    journal_path=args.journal)
    print(f"grid sweep: {space.family} x resnet18, "
          f"budget={cfg.budget} of {space.size} grid points, "
          f"objective={cfg.objective}")
    res = run_dse(cfg, space=space)

    print(summarize(res))
    print("\nPareto frontier (latency / energy / area, all minimized):")
    print(frontier_table(res.frontier))

    best = res.best_within_area()
    if best is not None and best["total_ns"] < res.baseline["total_ns"]:
        print(f"\nAt the default config's area budget, the best variant "
              f"is {res.baseline['total_ns'] / best['total_ns']:.2f}x "
              f"faster — architecture search pays even before touching "
              f"the mapper.")
    base_edp = record_edp(res.baseline)
    best_edp = res.best_by("edp_ns_pj")
    if best_edp is not None:
        edp = record_edp(best_edp)
        if edp < base_edp:
            print(f"Best EDP point beats the default config by "
                  f"{base_edp / edp:.2f}x on energy-delay product "
                  f"({best_edp['arch_name']}).")


if __name__ == "__main__":
    main()
