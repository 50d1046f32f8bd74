"""Quickstart: search PIM mappings for the LLM model zoo, through the
PyTorch port (``repro_torch``), which lowers its own config registry.

    PYTHONPATH=src python examples/torch_llm_workloads.py
    PYTHONPATH=src python examples/torch_llm_workloads.py \
        --scenario deepseek_moe_16b_smoke:prefill@64

Lowers one zoo scenario (``repro_torch.workloads`` — see DESIGN.md
Section 15) into a 7D loop-nest network, prints its layer/edge structure, and
runs the overlap-driven mapping search on both the prefill and the
decode shape of the same model, showing how the two phases stress the
mapper differently (seq x seq score matmuls vs 1-row KV-cache reads).
"""
import argparse

from repro_torch.core import (SearchConfig, describe, dram_pim,
                              optimize_network)
from repro_torch.workloads import list_scenarios, parse_scenario


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="deepseek_moe_16b_smoke:prefill@64",
                    help="zoo scenario (arch[:phase][@length][xblocks]); "
                         "list_scenarios() gives the canonical names")
    ap.add_argument("--candidates", type=int, default=4)
    ap.add_argument("--max-steps", type=int, default=512)
    args = ap.parse_args()

    arch = dram_pim(channels_per_layer=2, banks_per_channel=4,
                    columns_per_bank=1024)
    sc = parse_scenario(args.scenario)
    cfg = SearchConfig(n_candidates=args.candidates, seed=0,
                       max_steps=args.max_steps, mode="transform")

    print(f"zoo scenarios: {len(list_scenarios())} full + "
          f"{len(list_scenarios(smoke=True))} smoke "
          f"(this run: {sc.name})")

    for phase in ("prefill", "decode"):
        name = f"{sc.arch_id}{'_smoke' if sc.smoke else ''}:{phase}"
        desc = describe(name)
        macs = sum(l.macs for l in desc.layers)
        print(f"\n{desc.name}: {len(desc.layers)} layers, "
              f"{len(desc.edges)} edges, {macs / 1e6:.1f} MMACs")
        for l in desc.layers[:6]:
            print(f"  {l.name:28s} K={l.K:5d} C={l.C:5d} "
                  f"P={l.P:5d} Q={l.Q:3d} N={l.N}")
        if len(desc.layers) > 6:
            print(f"  ... {len(desc.layers) - 6} more")
        res = optimize_network(desc.layers, desc.edges, arch, cfg)
        print(f"  transform search: {res.total_ns / 1e6:.3f} ms on "
              f"{arch.name}")


if __name__ == "__main__":
    main()
