"""Quickstart: optimize a DNN's PIM mapping with Fast-OverlaPIM, through
the PyTorch port's copy of the mapper (``repro_torch.core``; numpy).

    PYTHONPATH=src python examples/torch_quickstart.py [--net resnet18]

Runs the three optimization modes of the paper on a reduced PIM config
and prints the per-mode latency plus the best transformed mapping of the
busiest layer.
"""
import argparse

from repro_torch.core import (SearchConfig, describe, dram_pim,
                              optimize_network)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="resnet18",
                    choices=["resnet18", "vgg16", "resnet50",
                             "bert_encoder"])
    ap.add_argument("--candidates", type=int, default=16)
    args = ap.parse_args()

    arch = dram_pim(channels_per_layer=2, banks_per_channel=4,
                    columns_per_bank=2048)
    desc = describe(args.net)
    print(f"network: {args.net} ({len(desc.layers)} layers), "
          f"arch: {arch.name} ({arch.n_target_instances} banks)")

    results = {}
    for mode in ("original", "overlap", "transform"):
        cfg = SearchConfig(n_candidates=args.candidates, seed=0,
                           max_steps=4096, mode=mode)
        res = optimize_network(desc.layers, desc.edges, arch, cfg)
        results[mode] = res
        print(f"  {mode:10s}: {res.total_ns / 1e6:8.2f} ms")

    sp = results["original"].total_ns / results["transform"].total_ns
    print(f"\nBest Transform speedup over Best Original: {sp:.2f}x")

    busiest = max(range(len(desc.layers)),
                  key=lambda i: desc.layers[i].macs)
    lr = results["transform"].layers[busiest]
    print(f"\nbusiest layer {desc.layers[busiest].name} "
          f"(transformed={lr.transformed}, "
          f"moved_frac={lr.moved_frac:.2f}):")
    print(lr.mapping.pretty())


if __name__ == "__main__":
    main()
