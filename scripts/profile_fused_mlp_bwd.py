"""Device time of each launch of the fused MLP's backward kernels
(``csrc/fused_mlp_bwd.cu``: mlp_bwd_dh, mlp_bwd_dw2, mlp_bwd_dx,
mlp_bwd_dw13) at the train shapes chip_smoke.py times as one call:
olmo_1b's M=8192 K=2048 F=8192 and llava_next_34b's M=640 K=7168
F=20480, bf16, fan-in scaled random inputs from a seed.

    PYTHONPATH=src python scripts/profile_fused_mlp_bwd.py [--reps 5]

Needs a CUDA GPU (builds the kernels at first use). Prints the card's
name and power limit, then for each shape the work split the kernels'
plan chose (``bwd_plan``: the launches that run stream-K, and each
launch's tiles and last-wave fill on this card's SMs), the mean device
ms of each launch over ``--reps`` backward calls (torch.profiler), their
sum, and the 6-product bound at 989 TFLOP/s. It times the launches
alone: the host's work before the first launch, which a CUDA-event
timing of the whole call includes, is not counted. Run it from an
unpacked parent tree in the same call to compare two versions (a tree
without ``bwd_plan`` prints no split).
"""
import argparse
import re
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels.fused_mlp import FusedMLP
from repro_torch.kernels.fused_mlp import ops as mlp_ops

SHAPES = (("olmo_1b", 8192, 2048, 8192), ("llava_next_34b", 640, 7168, 20480))
PEAK_BF16_FLOPS = 989e12   # H100 SXM data sheet, dense bf16


def inputs(m, k, f, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)
    args = tuple(t.requires_grad_() for t in (
        rnd(m, k), rnd(k, f, scale=k ** -0.5), rnd(k, f, scale=k ** -0.5),
        rnd(f, k, scale=f ** -0.5)))
    return args, rnd(m, k)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    reps = ap.parse_args(argv).reps
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, m, k, f in SHAPES:
        if hasattr(mlp_ops, "bwd_plan"):
            plan = mlp_ops.bwd_plan(m, k, f, sms)
            print(f"{name} split on {sms} SMs: " + ", ".join(
                f"{p.name} {'stream-K' if p.stream_k else 'whole tiles'} "
                f"({p.tiles} tiles of {p.kblocks} k-blocks, fill "
                f"{p.fill:.3f})" for p in plan), flush=True)
        args, dy = inputs(m, k, f)
        y = FusedMLP.apply(*args)
        torch.autograd.grad(y, args, dy, retain_graph=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                torch.autograd.grad(y, args, dy, retain_graph=True)
            torch.cuda.synchronize()
        per = {re.search(r"mlp_bwd_\w+", e.key).group(0):
               e.self_device_time_total / 1e3 / reps
               for e in prof.key_averages() if "mlp_bwd_" in e.key}
        bound = 12.0 * m * k * f / PEAK_BF16_FLOPS * 1e3
        print(f"{name} M={m} K={k} F={f}: " + ", ".join(
            f"{n} {ms:.4f}" for n, ms in per.items())
            + f"; sum {sum(per.values()):.4f} ms; bound {bound:.4f} ms",
            flush=True)
        del args, dy, y
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
