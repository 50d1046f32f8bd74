"""Device time of each launch of the SSD scan's backward
(``csrc/ssd_scan_bwd.cu``) at the train shapes chip_smoke.py times:
mamba2_780m's B=4 S=2048 H=48 P=64 N=128 and zamba2_1_2b's B=4 S=2048
H=64 P=64 N=64, one group, chunk 256; bf16 x/B/C, fp32 dt/A, random
inputs from a seed as chip_smoke.py draws them.

    PYTHONPATH=src python scripts/profile_ssd_scan_bwd.py [--reps 10]

Needs a CUDA GPU (builds the kernels at first use). Prints the card's
name and power limit, then for each shape the mean device ms of each
launch over ``--reps`` backward calls (torch.profiler; every kernel whose
name starts with ``ssd_``, so the script reads any version of the
backward), their sum, the bound chip_smoke.py states for the backward (from
``ssd_scan.ops.bwd_work``; a tree without it states none), and
the device memory the forward keeps for the backward and the backward
takes beyond its inputs (``max_memory_allocated``). It times the launches
alone: the host's work before the first launch, which a CUDA-event timing
of the whole call includes, is not counted. Run it from an unpacked parent
tree in the same call to compare two versions.
"""
import argparse
import re
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import SSDScan
from repro_torch.kernels.ssd_scan import ops as ssd_ops

PEAK_BF16_FLOPS = 989e12   # H100 SXM data sheet, dense bf16
PEAK_BYTES = 3.35e12       # H100 SXM data sheet, HBM3


def shapes():
    """(label, b, s, h, g, n, p, chunk) of each timed shape."""
    out = []
    for arch in ("mamba2_780m", "zamba2_1_2b"):
        c = get_config(arch)
        out.append((arch, 4, 2048, c.ssm_heads, c.ssm_groups, c.ssm_state,
                    c.ssm_head_dim, c.ssm_chunk))
    return out


def bound_ms(b, s, h, g, n, p, chunk):
    """The backward's bound, as chip_smoke.py states it: the least work
    ``ssd_scan.ops.bwd_work`` counts at the bf16 tensor rate or its bytes
    at the HBM rate, whichever takes longer (None from a tree without
    ``bwd_work``)."""
    if not hasattr(ssd_ops, "bwd_work"):
        return None
    flops, nbytes = ssd_ops.bwd_work(b, s, h, g, n, p, chunk)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3


def inputs(b, s, h, g, n, p, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = rnd(b, s, h, p).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    a = -torch.exp(rnd(h) * 0.2)
    bm, cm = (rnd(b, s, g, n).to(torch.bfloat16) for _ in range(2))
    return [t.requires_grad_() for t in (x, dt, a, bm, cm)], rnd(
        b, s, h, p).to(torch.bfloat16)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    reps = ap.parse_args(argv).reps
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for label, b, s, h, g, n, p, chunk in shapes():
        args, dy = inputs(b, s, h, g, n, p)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        y, state = SSDScan.apply(*args, chunk)
        torch.cuda.synchronize()
        kept = (torch.cuda.memory_allocated() - before - y.nbytes
                - state.nbytes)
        torch.autograd.grad(y, args, dy, retain_graph=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = torch.autograd.grad(y, args, dy, retain_graph=True)
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - base
                 - sum(t.nbytes for t in grads))
        del grads
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                torch.autograd.grad(y, args, dy, retain_graph=True)
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            m = re.search(r"\bssd_\w+(<[^>]*>)?", e.key)
            if m:
                per[m.group(0)] = (per.get(m.group(0), 0.0)
                                   + e.self_device_time_total / 1e3 / reps)
        bms = bound_ms(b, s, h, g, n, p, chunk)
        print(f"{label} B={b} S={s} H={h} G={g} P={p} N={n} chunk {chunk}: "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in per.items())
              + f"; sum {sum(per.values()):.4f} ms; bound "
              + (f"{bms:.4f} ms" if bms is not None else "not stated")
              + "; forward keeps "
              f"{kept / 1e6:.1f} MB, backward workspace {extra / 1e6:.1f} "
              "MB", flush=True)
        del args, dy, y, state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
