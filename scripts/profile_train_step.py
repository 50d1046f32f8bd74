"""Step time of one model's training through the port's Trainer, and the
device time of its forward and of its forward plus backward, split by
kernel: what tells a change in a step's device work from one in host time.

    PYTHONPATH=src python scripts/profile_train_step.py \
        --arch mamba2_780m --layers 24 [--steps 6] [--reps 3] [--top 16]

Needs a CUDA GPU (builds the kernels at first use). Runs ``--steps`` steps
of batch 4 x 2048, random weights from seed 0 (chip_smoke.py's train
workload; ``--layers`` cuts the depth as chip_smoke.py does), and prints the
card's name and power limit, each step's wall time and the median of steps
2 on, peak device memory, and the median over ``--reps`` of chip_smoke.py's
split of one step by CUDA events: the forward without grad, the backward
(``value_and_grad`` less that forward; under remat "full" it holds the
recompute) and AdamW. Then torch.profiler's device time of each kernel over
one no-grad forward and over one ``value_and_grad``, and their difference:
the device work of the backward, with the recompute and whatever the forward
does only under grad. The ``--top`` kernels by that difference are printed,
then the total. Run it from an unpacked parent tree in the same call to
compare two versions.
"""
import argparse
import statistics
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataConfig
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import model_zoo
from repro_torch.train.optimizer import OptimizerConfig, adamw_update
from repro_torch.train.trainer import Trainer, TrainerConfig

BATCH, SEQ = 4, 2048


def timed_ms(fn):
    """(ms between CUDA events around ``fn()``, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def kernel_ms(fn):
    """Device ms of each kernel name (and memset, copy) over one ``fn()``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total / 1e3
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cfg = get_config(args.arch)
    cfg = cfg.with_(n_layers=args.layers or cfg.n_layers)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=2,
                              total_steps=args.steps)
    tr = Trainer(cfg, opt_cfg, TrainerConfig(steps=args.steps, log_every=1),
                 DataConfig(batch=BATCH, seq=SEQ), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    tr.run()
    torch.cuda.synchronize()
    steps = tr.step_seconds
    print(f"{args.arch} {cfg.n_layers} layers, {BATCH} x {SEQ}: step s "
          f"{[round(t, 4) for t in steps]}, median of 2-{len(steps)} "
          f"{statistics.median(steps[1:]):.4f}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    params, opt = tr.final_state
    batch = tr._device_batch(tr.stream.batch_at(args.steps))

    def forward():
        with torch.no_grad():
            return model_zoo.loss_fn(cfg, params, batch)

    def both():
        return value_and_grad(cfg, params, batch)

    splits = []
    for _ in range(args.reps):
        fwd, _ = timed_ms(forward)
        fwd_bwd, (_, _, grads) = timed_ms(both)
        opt_ms, _ = timed_ms(lambda: adamw_update(opt_cfg, params, grads,
                                                  opt))
        del grads
        splits.append((fwd, fwd_bwd - fwd, opt_ms))
    med = [statistics.median(x) for x in zip(*splits)]
    print(f"  split (CUDA events, median of {args.reps}): forward "
          f"{med[0]:.2f} ms, backward {med[1]:.2f} ms, optimizer "
          f"{med[2]:.2f} ms", flush=True)
    fwd_k = kernel_ms(forward)
    both_k = kernel_ms(both)
    diff = {k: both_k.get(k, 0.0) - fwd_k.get(k, 0.0)
            for k in set(fwd_k) | set(both_k)}
    print(f"  device ms: forward {sum(fwd_k.values()):.3f}, forward + "
          f"backward {sum(both_k.values()):.3f}, backward's share "
          f"{sum(diff.values()):.3f}; by kernel (backward's share, forward):",
          flush=True)
    for k in sorted(diff, key=lambda k: -abs(diff[k]))[:args.top]:
        print(f"    {diff[k]:9.3f} {fwd_k.get(k, 0.0):9.3f}  {k[:100]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
