#!/usr/bin/env python3
"""How far bf16 rounding alone moves one train step's loss and gradients.

    PYTHONPATH=src python scripts/calibrate_train_numerics.py \\
        [--arch olmo_1b --layers 2 --batch 2 --seq 256]

At full width and a cut depth, runs the port's plain path on the CPU
twice from the same weights and batch: in bf16 compute (the reference's
rounding: every product rounded to bf16) and in fp32. Prints the loss,
the gradients' global norm and each gradient leaf's relative RMS
difference (the worst leaf last). ``chip_smoke.py``'s train-numerics
limits for the card's bf16 kernel path against the fp32 CPU path are
set from this spread.
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.models.common import tree_get, tree_map  # noqa: E402
from repro_torch.train.optimizer import global_norm  # noqa: E402


def leaf_rel_rms(got, want):
    """{path: ||got - want|| / ||want||} over the leaves whose reference
    gradient is not zero (olmo's unread norm scales are zero in both)."""
    out = {}

    def one(path, w):
        g = tree_get(got, path)
        norm = float(w.float().norm())
        if norm > 0:
            out[path] = float((g.float().cpu() - w.float().cpu()).norm()
                              / norm)
    tree_map(one, want)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch).with_(n_layers=args.layers)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(
        args.seed))
    toks = np.random.RandomState(args.seed).randint(
        0, cfg.vocab, (args.batch, args.seq + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    runs = {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        loss, _, grads = value_and_grad(cfg.with_(compute_dtype=dtype),
                                        params, batch)
        runs[dtype] = (float(loss), float(global_norm(grads)), grads)
        print(f"{dtype}: loss {runs[dtype][0]:.6f} grad_norm "
              f"{runs[dtype][1]:.6f} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    (l32, n32, g32), (l16, n16, g16) = runs["float32"], runs["bfloat16"]
    print(f"loss |diff| {abs(l16 - l32):.3e} (rel {abs(l16 - l32) / l32:.3e})"
          f"; grad_norm rel diff {abs(n16 - n32) / n32:.3e}")
    rel = leaf_rel_rms(g16, g32)
    for path, r in sorted(rel.items(), key=lambda kv: kv[1]):
        print(f"  {path}: rel RMS {r:.3e}")
    worst = max(rel, key=rel.get)
    print(f"worst leaf {worst}: rel RMS {rel[worst]:.3e}")


if __name__ == "__main__":
    main()
