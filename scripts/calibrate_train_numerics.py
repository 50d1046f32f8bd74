#!/usr/bin/env python3
"""How far bf16 rounding alone moves one train step's loss and gradients,
and the served logits.

    PYTHONPATH=src python scripts/calibrate_train_numerics.py \\
        [--arch olmo_1b --layers 2 --batch 2 --seq 256] [--no-step]

At full width and a cut depth, runs the port's plain path on the CPU
twice from the same weights and inputs: in bf16 compute (the reference's
rounding: every product rounded to bf16) and in fp32. Prints the
relative RMS difference of the prefill's last logits and of one decode
step's (real vocab), and, unless ``--no-step``, one train step's loss,
aux, the gradients' global norm and each gradient leaf's relative RMS
difference (the worst leaf last). The audio family's prefill and step
take encoder frames and the vlm's step image embeddings (``img_tokens``
of them), drawn from the seed; for the vlm it also prints the forward's
logits with those embeddings prepended. ``--layers`` cuts the decoder
(the encoder keeps its depth). For the moe family it also prints, per
layer, the share of (token, choice) routes that differ between the two
runs (a route is the chosen expert, or "dropped"): a near-tie in the
fp32 router flips under bf16 activations, and with capacity a flip moves
later tokens' queue positions. ``chip_smoke.py``'s limits for the card's
bf16 kernel path against the fp32 CPU path are set from this spread.
"""
import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import mlp as mlp_mod  # noqa: E402
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


def rel_rms(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).norm() / want.norm())


@contextlib.contextmanager
def record_routes():
    """Collect every MoE layer's routes in call order while open: one
    [ns, tl, k] CPU tensor per ``mlp._route`` call, the chosen expert
    where kept and -1 where dropped."""
    routes = []
    real = mlp_mod._route

    def spy(cfg, params, xt):
        out = real(cfg, params, xt)
        routes.append(torch.where(out[4], out[2], -1).cpu())
        return out

    mlp_mod._route = spy
    try:
        yield routes
    finally:
        mlp_mod._route = real


def route_flips(got, want):
    """Per layer, the share of (token, choice) routes that differ."""
    return [float((g != w).float().mean()) for g, w in zip(got, want)]


def serve_logits(cfg, params, toks, frames=None):
    """(prefill's last logits, one greedy decode step's logits, the routes
    of each) on the CPU; ``frames`` for the audio family."""
    with torch.inference_mode():
        with record_routes() as r_pre:
            logits, cache = model_zoo.prefill(cfg, params, toks,
                                              toks.shape[1] + 1,
                                              frames=frames)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        with record_routes() as r_dec:
            logits_d, _ = model_zoo.decode_step(cfg, params, cache, nxt)
    return logits, logits_d, r_pre, r_dec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--step", action=argparse.BooleanOptionalAction,
                    default=True, help="also calibrate one train step")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch).with_(n_layers=args.layers)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(
        args.seed))
    toks = np.random.RandomState(args.seed).randint(
        0, cfg.vocab, (args.batch, args.seq + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    extra = {"audio": ("frames", cfg.enc_frames),
             "vlm": ("extra_embeds", cfg.img_tokens)}.get(cfg.family)
    if extra:
        batch[extra[0]] = torch.from_numpy(np.random.RandomState(
            args.seed + 1).randn(args.batch, extra[1], cfg.d_model).astype(
                np.float32))
    serve, runs, vlm = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        dcfg = cfg.with_(compute_dtype=dtype)
        serve[dtype] = serve_logits(dcfg, params, batch["tokens"],
                                    batch.get("frames"))
        msg = f"{dtype}: prefill + decode step"
        if cfg.family == "vlm":
            with torch.inference_mode():
                vlm[dtype] = model_zoo.forward(dcfg, params, batch)[0]
            msg += " + forward with image embeddings"
        if args.step:
            loss, metrics, grads = value_and_grad(dcfg, params, batch)
            runs[dtype] = (float(loss), float(metrics["aux"]),
                           float(global_norm(grads)), grads)
            msg += (f"; loss {runs[dtype][0]:.6f} aux {runs[dtype][1]:.6f} "
                    f"grad_norm {runs[dtype][2]:.6f}")
        print(f"{msg} ({time.perf_counter() - t0:.1f} s)", flush=True)
    v = cfg.vocab
    (p32, d32, rp32, rd32), (p16, d16, rp16, rd16) = (serve["float32"],
                                                      serve["bfloat16"])
    print(f"logits rel RMS: prefill {rel_rms(p16[:, :v], p32[:, :v]):.3e}, "
          f"decode {rel_rms(d16[:, :v], d32[:, :v]):.3e}")
    if vlm:
        r = rel_rms(vlm["bfloat16"][..., :v], vlm["float32"][..., :v])
        print(f"forward logits with {cfg.img_tokens} image embeddings rel "
              f"RMS: {r:.3e}")
    if cfg.family == "moe":
        print(f"routes that differ per layer: prefill "
              f"{route_flips(rp16, rp32)}, decode "
              f"{route_flips(rd16, rd32)}")
    if not args.step:
        return
    (l32, a32, n32, g32), (l16, a16, n16, g16) = (runs["float32"],
                                                  runs["bfloat16"])
    print(f"loss |diff| {abs(l16 - l32):.3e} (rel {abs(l16 - l32) / l32:.3e})"
          f"; grad_norm rel diff {abs(n16 - n32) / n32:.3e}"
          + (f"; aux rel diff {abs(a16 - a32) / a32:.3e}" if a32 else ""))
    rel = leaf_rel_rms(g16, g32)
    for path, r in sorted(rel.items(), key=lambda kv: kv[1]):
        print(f"  {path}: rel RMS {r:.3e}")
    worst = max(rel, key=rel.get)
    print(f"worst leaf {worst}: rel RMS {rel[worst]:.3e}")


if __name__ == "__main__":
    main()
