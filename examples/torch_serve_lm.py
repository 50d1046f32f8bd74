"""Serving example for the PyTorch port: batched generation with a KV cache
through ``repro_torch.serve.Engine``.

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch mamba2_780m]
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

Uses the reduced smoke config of the chosen architecture (random
weights from the seed; this demonstrates the serving path: prefill ->
primed cache -> single-token decode across a request batch). On CUDA
(the default) the model runs the Hopper kernels, which are built with
nvcc at their first call; ``--device cpu`` runs their plain versions.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import model_zoo
from repro_torch.serve.engine import Engine, ServeConfig, resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b", choices=list(ARCH_IDS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    params = model_zoo.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    eng = Engine(cfg, params, scfg=ServeConfig(
        max_seq=args.prompt_len + args.new_tokens + 1,
        max_new_tokens=args.new_tokens,
        temperature=args.temperature), device=device)

    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab,
                          (args.batch, args.prompt_len)).astype(np.int32)
    frames = None
    if cfg.family == "audio":   # the stub frontend's output, from the seed
        frames = rng.randn(args.batch, cfg.enc_frames,
                           cfg.d_model).astype(np.float32)
    t0 = time.time()
    out = eng.generate(prompts, frames)
    dt = time.time() - t0
    print(f"arch={args.arch} (smoke config, family={cfg.family})")
    print(f"generated {out.shape} tokens in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s incl. "
          f"compile)")
    for i, row in enumerate(out):
        print(f"  seq{i}: {row.tolist()}")


if __name__ == "__main__":
    main()
