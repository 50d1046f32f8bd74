"""Serving launcher for the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_8b \
        --no-smoke --batch 4 --prompt-len 512 --new-tokens 32

Builds random parameters from ``--seed`` on ``--device`` (CUDA unless
told otherwise) and serves a batch of synthetic prompts through the
Engine. ``--smoke`` (the default, as in the reference) picks the reduced
config; ``--no-smoke`` the full one.
"""
import argparse

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..models import model_zoo
from ..serve.engine import Engine, ServeConfig, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params = model_zoo.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed))
    eng = Engine(cfg, params, scfg=ServeConfig(
        max_seq=args.prompt_len + args.new_tokens + 1,
        max_new_tokens=args.new_tokens, temperature=args.temperature),
        device=device)
    prompts = np.random.RandomState(args.seed).randint(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    out = eng.generate(prompts)
    for i, row in enumerate(out):
        print(f"seq{i}: {row.tolist()}")


if __name__ == "__main__":
    main()
