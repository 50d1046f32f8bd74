"""Serving launcher for the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_8b \
        --no-smoke --batch 4 --prompt-len 512 --new-tokens 32

Builds random parameters from ``--seed`` on ``--device`` (CUDA unless
told otherwise), or with ``--ckpt DIR`` restores the ``"params"`` of the
newest valid ``.rpck`` checkpoint there (either package's trainer writes
them), and serves a batch of synthetic prompts through the Engine; for the
audio family (whisper_base) also synthetic encoder frames from the seed,
which the reference launcher does not pass (it cannot serve that family).
``--smoke`` (the default, as in the reference) picks the reduced config;
``--no-smoke`` the full one.
"""
import argparse

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..models import model_zoo
from ..serve.engine import Engine, ServeConfig, resolve_device
from ..train import checkpoint as ckpt_lib


DEFAULT_PROMPT_LEN = 16
DEFAULT_NEW_TOKENS = 16


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=DEFAULT_PROMPT_LEN)
    ap.add_argument("--new-tokens", type=int, default=DEFAULT_NEW_TOKENS)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt", default=None,
                    help="serve the params of the newest checkpoint here")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params = model_zoo.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed))
    if args.ckpt:
        res = ckpt_lib.restore(args.ckpt, {"params": params}, device=device)
        if res is None:
            raise SystemExit(f"no valid checkpoint of {cfg.arch_id} in "
                             f"{args.ckpt}")
        step, trees, _ = res
        params = trees["params"]
        print(f"restored params of step {step} from {args.ckpt}")
    eng = Engine(cfg, params, scfg=ServeConfig(
        max_seq=args.prompt_len + args.new_tokens + 1,
        max_new_tokens=args.new_tokens, temperature=args.temperature),
        device=device)
    rng = np.random.RandomState(args.seed)
    prompts = rng.randint(0, cfg.vocab,
                          (args.batch, args.prompt_len)).astype(np.int32)
    frames = None
    if cfg.family == "audio":
        # the stub frontend's output, drawn as data/synthetic.py draws it
        frames = rng.randn(args.batch, cfg.enc_frames,
                           cfg.d_model).astype(np.float32)
    out = eng.generate(prompts, frames)
    for i, row in enumerate(out):
        print(f"seq{i}: {row.tolist()}")


if __name__ == "__main__":
    main()
