"""Training launcher for the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
        --no-smoke --steps 8 --batch 4 --seq 2048 --ckpt /path/to/ckpts

Runs the single-device ``Trainer`` on ``--device`` (CUDA unless told
otherwise) over the synthetic stream, resuming from the newest valid
checkpoint in ``--ckpt`` when there is one; warmup, checkpoint and log
cadence are the reference launcher's (10, 25, 10 steps). ``--smoke``
(the default, as in the reference) picks the reduced config;
``--no-smoke`` the full one. Weights and the optimizer state are fp32;
compute is the config's (bf16).
"""
import argparse
import logging

from ..configs import ARCH_IDS, get_config
from ..data.synthetic import DataConfig
from ..train.optimizer import OptimizerConfig
from ..train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = get_config(args.arch, smoke=args.smoke)
    trainer = Trainer(
        cfg, OptimizerConfig(lr=args.lr, warmup_steps=10,
                             total_steps=args.steps),
        TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt, ckpt_every=25,
                      log_every=10),
        DataConfig(batch=args.batch, seq=args.seq), device=args.device)
    print(trainer.run())


if __name__ == "__main__":
    main()
