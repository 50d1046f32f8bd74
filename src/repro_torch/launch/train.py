"""Training launcher for the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
        --no-smoke --steps 8 --batch 4 --seq 2048 --ckpt /path/to/ckpts

Runs the ``Trainer`` on ``--device`` (CUDA unless told otherwise) over
the synthetic stream, resuming from the newest valid checkpoint in
``--ckpt`` when there is one; warmup, checkpoint and log cadence are the
reference launcher's (10, 25, 10 steps). ``--smoke`` (the default, as
in the reference) picks the reduced config; ``--no-smoke`` the full
one. Weights and the optimizer state are fp32; compute is the config's
(bf16).

Started alone it trains on one device, with no mesh. Started by
``torchrun`` (``WORLD_SIZE`` set), every rank joins the process group
(NCCL on cuda, each rank on the card of its ``LOCAL_RANK``; gloo on the
CPU) and trains on a (data, model) mesh of all ranks with
``--model-parallel`` ranks on the model axis:

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --model-parallel 2 --device cpu
"""
import argparse
import logging
import os

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config
from ..data.synthetic import DataConfig
from ..train.optimizer import OptimizerConfig
from ..train.trainer import Trainer, TrainerConfig
from .mesh import make_host_mesh


def _mesh(device: str, model: int):
    """The mesh of a ``torchrun`` launch (the process group joined), or
    None for a launch alone."""
    if "WORLD_SIZE" not in os.environ:
        if model != 1:
            raise SystemExit("--model-parallel needs a torchrun launch")
        return None
    kind = torch.device(device).type
    if kind == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if kind == "cuda" else "gloo")
    return make_host_mesh(model=model, device_type=kind)


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
    ap.add_argument("--model-parallel", type=int, default=1)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = get_config(args.arch, smoke=args.smoke)
    mesh = _mesh(args.device, args.model_parallel)
    try:
        trainer = Trainer(
            cfg, OptimizerConfig(lr=args.lr, warmup_steps=10,
                                 total_steps=args.steps),
            TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt,
                          ckpt_every=25, log_every=10),
            DataConfig(batch=args.batch, seq=args.seq), device=args.device,
            mesh=mesh)
        metrics = trainer.run()
        if mesh is None or dist.get_rank() == 0:
            print(metrics if mesh is None
                  else {**metrics, "mesh": list(mesh.shape)})
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
