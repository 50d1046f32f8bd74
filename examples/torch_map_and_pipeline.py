"""Scenario for the PyTorch port: use the Fast-OverlaPIM mapper's
transformation to derive an overlap schedule, then execute it as pipeline
parallelism over ``torch.distributed`` ranks.

    PYTHONPATH=src python examples/torch_map_and_pipeline.py --device cpu
    PYTHONPATH=src python examples/torch_map_and_pipeline.py   # cuda

This is the DESIGN.md Section 3 level-2 adaptation end-to-end: the
paper's transformation orders microbatch tiles by input-ready time; the
wavefront pipeline (``repro_torch.pipeline.pipeline_forward``) executes
them across the stages of a mesh axis. ``--device cpu`` spawns 4 gloo
ranks (the reference's 4 XLA host devices); ``--device cuda`` one NCCL
rank a visible card (one card: one stage).
"""
import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.pipeline.overlap_pipeline import (
    overlap_schedule, pipeline_forward, sequential_reference)

D, N_MICRO = 64, 8


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def rank_main(rank, n_stages, device, init):
    """One stage: join the group, run the pipeline, print on rank 0."""
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=init, world_size=n_stages,
                            rank=rank)
    try:
        mesh = init_device_mesh(device, (n_stages,),
                                mesh_dim_names=("stage",))
        dev = torch.device(device, rank) if device == "cuda" else "cpu"
        gen = torch.Generator().manual_seed(0)
        params = {
            "w": torch.randn(n_stages, D, D, generator=gen) * D ** -0.5,
            "b": torch.zeros(n_stages, D),
        }
        params = {k: v.to(dev) for k, v in params.items()}
        x = torch.randn(N_MICRO, 16, D,
                        generator=torch.Generator().manual_seed(1)).to(dev)

        # microbatch ready times (e.g. streamed request arrival) -> the
        # paper's transformation gives the emission order
        ready = np.array([3.0, 0.0, 5.0, 1.0, 7.0, 2.0, 6.0, 4.0])
        order = overlap_schedule(ready)
        y = pipeline_forward(stage_fn, params, x, mesh, axis="stage",
                             order=order)
        y_ref = sequential_reference(stage_fn, params, x)
        err = float((y - y_ref).abs().max())
        if rank == 0:
            print(f"stages={n_stages} microbatches={N_MICRO}")
            print(f"ready times: {ready.tolist()}")
            print(f"overlap-transformed emission order: {order.tolist()}")
            print(f"pipeline output matches sequential reference: "
                  f"max_err={err:.2e}")
            ticks_pipe = N_MICRO + n_stages - 1
            ticks_seq = N_MICRO * n_stages
            print(f"wavefront ticks {ticks_pipe} vs sequential {ticks_seq} "
                  f"(= {ticks_seq / ticks_pipe:.1f}x overlap speedup at "
                  f"equal stage latency)")
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA requested but torch.cuda.is_available() is "
                         "False; pass --device cpu")
    n = 4 if args.device == "cpu" else torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "rendezvous")
        mp.spawn(rank_main, args=(n, args.device, init), nprocs=n)


if __name__ == "__main__":
    main()
