"""Multi-pod dry-run: trace one step of every (arch x shape x mesh) cell
on the production meshes, with no device, and price it on H100s.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_8b \\
        --shape train_4k --multi-pod

PyTorch counterpart of ``repro.launch.dryrun``, with its CLI, its cells
(``FSDP_ARCHS``, ``PER_DEVICE_MICRO``, the MoE's routing and expert
axes) and its record, written to
experiments/dryrun_torch/<arch>__<shape>__<mesh>[__<plan>].json. Where the
reference lowers and compiles with XLA on 512 host devices, each cell
here runs one step of ``launch.steps`` eagerly on fake tensors:

  * a fake process group (``FakeStore``, backend "fake") of the mesh's
    size, this process rank 0, and the reference's production
    ``DeviceMesh`` (16 x 16 or 2 x 16 x 16) over it;
  * ``FakeTensorMode``: the params of ``model_zoo.param_shapes``, the
    optimizer state, the batch and the caches are placed by the specs of
    ``launch.sharding`` as fake DTensors, never drawn or allocated;
  * the step of the cell's kind: ``make_grad_accum_train_step`` with the
    optimizer, the prefill or the decode step;
  * ``roofline.count.StepCounter`` around it: per-device FLOPs, bytes,
    collectives and peak memory, and the three-term H100 roofline.

The fake tensors are on the CPU, so the models take their plain paths
(as the reference's dry-run lowers its jnp paths): no kernel launches.
A train cell runs ``make_grad_accum_train_step``'s pieces
(``_train_step``): it traces one of its identical micro-batches and
counts it ``n_micro`` times (``StepCounter.repeat``); the accumulators'
allocation and the optimizer are counted once. Rank 0 stands for every
device: DTensor puts an uneven shard's remainder on the first ranks, so
rank 0's peak is the largest. The record drops the reference's keys that read XLA artifacts
(``cpu_f32_dot_emulation_bytes``, ``tpu_peak_estimate_bytes``,
``xla_cost_reference``); ``lower_s`` is the time to place the cell's
fake state on the mesh, ``compile_s`` the traced step's; it adds
``hbm_budget_bytes_per_device``, the H100's 80 GB that the peak is read
against.

Nothing is initialised on import and no environment variable is set;
``lower_cell`` creates its fake group when it is not handed a mesh and
destroys it before it returns.
"""
import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from ..configs import ARCH_IDS, SHAPES, cell_status, get_config
from ..models import model_zoo
from ..models.common import tree_leaves, tree_map
from ..roofline.analysis import HBM_BYTES, model_flops
from ..roofline.count import StepCounter
from ..train.optimizer import (OptimizerConfig, adamw_update,
                               init_opt_state)
from . import steps as steps_lib
from .mesh import axis_sizes, data_axes, make_production_mesh
from .sharding import (batch_specs, cache_specs, fsdp_param_specs,
                       opt_specs, param_specs, spec_placements, zeros)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# archs whose fp32 train state needs FSDP param sharding to fit 16 GB/chip
# (the reference's choice, kept so that the spec trees are its own)
FSDP_ARCHS = {"llava_next_34b", "deepseek_moe_16b", "granite_8b"}
# per-device microbatch rows for grad accumulation in train_4k cells
# (n_micro = global_batch / (batch_shards * this))
PER_DEVICE_MICRO = {"llava_next_34b": 1}
DEFAULT_PER_DEVICE_MICRO = 2


@contextlib.contextmanager
def fake_world(size: int):
    """A fake default process group of ``size`` ranks, this process rank
    0, destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _bf16(tree):
    """``tree`` with its floating leaves cast to bf16 (serve cells)."""
    return tree_map(lambda _, t: t.to(torch.bfloat16)
                    if t.dtype.is_floating_point else t, tree)


def _count_params(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree))


def _local_bytes(tree) -> int:
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _batch_axes(mesh, plan: str, batch: int):
    """(axes, shards): the reference's batch-sharding axes, the data axes
    and, under the dp plan, "model" too unless the batch does not divide
    across them all."""
    sizes = axis_sizes(mesh)
    dp = data_axes(mesh) + (("model",) if plan == "dp" else ())
    if batch % math.prod(sizes[a] for a in dp):
        dp = data_axes(mesh)
    return dp, math.prod(sizes[a] for a in dp)


def _train_step(cfg, params, opt, batch, acc_specs, n_micro: int,
                counter: StepCounter):
    """``steps.make_grad_accum_train_step(cfg, n_micro, acc_specs=)``'s
    step, built from its pieces, on a batch that holds ``n_traced`` of
    its ``n_micro`` identical micro-batches: those are run, and counted
    ``n_micro / n_traced`` times."""
    n_traced = next(iter(batch.values())).shape[0]
    gsum = steps_lib.grad_accumulators(params, acc_specs)
    lsum = torch.zeros((), dtype=torch.float32)
    mark = counter.mark()
    for i in range(n_traced):
        lsum = steps_lib.accumulate_micro_batch(
            cfg, params, gsum, lsum, {k: v[i] for k, v in batch.items()})
    counter.repeat(mark, n_micro // n_traced - 1)
    grads = tree_map(lambda _, g: g / n_micro, gsum)
    params, opt, om = adamw_update(OptimizerConfig(), params, grads, opt)
    return params, opt, {"loss": lsum / n_micro, **om}


def _trace(cfg, shape, mesh, plan, arch, n_traced: int = 1):
    """Run one step of the cell under a ``StepCounter``; returns (counter,
    tokens, training, outputs, the seconds spent placing the state before
    the step). A train step runs ``n_traced`` of its ``n_micro``
    micro-batches, its per-micro-batch counts scaled by ``n_micro /
    n_traced``."""
    t0 = time.time()
    dp, bss = _batch_axes(mesh, plan, shape.global_batch)
    dpe = dp if len(dp) > 1 else dp[0]
    pshapes = model_zoo.param_shapes(cfg)
    if shape.kind == "train":
        if plan == "tp" and arch in FSDP_ARCHS:
            pspecs = fsdp_param_specs(pshapes, mesh)
        else:
            pspecs = param_specs(pshapes, mesh, plan)
        zaxes = ("data", "model") if plan in ("dp", "ep") else ("data",)
        mspecs = opt_specs(pspecs, pshapes, mesh, zaxes)
        pdm = PER_DEVICE_MICRO.get(arch, DEFAULT_PER_DEVICE_MICRO)
        n_micro = max(1, shape.global_batch // (bss * pdm))
        mb = shape.global_batch // n_micro
        params = zeros(pshapes, pspecs, mesh)
        where = spec_placements(mspecs, mesh)
        opt = init_opt_state(params, {"mu": where, "nu": where})
        if n_micro % n_traced:
            raise ValueError(f"{n_traced} traced micro-batches do not "
                             f"divide the cell's {n_micro}")
        bshapes = {"tokens": torch.empty((n_traced, mb, shape.seq_len),
                                         dtype=torch.int32),
                   "labels": torch.empty((n_traced, mb, shape.seq_len),
                                         dtype=torch.int32)}
        bspecs = {"tokens": (None, dpe, None), "labels": (None, dpe, None)}
        if cfg.family == "audio":
            bshapes["frames"] = torch.empty(
                (n_traced, mb, cfg.enc_frames, cfg.d_model),
                dtype=torch.bfloat16)
            bspecs["frames"] = (None, dpe, None, None)
        batch = zeros(bshapes, bspecs, mesh)
        counter = StepCounter()
        counter.hold(params, opt, batch)
        placed = time.time() - t0
        with counter:
            out = _train_step(cfg, params, opt, batch, mspecs, n_micro,
                              counter)
        return counter, shape.global_batch * shape.seq_len, True, out, placed
    pspecs = param_specs(pshapes, mesh)
    params = zeros(_bf16(pshapes), pspecs, mesh)
    b = shape.global_batch
    counter = StepCounter()
    if shape.kind == "prefill":
        bshapes = {"tokens": torch.empty((b, shape.seq_len),
                                         dtype=torch.int32)}
        if cfg.family == "audio":
            bshapes["frames"] = torch.empty((b, cfg.enc_frames, cfg.d_model),
                                            dtype=torch.bfloat16)
        batch = zeros(bshapes, batch_specs(cfg, b, mesh, "prefill"), mesh)
        step = steps_lib.make_prefill_step(cfg, shape.seq_len)
        counter.hold(params, batch)
        placed = time.time() - t0
        with torch.no_grad(), counter:
            out = step(params, batch)
        return counter, b * shape.seq_len, False, out, placed
    cshapes = model_zoo.init_cache(cfg, b, shape.seq_len, device="meta")
    cache = zeros(cshapes, cache_specs(cfg, b, mesh, cshapes), mesh)
    toks = zeros(torch.empty((b,), dtype=torch.int32),
                 batch_specs(cfg, b, mesh, "decode"), mesh)
    step = steps_lib.make_decode_step(cfg)
    counter.hold(params, cache, toks)
    placed = time.time() - t0
    with torch.no_grad(), counter:
        out = step(params, cache, toks)
    return counter, b, False, out, placed


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               mesh=None, plan: str = "tp",
               capacity_factor=None, remat_policy=None) -> Dict:
    """Trace one step of the cell and return its record (module
    docstring). Without ``mesh``, on the production mesh of a fake group
    that lives for this call; with one, on it (its group the caller's)."""
    if mesh is None:
        with fake_world(512 if multi_pod else 256):
            return lower_cell(arch, shape_name, multi_pod,
                              make_production_mesh(multi_pod=multi_pod,
                                                   device_type="cpu"),
                              plan, capacity_factor, remat_policy)
    cfg = get_config(arch)
    if capacity_factor is not None:
        cfg = cfg.with_(capacity_factor=capacity_factor)
    if remat_policy is not None:
        cfg = cfg.with_(remat_policy=remat_policy)
    shape = SHAPES[shape_name]
    nchips = mesh.size()
    dp, bss = _batch_axes(mesh, plan, shape.global_batch)
    if cfg.family == "moe":
        cfg = cfg.with_(moe_shards=bss, moe_data_axes=tuple(dp),
                        moe_expert_axis="model")
    t0 = time.time()
    with FakeTensorMode():
        counter, tokens, training, out, t_lower = _trace(cfg, shape, mesh,
                                                         plan, arch)
        out_bytes = _local_bytes(out)
    t_compile = time.time() - t0 - t_lower

    pshapes = model_zoo.param_shapes(cfg)
    n_params = _count_params(pshapes)
    n_active = model_zoo.active_params_count(cfg, pshapes)
    rl, colls = counter.roofline(), counter.collectives()
    mf = model_flops(n_params, tokens, n_active, training)
    # embedding params don't contribute matmul FLOPs; ratio is indicative
    useful = mf / max(rl.flops * nchips, 1.0) if rl.flops else 0.0
    peak = counter.peak_bytes
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": nchips,
        "kind": shape.kind,
        "n_params": n_params, "n_active_params": n_active,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory": {
            "output_bytes_per_device": out_bytes,
            "temp_bytes_per_device": peak - counter.argument_bytes,
            "argument_bytes_per_device": counter.argument_bytes,
            "peak_bytes_per_device": peak,
            "hbm_budget_bytes_per_device": HBM_BYTES,
        },
        "roofline": rl.as_dict(),
        "collectives": {"counts": colls.counts,
                        "bytes": colls.bytes_by_kind},
        "model_flops": mf,
        "useful_flops_ratio": useful,
    }


def run_and_save(arch: str, shape_name: str, multi_pod: bool,
                 out_dir: str, mesh=None, plan: str = "tp",
                 capacity_factor=None, remat_policy=None) -> Optional[Dict]:
    ok, why = cell_status(arch, shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if plan == "tp" else f"__{plan}"
    path = os.path.join(
        out_dir, f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": why}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[skip] {arch} {shape_name} {mesh_name}: {why}")
        return rec
    try:
        rec = lower_cell(arch, shape_name, multi_pod, mesh=mesh,
                         plan=plan, capacity_factor=capacity_factor,
                         remat_policy=remat_policy)
        rec["status"] = "ok"
        rec["plan"] = plan
    except Exception as e:  # a failing cell is a bug — surface it loudly
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": f"FAIL: {e}",
               "traceback": traceback.format_exc()}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if rec["status"] == "ok":
        r = rec["roofline"]
        print(f"[ok]   {arch:22s} {shape_name:12s} {mesh_name:8s} "
              f"trace={rec['compile_s']:6.1f}s "
              f"peak={rec['memory']['peak_bytes_per_device']/2**30:6.2f}"
              f"GiB (of {HBM_BYTES/2**30:.2f}) "
              f"bottleneck={r['bottleneck']:10s} "
              f"(c={r['compute_s']:.3e} m={r['memory_s']:.3e} "
              f"coll={r['collective_s']:.3e})")
    else:
        print(f"[FAIL] {arch} {shape_name} {mesh_name}: "
              f"{rec['status'][:200]}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--plan", default="tp", choices=["tp", "dp", "ep"])
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--remat-policy", default=None,
                    choices=["full", "dots", "mlp"])
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = []
    if args.multi_pod or args.all:
        pods.append(True)
    if args.single_pod or args.all or not pods:
        pods.insert(0, False)

    failures = 0
    for mp in pods:
        for a in archs:
            for s in shapes:
                rec = run_and_save(a, s, mp, args.out, plan=args.plan,
                                   capacity_factor=args.capacity_factor,
                                   remat_policy=args.remat_policy)
                if rec and str(rec.get("status", "")).startswith("FAIL"):
                    failures += 1
    print(f"\ndry-run complete; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
