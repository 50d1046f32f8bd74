"""The port on a mesh, on the CPU: eight gloo processes, twins of the four
tags of tests/test_distributed.py, and the port's own mesh paths.

One subprocess spawns the eight ranks (``torch.multiprocessing``, a
``file://`` rendezvous in the test's tmp_path). The JAX side (the train,
grad-accum and decode steps, the pipeline's oracle and emission order)
is computed here, in the test's process, on the same params and inputs,
and handed to the ranks as npz arrays, so the ranks import no JAX. Tags
and tolerances:
  * TRAIN_OK: olmo_1b smoke (fp32 compute, JAX-initialised params),
    batch 8 x 32 from seed 3, AdamW at lr 1e-3 from step 1. One
    ``make_train_step`` on a 4 x 2 (data, model) mesh, params and ZeRO
    moments DTensors, against JAX's step: every metric within 1e-5
    relative plus 1e-5; params within 1e-5 relative plus 1e-5 (the
    update is lr * g/|g| = 1e-3, checked to be over 50 times that);
    mu and nu within 1e-4 relative plus 1e-8 (the rule of the JAX twins
    in tests/test_torch_train.py). One 2-micro-batch
    ``make_grad_accum_train_step`` with ``acc_specs`` (the params'
    specs) against JAX's: the accumulators keep those placements, its
    metrics (grad_norm is the mean gradient's), params and mu as above.
    bf16 compute: the sharded loss within the reference's 1e-3 of the
    single process's and every gradient leaf within 2e-2 relative RMS
    (measured 1.1e-2). The ssm, hybrid, audio (frames) and vlm (image
    embeddings) smoke configs' loss (1e-5) and gradients (1e-6) on
    4 x 2 against the single process's.
  * PIPELINE_OK: 4 stages (a (rep 2, stage 4) mesh: two pipelines side
    by side), the reference's tanh(x @ w) with w [4,16,16] * 0.5 and x
    [6,3,16] from numpy seeds, equal to the reference's
    ``sequential_reference`` within 1e-5, with and without the order
    ``overlap_schedule([5,1,3,0,4,2])``, which equals the reference's.
  * DECODE_OK: granite_8b smoke, batch 8, cache 64 (16 prompt tokens
    prefilled), one decode step on 4 x 2 (kv heads over "model") and on
    2 x 4 (kv = 2 narrower than the axis: the sequence split over
    "model"), and at batch 1 (the sequence over the data axis too). fp32
    (JAX-initialised params) against JAX's prefill and decode step:
    logits within 1e-4 (the JAX twins'; measured 1.4e-6), the cache
    within 1e-5; bf16 against the port's unsharded step, logits within
    the reference's 5e-2 (measured 3.1e-2); the same argmax in both.
  * SERVE_OK: prefill on the mesh (the cache created there, placed by
    ``cache_specs``, the prompt written into each rank's shard) and one
    decode step on that cache, on 4 x 2, 2 x 4 and 1 x 8, fp32 (JAX-
    initialised params) against JAX's prefill and decode step: logits
    within 1e-4 with the same argmax, every cache leaf placed by the
    specs and within 1e-5 after each. granite_8b smoke at batch 8 (KV
    heads over "model" on 4 x 2, the sequence over "model" on 2 x 4 and
    1 x 8) and 1 (the sequence over the data axis too), mamba2_780m
    smoke with two state groups (the SSD state's heads over "model", each
    rank reading its heads' group), zamba2_1_2b smoke (the shared
    attention's cache) and whisper_base smoke (the cross cache written
    from the encoder; on 1 x 8 its 4 heads are gathered before they
    split).
  * ELASTIC_OK: a Trainer on 4 x 2 trains a step and saves; the
    checkpoint restores onto 2 x 4 bitwise (``checkpoint.restore`` with
    the new mesh's specs), and ``Trainer.maybe_restore`` on a 2 x 4
    trainer resumes from it, bitwise, and trains on.
  * MOE_TRAIN_OK: granite_moe_1b_a400m and deepseek_moe_16b smoke (fp32,
    JAX-initialised params, batch 8 x 32 from seed 3), one
    ``make_train_step`` on 4 x 2 under the tp, ep and FSDP specs
    (``fsdp_param_specs``) with ``moe_shards`` 1 (every rank routes the
    gathered batch) and 4 (each data shard routes its own tokens), and
    under the dp plan with the batch over data and model (the dry-run's
    dp cells) with ``moe_shards`` 1 and 8 (each rank routes its own),
    against JAX's single-device step with the same ``moe_shards``:
    TRAIN_OK's rule for metrics, params and moments, the aux loss within
    1e-6, and each rank's routing
    (``gate_idx``, ``pos``, ``keep`` of every layer, forward and
    recompute) equal to its slice of JAX's (recorded by a
    ``jax.debug.callback`` on the reference's ``_route``). A Trainer on
    4 x 2 trains both archs a step.
  * MOE_DECODE_OK: both MoE smoke archs, batch 8, cache 64 (16 prompt
    tokens prefilled), one decode step on 4 x 2 and on 2 x 4 (fp32, JAX-
    initialised params) against JAX's prefill and decode step: logits
    within 1e-4, the cache within 1e-5, the same argmax.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import mlp as jax_mlp  # noqa: E402
from repro.models import model_zoo as jax_zoo  # noqa: E402
from repro.pipeline import overlap_pipeline as jax_pipe  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import inputs, model_zoo  # noqa: E402
from repro_torch.pipeline import overlap_pipeline as pipe  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READY = [5.0, 1.0, 3.0, 0.0, 4.0, 2.0]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)

SCRIPT = r'''
import os, sys, tempfile
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OUT = sys.argv[1]


def close(a, b, tol):
    return float((a.float() - b.float()).abs().max()) <= tol


def tree_close(got, want, tol, bitwise=False):
    from repro_torch.models.common import tree_get, tree_map
    bad = []

    def one(path, w):
        g = tree_get(got, path)
        ok = torch.equal(g, w) if bitwise else close(g, w, tol)
        if not ok:
            bad.append((path, float((g.float() - w.float()).abs().max())))
    tree_map(one, want)
    assert not bad, bad


def clone(tree):
    from repro_torch.models.common import tree_map
    return tree_map(lambda _, t: t.clone() if isinstance(t, torch.Tensor)
                    else t, tree)


OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)  # the test's OPT


def load_tree(path, prefix, shapes):
    """The tree of ``shapes``' structure whose leaves are the npz arrays
    under ``prefix/`` (written by the test's process)."""
    from repro_torch.models.common import tree_map
    data = np.load(path)
    return tree_map(lambda p, _: torch.from_numpy(data[f"{prefix}/{p}"]),
                    shapes)


def state_close(got, want, p0=None, flat_grads=False):
    """The JAX twins' rule (tests/test_torch_train.py): params within
    1e-5 relative plus 1e-5 (lr 1e-3 moves each weight by about 1e-3:
    Adam's step-1 update is lr * g/(|g| + eps), which ``p0`` shows is
    over 50 times the tolerance), moments within 1e-4 relative plus 1e-8.
    With ``flat_grads``, a param whose JAX gradient (sqrt(nu / (1 - b2))
    at step 1) is not 0 but below 100 eps = 1e-6 is held by its moments
    alone (a zero gradient moves no weight, and is held): there
    the update's slope in g is lr eps / (|g| + eps)^2, up to 2.5e4, so a
    gradient that differs in its last bits (1e-9) moves the weight by
    2.5e-5 (the MoE's rarely routed experts; measured on one element in
    32768, |g| 1e-8, by the port's single-process step as much as by the
    mesh's). Such params must be under 0.1% of each leaf."""
    from repro_torch.models.common import tree_get, tree_map
    bad = []

    def one(path, w):
        g = tree_get(got, path).float()
        rtol, atol = (1e-5, 1e-5) if path.startswith("params") \
            else (1e-4, 1e-8)
        err = (g - w).abs() - rtol * w.abs()
        if flat_grads and path.startswith("params"):
            nu = tree_get(want, "nu" + path[len("params"):])
            g_abs = (nu / (1 - 0.95)).sqrt()
            flat = (g_abs > 0) & (g_abs < 1e-6)
            assert float(flat.float().mean()) < 1e-3, (path, int(flat.sum()))
            err = err.masked_fill(flat, 0.0)
        if float(err.max()) > atol:
            bad.append((path, float(err.max())))
    tree_map(one, want)
    assert not bad, bad
    if p0 is not None:
        moved = max(float((tree_get(want, "params/" + p) - t).abs().max())
                    for p, t in flat(p0).items())
        assert moved > 50 * 1e-5, moved


def metrics_close(got, data, prefix):
    """Every metric JAX's step returned (loss, ce, aux, grad_norm, lr)
    within 1e-5 relative plus 1e-5 of it."""
    keys = [k for k in data.files if k.startswith(prefix + "/")]
    assert keys
    for key in keys:
        want, m = float(data[key]), float(got[key.rsplit("/", 1)[1]])
        assert abs(m - want) <= 1e-5 * (1 + abs(want)), (key, m, want)


def flat(tree):
    from repro_torch.models.common import tree_map
    out = {}
    tree_map(lambda p, t: out.__setitem__(p, t), tree)
    return out


def train_ok(rank):
    """The sharded train and grad-accum steps against JAX's (npz); the
    bf16 step's loss and gradients against the single process's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo
    from repro_torch.models.inputs import make_train_batch
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    mesh = make_host_mesh(data=4, model=2)
    opt = OptimizerConfig(**OPT)
    path = os.path.join(OUT, "train.npz")
    cfg = get_config("olmo_1b", smoke=True).with_(compute_dtype="float32")
    shapes = model_zoo.param_shapes(cfg)
    data = np.load(path)
    params = load_tree(path, "params", shapes)
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
    pspecs = sh.param_specs(params, mesh)
    ospecs = sh.opt_state_specs(pspecs, params, mesh)

    def placed():
        dp = sh.distribute(clone(params), pspecs, mesh)
        return dp, init_opt_state(dp, sh.spec_placements(ospecs, mesh))

    # one train step, fp32, against JAX's
    dp, dopt = placed()
    p2, o2, m2 = steps.make_train_step(cfg, opt)(
        dp, dopt, sh.distribute(batch, sh.batch_specs(cfg, 8, mesh, "train"),
                                mesh))
    metrics_close(m2, data, "metrics")
    state_close({"params": sh.gather(p2), "mu": sh.gather(o2["mu"]),
                 "nu": sh.gather(o2["nu"])},
                {"params": load_tree(path, "want/params", shapes),
                 "mu": load_tree(path, "want/mu", shapes),
                 "nu": load_tree(path, "want/nu", shapes)}, params)
    # two micro-batches accumulated in acc_specs' placements, against
    # JAX's grad-accum step: its grad_norm is the mean gradient's (the
    # update clips it to norm 1, so params and mu alone would not tell a
    # sum from the mean) and mu is (1 - b1) times the clipped mean
    acc = steps.make_grad_accum_train_step(cfg, 2, opt, acc_specs=pspecs)
    micro = {k: v.reshape(2, 4, -1) for k, v in batch.items()}
    import repro_torch.launch.steps as steps_mod
    real, seen = steps_mod.adamw_update, []

    def spy(cfg_, p, g, s):
        from repro_torch.models.common import tree_get, tree_map
        tree_map(lambda path, t: seen.append(
            t.placements == sh.placements(tree_get(pspecs, path), mesh)), g)
        return real(cfg_, p, g, s)
    steps_mod.adamw_update = spy
    try:
        dp, dopt = placed()
        p2, o2, m2 = acc(dp, dopt, sh.distribute(
            micro, {k: (None, ("data",), None) for k in micro}, mesh))
    finally:
        steps_mod.adamw_update = real
    assert seen and all(seen), seen
    metrics_close(m2, data, "acc_metrics")  # grad_norm: the mean gradient's
    state_close({"params": sh.gather(p2), "mu": sh.gather(o2["mu"])},
                {"params": load_tree(path, "acc/params", shapes),
                 "mu": load_tree(path, "acc/mu", shapes)}, params)
    # bf16 compute (the reference's dtype): the sharded loss within the
    # reference's 1e-3 of the single process's and every gradient leaf
    # within 2e-2 relative RMS (bf16 products summed in another order;
    # the update itself is fp32 and held above)
    bcfg = cfg.with_(compute_dtype="bfloat16")
    l1, _, g1 = steps.value_and_grad(bcfg, params, batch)
    l2, _, g2 = steps.value_and_grad(
        bcfg, sh.distribute(params, pspecs, mesh),
        sh.distribute(batch, sh.batch_specs(cfg, 8, mesh, "train"), mesh))
    assert abs(float(l1) - float(l2)) <= 1e-3, (float(l1), float(l2))
    g2 = flat(sh.gather(g2))
    worst = max(float((g2[p] - w).norm() / w.norm().clamp_min(1e-30))
                for p, w in flat(g1).items() if w.abs().max() > 0)
    assert worst <= 2e-2, worst
    if rank == 0:
        print(f"bf16 gradients: worst leaf relative RMS {worst:.2e}",
              flush=True)
    # the other families: the ssm and hybrid blocks (the SSD scan behind
    # local_map), the encoder-decoder (frames; cross-attention) and the
    # vlm (image embeddings, sharded as the batch): loss and gradients of
    # the sharded step against the single process's
    for arch in ("mamba2_780m", "zamba2_1_2b", "whisper_base",
                 "llava_next_34b"):
        cfg = get_config(arch, smoke=True).with_(compute_dtype="float32")
        params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
        batch = make_train_batch(cfg, 8, 32, seed=3)
        bspecs = sh.batch_specs(cfg, 8, mesh, "train")
        if cfg.family == "vlm":
            batch["extra_embeds"] = torch.from_numpy(
                np.random.RandomState(4).randn(8, cfg.img_tokens, cfg.d_model)
                .astype(np.float32))
            bspecs["extra_embeds"] = (bspecs["tokens"][0], None, None)
        l1, _, g1 = steps.value_and_grad(cfg, params, batch)
        l2, _, g2 = steps.value_and_grad(
            cfg, sh.distribute(params, sh.param_specs(params, mesh), mesh),
            sh.distribute(batch, bspecs, mesh))
        assert abs(float(l1) - float(l2)) <= 1e-5, (arch, l1, l2)
        tree_close(sh.gather(g2), g1, 1e-6)
    if rank == 0:
        print("TRAIN_OK", flush=True)


def pipeline_ok(rank):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.pipeline.overlap_pipeline import (
        overlap_schedule, pipeline_forward, sequential_reference)
    data = np.load(os.path.join(OUT, "pipeline.npz"))
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("rep", "stage"))

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"])
    sp = {"w": torch.from_numpy(data["w"])}
    x = torch.from_numpy(data["x"])
    want = torch.from_numpy(data["want"])
    order = overlap_schedule(data["ready"])
    assert np.array_equal(order, data["order"]), (order, data["order"])
    y = pipeline_forward(stage_fn, sp, x, mesh, axis="stage")
    y2 = pipeline_forward(stage_fn, sp, x, mesh, axis="stage", order=order)
    for got in (y, y2, sequential_reference(stage_fn, sp, x)):
        assert close(got, want, 1e-5), float((got - want).abs().max())
    if rank == 0:
        print("PIPELINE_OK", flush=True)


def decode_ok(rank):
    """One sharded decode step after an unsharded prefill: fp32 against
    JAX's step on the same params and prompt (npz), bf16 against the
    single process's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo
    path = os.path.join(OUT, "decode.npz")
    data = np.load(path)
    for shape in ((4, 2), (2, 4)):
        mesh = make_host_mesh(data=shape[0], model=shape[1])
        for dt, b in (("float32", 8), ("bfloat16", 8), ("float32", 1)):
            cfg = get_config("granite_8b", smoke=True).with_(
                compute_dtype=dt)
            params = load_tree(path, "params", model_zoo.param_shapes(cfg))
            prompt = torch.from_numpy(data[f"b{b}/prompt"])
            toks = torch.from_numpy(data[f"b{b}/tokens"])
            step = steps.make_decode_step(cfg)
            with torch.no_grad():
                _, cache = model_zoo.prefill(cfg, params, prompt, 64)
                cspecs = sh.cache_specs(cfg, b, mesh, cache)
                dcache = sh.distribute(clone(cache), cspecs, mesh)
                l2, c2 = step(
                    sh.distribute(params, sh.param_specs(params, mesh),
                                  mesh), dcache,
                    sh.distribute(toks, sh.batch_specs(cfg, b, mesh,
                                                       "decode"), mesh))
                if dt == "bfloat16":    # the reference's bf16 tolerance
                    want, _ = step(params, cache, toks)
                    tol = 5e-2
                else:                   # the JAX twins' fp32 tolerance
                    want = torch.from_numpy(data[f"b{b}/logits"])
                    tol = 1e-4
            l2 = l2.full_tensor()
            err = float((l2.float() - want.float()).abs().max())
            assert err <= tol, (shape, dt, b, err)
            assert torch.equal(l2.float().argmax(-1), want.float().argmax(-1))
            assert c2["pos"] == 17
            if dt == "float32":
                got = sh.gather(c2["layers"])
                for name in ("k", "v"):
                    w = torch.from_numpy(data[f"b{b}/cache/{name}"])
                    assert close(got[name], w, 1e-5), (shape, b, name)
            if rank == 0:
                print(f"decode {shape} {dt} batch {b}: cache spec "
                      f"{cspecs['layers']['k']}, logits max err {err:.2e}",
                      flush=True)
    if rank == 0:
        print("DECODE_OK", flush=True)


SERVE = %r


def serve_close(logits, cache, data, prefix, specs):
    """Logits within 1e-4 of JAX's (npz, under ``prefix``) with the same
    argmax; every cache leaf placed by ``specs`` and, gathered, within
    1e-5 of JAX's; the same position."""
    from repro_torch.launch import sharding as sh
    from repro_torch.models.common import tree_get
    want = torch.from_numpy(data[f"{prefix}/logits"])
    got = logits.full_tensor()
    err = float((got - want).abs().max())
    assert err <= 1e-4, (prefix, err)
    assert torch.equal(got.argmax(-1), want.argmax(-1)), prefix
    head = f"{prefix}/cache/"
    leaves = flat(cache)
    assert set(leaves) == {k[len(head):] for k in data.files
                           if k.startswith(head)}, prefix
    for key, t in leaves.items():
        w = data[head + key]
        if key == "pos":
            assert int(t) == int(w), (prefix, int(t), int(w))
            continue
        assert t.placements == sh.placements(tree_get(specs, key),
                                             t.device_mesh), (prefix, key)
        assert close(t.full_tensor(), torch.from_numpy(w), 1e-5), (
            prefix, key, float((t.full_tensor() - torch.from_numpy(w))
                               .abs().max()))
    return err


def serve_ok(rank):
    """Prefill on the mesh into a cache placed by the cache specs, then
    one decode step on it, fp32, against JAX's prefill and decode step
    (npz) on 4 x 2 and 2 x 4: the dense arch at batch 8 (KV heads over
    "model" on 4 x 2, the sequence over "model" on 2 x 4) and batch 1
    (the sequence over the data axis too), the ssm and hybrid archs (SSD
    state heads over "model"; the hybrid's shared-attention cache) and
    the audio arch (the cross cache written from the encoder)."""
    from torch.distributed.tensor import Shard
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo
    path = os.path.join(OUT, "serve.npz")
    data = np.load(path)
    for shape in ((4, 2), (2, 4), (1, 8)):
        mesh = make_host_mesh(data=shape[0], model=shape[1])
        for arch, batches in SERVE.items():
            cfg = get_config(arch, smoke=True).with_(compute_dtype="float32")
            if arch in SERVE_GROUPS:
                cfg = cfg.with_(ssm_groups=SERVE_GROUPS[arch])
            params = load_tree(path, f"{arch}/params",
                               model_zoo.param_shapes(cfg))
            dparams = sh.distribute(params, sh.param_specs(params, mesh),
                                    mesh)
            for b in batches:
                pre = f"{arch}/b{b}"
                batch = {"tokens": torch.from_numpy(data[f"{pre}/prompt"])}
                if f"{pre}/frames" in data.files:
                    batch["frames"] = torch.from_numpy(data[f"{pre}/frames"])
                toks = torch.from_numpy(data[f"{pre}/tokens"])
                with torch.no_grad():
                    logits, cache = steps.make_prefill_step(cfg, 64)(
                        dparams, sh.distribute(batch, sh.batch_specs(
                            cfg, b, mesh, "prefill"), mesh))
                    specs = sh.cache_specs(cfg, b, mesh, cache)
                    e1 = serve_close(logits, cache, data, f"{pre}/prefill",
                                     specs)
                    logits, cache = steps.make_decode_step(cfg)(
                        dparams, cache, sh.distribute(toks, sh.batch_specs(
                            cfg, b, mesh, "decode"), mesh))
                    e2 = serve_close(logits, cache, data, f"{pre}/decode",
                                     specs)
                if arch == "granite_8b":     # the split-KV cache is tested
                    seq = cache["layers"]["k"].placements
                    assert (Shard(2) in seq) == (shape != (4, 2) or b == 1)
                if rank == 0:
                    kv = next(cache[k] for k in ("attn", "self", "layers")
                              if k in cache)
                    print(f"serve {shape} {arch} batch {b}: logits max err "
                          f"prefill {e1:.2e}, decode {e2:.2e}; "
                          f"{sorted(kv)[0]} placed "
                          f"{kv[sorted(kv)[0]].placements}", flush=True)
    if rank == 0:
        print("SERVE_OK", flush=True)


def elastic_ok(rank):
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("olmo_1b", smoke=True).with_(compute_dtype="float32")
    d = os.path.join(OUT, "ckpt")

    def trainer(mesh, n):
        return Trainer(cfg, OptimizerConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=4),
                       TrainerConfig(steps=n, ckpt_dir=d, ckpt_every=1,
                                     log_every=1),
                       DataConfig(batch=8, seq=16), device="cpu", mesh=mesh)
    mesh_a = make_host_mesh(data=4, model=2)
    mesh_b = make_host_mesh(data=2, model=4)
    ta = trainer(mesh_a, 1)
    ta.run()
    saved = {"params": sh.gather(ta.final_state[0]),
             "opt": sh.gather(ta.final_state[1])}
    tb = trainer(mesh_b, 2)
    pshapes = model_zoo.param_shapes(cfg)
    res = ckpt.restore(d, {"params": pshapes,
                           "opt": steps.opt_state_shapes(cfg)},
                       device="cpu", mesh=mesh_b,
                       specs={"params": tb.pspecs, "opt": tb.ospecs})
    assert res is not None and res[0] == 1 and res[2]["mesh"] == [4, 2]
    for name in ("params", "opt"):
        tree_close(sh.gather(res[1][name]), saved[name], 0, bitwise=True)
    p = res[1]["params"]["layers"]["attn"]["wq"]
    assert p.placements == sh.placements(
        tb.pspecs["layers"]["attn"]["wq"], mesh_b)
    restored = tb.maybe_restore()
    assert tb.step == 1
    tree_close(sh.gather(restored[0]), saved["params"], 0, bitwise=True)
    tb.run()
    assert tb.step == 2 and ckpt.latest_step(d) == 2
    if rank == 0:
        print("ELASTIC_OK", flush=True)


MOE = ("granite_moe_1b_a400m", "deepseek_moe_16b")


# (plan, moe_shards) of MOE_TRAIN_OK: "fsdp" is the tp specs
# ZeRO-extended over "data" (``fsdp_param_specs``); under "dp" the batch
# is split over data and model (the dry-run's dp cells), so 8 shards
# route their own rows and 1 routes the gathered batch
MOE_CASES = (("tp", 1), ("tp", 4), ("ep", 1), ("ep", 4), ("fsdp", 1),
             ("fsdp", 4), ("dp", 1), ("dp", 8))


def moe_train_ok(rank):
    """The MoE train step on 4 x 2 for each (plan, moe_shards) of
    MOE_CASES against JAX's single-device step with the same moe_shards
    (npz): state, metrics, aux and each rank's routing; then a Trainer
    step of each arch on the mesh."""
    import repro_torch.models.mlp as mlp_mod
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.trainer import Trainer, TrainerConfig
    mesh = make_host_mesh(data=4, model=2)
    di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    opt = OptimizerConfig(**OPT)
    path = os.path.join(OUT, "moe_train.npz")
    data = np.load(path)
    real, seen = mlp_mod._route, []

    def spy(cfg, params, xt):
        out = real(cfg, params, xt)
        seen.append([t.to_local() if hasattr(t, "to_local") else t
                     for t in out[2:5]])
        return out
    mlp_mod._route = spy
    try:
        for arch in MOE:
            shapes = model_zoo.param_shapes(get_config(arch, smoke=True))
            params = load_tree(path, f"{arch}/params", shapes)
            batch = {k: torch.from_numpy(data[k])
                     for k in ("tokens", "labels")}
            for plan, ns in MOE_CASES:
                cfg = get_config(arch, smoke=True).with_(
                    compute_dtype="float32", moe_shards=ns)
                pre = f"{arch}/ns{ns}"
                if plan == "fsdp":
                    pspecs = sh.fsdp_param_specs(params, mesh)
                else:
                    pspecs = sh.param_specs(params, mesh, plan)
                if plan == "dp":
                    bspecs = {k: (("data", "model"), None) for k in batch}
                    shard, parts = di * 2 + mi, 8
                else:
                    bspecs = sh.batch_specs(cfg, 8, mesh, "train")
                    shard, parts = di, 4
                ospecs = sh.opt_state_specs(pspecs, params, mesh)
                dp = sh.distribute(clone(params), pspecs, mesh)
                dopt = init_opt_state(dp, sh.spec_placements(ospecs, mesh))
                seen.clear()
                p2, o2, m2 = steps.make_train_step(cfg, opt)(
                    dp, dopt, sh.distribute(batch, bspecs, mesh))
                metrics_close(m2, data, f"{pre}/metrics")
                want_aux = float(data[f"{pre}/metrics/aux"])
                assert abs(float(m2["aux"]) - want_aux) <= 1e-6, (
                    arch, ns, plan, float(m2["aux"]), want_aux)
                state_close(
                    {"params": sh.gather(p2), "mu": sh.gather(o2["mu"]),
                     "nu": sh.gather(o2["nu"])},
                    {"params": load_tree(path, f"{pre}/want/params", shapes),
                     "mu": load_tree(path, f"{pre}/want/mu", shapes),
                     "nu": load_tree(path, f"{pre}/want/nu", shapes)},
                    params, flat_grads=True)
                # the forward, then the backward's recompute of every
                # layer (last layer first); when the routing shards are a
                # multiple of the batch's, each batch shard routes its
                # own, else every rank routes all tokens
                layers = list(range(cfg.n_layers))
                layers += layers[::-1]
                assert len(seen) == len(layers), len(seen)
                own = ns // parts if ns % parts == 0 else 0
                for layer, got in zip(layers, seen):
                    for name, g in zip(("gate_idx", "pos", "keep"), got):
                        w = data[f"{pre}/route/{layer}/{name}"]
                        if own:
                            w = w[shard * own:(shard + 1) * own]
                        assert np.array_equal(g.numpy(), w), (
                            arch, ns, plan, layer, name)
                if rank == 0:
                    print(f"moe {arch} moe_shards {ns} plan {plan}: "
                          f"aux {float(m2['aux']):.9f} (JAX "
                          f"{want_aux:.9f})", flush=True)
    finally:
        mlp_mod._route = real
    for arch in MOE:
        cfg = get_config(arch, smoke=True)
        tr = Trainer(cfg, OptimizerConfig(lr=1e-3, warmup_steps=1,
                                          total_steps=2),
                     TrainerConfig(steps=1, log_every=1),
                     DataConfig(batch=8, seq=16), device="cpu", mesh=mesh)
        out = tr.run()
        assert np.isfinite(out["loss"]) and out["aux"] > 0, out
    if rank == 0:
        print("MOE_TRAIN_OK", flush=True)


def moe_decode_ok(rank):
    """One sharded MoE decode step after an unsharded prefill, fp32,
    against JAX's (npz), on 4 x 2 and 2 x 4."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo
    path = os.path.join(OUT, "moe_decode.npz")
    data = np.load(path)
    for shape in ((4, 2), (2, 4)):
        mesh = make_host_mesh(data=shape[0], model=shape[1])
        for arch in MOE:
            cfg = get_config(arch, smoke=True).with_(compute_dtype="float32")
            params = load_tree(path, f"{arch}/params",
                               model_zoo.param_shapes(cfg))
            prompt = torch.from_numpy(data["prompt"])
            toks = torch.from_numpy(data["tokens"])
            with torch.no_grad():
                _, cache = model_zoo.prefill(cfg, params, prompt, 64)
                cspecs = sh.cache_specs(cfg, 8, mesh, cache)
                logits, c2 = steps.make_decode_step(cfg)(
                    sh.distribute(params, sh.param_specs(params, mesh),
                                  mesh),
                    sh.distribute(clone(cache), cspecs, mesh),
                    sh.distribute(toks, sh.batch_specs(cfg, 8, mesh,
                                                       "decode"), mesh))
            want = torch.from_numpy(data[f"{arch}/logits"])
            logits = logits.full_tensor()
            err = float((logits - want).abs().max())
            assert err <= 1e-4, (shape, arch, err)
            assert torch.equal(logits.argmax(-1), want.argmax(-1))
            got = sh.gather(c2["layers"])
            for name in ("k", "v"):
                w = torch.from_numpy(data[f"{arch}/cache/{name}"])
                assert close(got[name], w, 1e-5), (shape, arch, name)
            if rank == 0:
                print(f"moe decode {shape} {arch}: logits max err "
                      f"{err:.2e}", flush=True)
    if rank == 0:
        print("MOE_DECODE_OK", flush=True)


def run(rank, world, init):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        for check in (train_ok, pipeline_ok, decode_ok, serve_ok,
                      elastic_ok, moe_train_ok, moe_decode_ok):
            check(rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(8, "file://" + os.path.join(OUT, "rendezvous")),
             nprocs=8)
'''


def _pipeline_oracle(path):
    """The reference's stage_fn, weights and microbatches (numpy seeds),
    its sequential_reference and its overlap_schedule order."""
    w = (np.random.RandomState(1).randn(4, 16, 16) * 0.5).astype(np.float32)
    x = np.random.RandomState(2).randn(6, 3, 16).astype(np.float32)

    def stage_fn(p, a):
        return jnp.tanh(a @ p["w"])
    want = jax_pipe.sequential_reference(stage_fn, {"w": jnp.asarray(w)},
                                         jnp.asarray(x))
    np.savez(path, w=w, x=x, want=np.asarray(want), ready=np.array(READY),
             order=jax_pipe.overlap_schedule(np.array(READY)))


def _flat_jax(prefix, tree):
    return {prefix + "/" + "/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_params(arch, seed):
    jcfg = jax_configs.get_config(arch, smoke=True).with_(
        compute_dtype="float32")
    return jcfg, jax.jit(lambda k: jax_zoo.init_params(jcfg, k))(
        jax.random.PRNGKey(seed))


def _train_oracle(path):
    """JAX's train and 2-micro-batch grad-accum steps on olmo_1b smoke
    (fp32, lr 1e-3 from step 1) from JAX-initialised params, on the
    port's batch 8 x 32 from seed 3."""
    jcfg, jparams = _jax_params("olmo_1b", 0)
    cfg = configs.get_config("olmo_1b", smoke=True)
    batch = {k: v.numpy() for k, v in
             inputs.make_train_batch(cfg, 8, 32, seed=3).items()}
    opt = jax_opt.OptimizerConfig(**OPT)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    p, o, m = jax.jit(jax_steps.make_train_step(jcfg, opt))(
        jparams, jax_opt.init_opt_state(jparams), jb)
    micro = {k: v.reshape(2, 4, -1) for k, v in jb.items()}
    pa, oa, ma = jax.jit(jax_steps.make_grad_accum_train_step(
        jcfg, 2, opt))(jparams, jax_opt.init_opt_state(jparams), micro)
    np.savez(path, **batch, **_flat_jax("params", jparams),
             **_flat_jax("want/params", p), **_flat_jax("want/mu", o["mu"]),
             **_flat_jax("want/nu", o["nu"]),
             **{f"metrics/{k}": np.asarray(v) for k, v in m.items()},
             **_flat_jax("acc/params", pa), **_flat_jax("acc/mu", oa["mu"]),
             **{f"acc_metrics/{k}": np.asarray(v) for k, v in ma.items()})


def _decode_oracle(path):
    """JAX's fp32 granite_8b smoke prefill of 16 tokens into a 64-slot
    cache and one decode step, at batch 8 and 1: logits and cache."""
    jcfg, jparams = _jax_params("granite_8b", 5)
    out = _flat_jax("params", jparams)
    for b in (8, 1):
        prompt = np.random.RandomState(7).randint(
            0, jcfg.vocab, (b, 16)).astype(np.int32)
        toks = (np.arange(b) % jcfg.vocab).astype(np.int32)
        _, jc = jax_zoo.prefill(jcfg, jparams, jnp.asarray(prompt), 64)
        logits, jc = jax_zoo.decode_step(jcfg, jparams, jc,
                                         jnp.asarray(toks))
        out.update({f"b{b}/prompt": prompt, f"b{b}/tokens": toks,
                    f"b{b}/logits": np.asarray(logits),
                    f"b{b}/cache/k": np.asarray(jc["layers"]["k"]),
                    f"b{b}/cache/v": np.asarray(jc["layers"]["v"])})
    np.savez(path, **out)


# arch -> the batches its prefill and decode run at on the mesh
SERVE = {"granite_8b": (8, 1), "mamba2_780m": (8,), "zamba2_1_2b": (8,),
         "whisper_base": (8,)}
# mamba2 with two state groups: a rank's heads read their own group's
# B and C (one group, as the registry's, reads the same for every head)
SERVE_GROUPS = {"mamba2_780m": 2}


def _serve_oracle(path):
    """JAX's fp32 prefill of 16 tokens (whisper: and frames) into a
    64-slot cache and one decode step after it, for each arch and batch
    of SERVE: the logits and every cache leaf after each."""
    out = {}
    for arch, batches in SERVE.items():
        jcfg = jax_configs.get_config(arch, smoke=True).with_(
            compute_dtype="float32")
        if arch in SERVE_GROUPS:
            jcfg = jcfg.with_(ssm_groups=SERVE_GROUPS[arch])
        jparams = jax.jit(lambda k: jax_zoo.init_params(jcfg, k))(
            jax.random.PRNGKey(5))
        out.update(_flat_jax(f"{arch}/params", jparams))
        for b in batches:
            rs = np.random.RandomState(7)
            pre = f"{arch}/b{b}"
            prompt = rs.randint(0, jcfg.vocab, (b, 16)).astype(np.int32)
            toks = (np.arange(b) % jcfg.vocab).astype(np.int32)
            out.update({f"{pre}/prompt": prompt, f"{pre}/tokens": toks})
            frames = None
            if jcfg.family == "audio":
                out[f"{pre}/frames"] = rs.randn(
                    b, jcfg.enc_frames, jcfg.d_model).astype(np.float32)
                frames = jnp.asarray(out[f"{pre}/frames"])
            logits, jc = jax_zoo.prefill(jcfg, jparams, jnp.asarray(prompt),
                                         64, frames=frames)
            out.update({f"{pre}/prefill/logits": np.asarray(logits),
                        **_flat_jax(f"{pre}/prefill/cache", jc)})
            logits, jc = jax_zoo.decode_step(jcfg, jparams, jc,
                                             jnp.asarray(toks))
            out.update({f"{pre}/decode/logits": np.asarray(logits),
                        **_flat_jax(f"{pre}/decode/cache", jc)})
    np.savez(path, **out)


MOE = ("granite_moe_1b_a400m", "deepseek_moe_16b")


def _jax_routes(jcfg, jparams, jb):
    """(gate_idx, pos, keep) of every layer of JAX's forward, from a
    ``jax.debug.callback`` on the reference's ``_route``, in layer
    order."""
    real, seen = jax_mlp._route, []

    def spy(cfg, params, xt):
        out = real(cfg, params, xt)
        jax.debug.callback(lambda *a: seen.append([np.asarray(t) for t in a]),
                           *out[2:5], ordered=True)
        return out
    jax_mlp._route = spy
    try:
        jax.block_until_ready(jax.jit(
            lambda p, b: jax_zoo.loss_fn(jcfg, p, b))(jparams, jb))
        jax.effects_barrier()
    finally:
        jax_mlp._route = real
    assert len(seen) == jcfg.n_layers, len(seen)
    return seen


def _moe_train_oracle(path):
    """JAX's fp32 train step of both MoE smoke archs with moe_shards 1,
    4 and 8 from JAX-initialised params, on the port's batch 8 x 32 from
    seed 3, and the routing of its forward."""
    batch = {k: v.numpy() for k, v in inputs.make_train_batch(
        configs.get_config(MOE[0], smoke=True), 8, 32, seed=3).items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = jax_opt.OptimizerConfig(**OPT)
    out = dict(batch)
    for arch in MOE:
        jcfg, jparams = _jax_params(arch, 0)
        out.update(_flat_jax(f"{arch}/params", jparams))
        for ns in (1, 4, 8):
            c = jcfg.with_(moe_shards=ns)
            p, o, m = jax.jit(jax_steps.make_train_step(c, opt))(
                jparams, jax_opt.init_opt_state(jparams), jb)
            pre = f"{arch}/ns{ns}"
            out.update({**_flat_jax(f"{pre}/want/params", p),
                        **_flat_jax(f"{pre}/want/mu", o["mu"]),
                        **_flat_jax(f"{pre}/want/nu", o["nu"]),
                        **{f"{pre}/metrics/{k}": np.asarray(v)
                           for k, v in m.items()}})
            for layer, route in enumerate(_jax_routes(c, jparams, jb)):
                for name, a in zip(("gate_idx", "pos", "keep"), route):
                    out[f"{pre}/route/{layer}/{name}"] = a
    np.savez(path, **out)


def _moe_decode_oracle(path):
    """JAX's fp32 prefill of 16 tokens into a 64-slot cache and one
    decode step at batch 8 for both MoE smoke archs."""
    prompt = np.random.RandomState(7).randint(0, 256, (8, 16)).astype(
        np.int32)
    toks = np.arange(8).astype(np.int32)
    out = {"prompt": prompt, "tokens": toks}
    for arch in MOE:
        jcfg, jparams = _jax_params(arch, 5)
        _, jc = jax_zoo.prefill(jcfg, jparams, jnp.asarray(prompt), 64)
        logits, jc = jax_zoo.decode_step(jcfg, jparams, jc,
                                         jnp.asarray(toks))
        out.update({**_flat_jax(f"{arch}/params", jparams),
                    f"{arch}/logits": np.asarray(logits),
                    f"{arch}/cache/k": np.asarray(jc["layers"]["k"]),
                    f"{arch}/cache/v": np.asarray(jc["layers"]["v"])})
    np.savez(path, **out)


def test_overlap_schedule_equals_reference():
    """The port's overlap_schedule is the reference's stable argsort; the
    reference also calls transform_schedule and discards its result,
    which the port does not copy (ROADMAP Queue 3)."""
    for ready in (READY, [0.0] * 5, [3.0, 3.0, 1.0, 2.0, 1.0],
                  np.random.RandomState(0).rand(17).tolist()):
        assert np.array_equal(pipe.overlap_schedule(ready),
                              jax_pipe.overlap_schedule(np.array(ready)))


def test_train_launcher_under_torchrun(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.train --model-parallel 2 --device cpu``: two gloo
    ranks on a (1, 2) mesh train and checkpoint; the checkpoint restores
    without a mesh, at its step."""
    d = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--model-parallel", "2", "--device", "cpu", "--steps", "2",
         "--batch", "4", "--seq", "16", "--ckpt", d],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "'mesh': [1, 2]" in r.stdout, r.stdout
    res = ckpt.restore(d, {"params": model_zoo.param_shapes(
        configs.get_config("olmo_1b", smoke=True))})
    assert res is not None and res[0] == 2 and res[2]["mesh"] == [1, 2]


@pytest.mark.parametrize("arch", MOE)
def test_moe_train_launcher_under_torchrun(tmp_path, arch):
    """``launch.train --arch <moe> --model-parallel 2`` under torchrun:
    two gloo ranks train the MoE smoke config on a (1, 2) mesh (its
    experts sharded over "model") and checkpoint."""
    d = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", arch, "--model-parallel", "2", "--device", "cpu",
         "--steps", "2", "--batch", "4", "--seq", "16", "--ckpt", d],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "'mesh': [1, 2]" in r.stdout and "'aux'" in r.stdout, r.stdout
    assert ckpt.latest_step(d) == 2


def test_distributed_parity(tmp_path):
    _pipeline_oracle(tmp_path / "pipeline.npz")
    _train_oracle(tmp_path / "train.npz")
    _decode_oracle(tmp_path / "decode.npz")
    _serve_oracle(tmp_path / "serve.npz")
    _moe_train_oracle(tmp_path / "moe_train.npz")
    _moe_decode_oracle(tmp_path / "moe_decode.npz")
    script = tmp_path / "ranks.py"
    script.write_text(SCRIPT.replace(
        "SERVE = %r", f"SERVE = {SERVE!r}\nSERVE_GROUPS = {SERVE_GROUPS!r}"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, str(script), str(tmp_path)],
                       env=env, capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    for tag in ("TRAIN_OK", "PIPELINE_OK", "DECODE_OK", "SERVE_OK",
                "ELASTIC_OK", "MOE_TRAIN_OK", "MOE_DECODE_OK"):
        assert tag in r.stdout, (tag, r.stdout, r.stderr[-2000:])
