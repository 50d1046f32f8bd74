"""The port's dry-run (``repro_torch.launch.dryrun``) and its counters
(``repro_torch.roofline``) against the reference's, on the CPU.

  * FLOPs: for the smoke config of each family (dense, moe, ssm, hybrid,
    audio, vlm), one train step, one prefill and one decode step at batch
    2 x 32 tokens on one device. ``StepCounter``'s FLOPs (the
    matmul-class formulas of ``torch.utils.flop_counter``) against
    ``repro.roofline.hlo_cost.analyze`` of the reference's compiled step
    on the same shapes: within 2% for prefill and decode, 5% for train.
    Two corrections to the reference's count, each exact where it
    applies:
      - hybrid: ``hlo_cost`` reads only the first branch of a
        ``conditional`` (its regex stops at the first comma of
        ``branch_computations``), the skipping branch of the shared
        block's ``lax.cond``; the count taken with the firing branch
        instead, weighted by the share of layers where the block fires
        (one in attn_every), is added (ROADMAP Queue 3).
      - audio prefill: the reference unembeds every position of the
        prompt and keeps the last; the port unembeds the last only. The
        other positions' 2 B (S - 1) D Vp are taken off (its second
        encoder pass is common-subexpression eliminated by XLA).
    Measured, after them: every pair equal but three. Above 1%, op by op:
      - moe train (deepseek_moe_16b): +1.37%, two aten.mm of [64, 64] .
        [64, 64] more in the port's step, one per layer: the shape of
        the attention projections and of the shared expert's products at
        these widths; one of them, recomputed by the port's remat, is
        not run by XLA's compiled step.
      - hybrid train (zamba2_1_2b): -2.12%, the reference's count holds
        two [64, 128] . [128, 64] products, two of result [64, 128] with
        K 16 and four of result [32, 16] with K 16 more than the port's,
        from the remat of the shared block's conditional, whose count
        the correction above only estimates.
    ssm train is -0.14%.
  * The counts of the record: ``n_params`` and ``model_flops`` of every
    full config equal the reference dry-run's; ``n_active_params`` too,
    except deepseek_moe_16b, where the port counts the shared experts in
    full (ROADMAP Queue 3) and the reference scales them by top_k /
    n_experts.
  * Fake meshes (a subprocess, so that no fake process group can leak):
    on 4 x 2 and on the production 2 x 16 x 16, smoke configs at reduced
    shapes (on 2 x 16 x 16 the model axis outnumbers the smoke configs'
    heads); every cell kind traces, collectives > 0 under tp; the skip
    accounting of ``run_and_save``; under ep no all-gather of a MoE train
    cell returns a routed expert weight [E, D, F], and the MoE layers'
    all-gathers move fewer bytes than the expert weights (the experts are
    never gathered); a fully traced 2-micro-batch step counts the FLOPs, bytes
    and collectives of one traced micro-batch scaled by 2, and its peak
    within 0.1%; no kernel launch counter moves; no
    default process group is left behind.
"""
import json
import os
import re
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
from repro.models import model_zoo as jax_zoo  # noqa: E402
from repro.roofline import analysis as jax_analysis  # noqa: E402
from repro.roofline import hlo_cost  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402
from repro_torch.roofline.count import StepCounter  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_opt_state)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {"dense": "granite_8b", "moe": "deepseek_moe_16b",
            "ssm": "mamba2_780m", "hybrid": "zamba2_1_2b",
            "audio": "whisper_base", "vlm": "llava_next_34b"}
B, S, MAX_SEQ = 2, 32, 48
TOL = {"train": 0.05, "prefill": 0.02, "decode": 0.02}


def _inputs(cfg, seed=0):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        out["frames"] = rs.randn(B, cfg.enc_frames, cfg.d_model).astype(
            np.float32)
    return out


def _jax_flops(arch, kind):
    """hlo_cost's FLOPs of the reference's compiled step."""
    jcfg = jax_configs.get_config(arch, smoke=True)
    params = jax.eval_shape(lambda: jax_zoo.init_params(
        jcfg, jax.random.PRNGKey(0)))
    data = {k: jnp.asarray(v) for k, v in _inputs(jcfg).items()}
    if kind == "train":
        step = jax_steps.make_train_step(jcfg, jax_opt.OptimizerConfig())
        args = (params, jax.eval_shape(jax_opt.init_opt_state, params),
                {k: v for k, v in data.items()})
    elif kind == "prefill":
        step = jax_steps.make_prefill_step(jcfg, MAX_SEQ)
        args = (params, {k: v for k, v in data.items() if k != "labels"})
    else:
        step = jax_steps.make_decode_step(jcfg)
        cache = jax.eval_shape(lambda: jax_zoo.init_cache(jcfg, B, MAX_SEQ))
        args = (params, cache, data["tokens"][:, 0])
    text = jax.jit(step).lower(*args).compile().as_text()
    flops = hlo_cost.analyze(text).flops
    if jcfg.family == "hybrid":     # the firing branch of each cond too
        fired = hlo_cost.analyze(re.sub(
            r"branch_computations=\{([^,}]*), ([^}]*)\}",
            r"branch_computations={\2}", text)).flops
        flops += (fired - flops) / jcfg.attn_every
    if jcfg.family == "audio" and kind == "prefill":
        flops -= 2 * B * (S - 1) * jcfg.d_model * jcfg.padded_vocab
    return flops


def _port_flops(arch, kind):
    """StepCounter's FLOPs of the port's step on one device."""
    cfg = configs.get_config(arch, smoke=True)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    data = {k: torch.from_numpy(v) for k, v in _inputs(cfg).items()}
    counter = StepCounter()
    if kind == "train":
        step = steps.make_train_step(cfg, OptimizerConfig())
        opt = init_opt_state(params)
        with counter:
            step(params, opt, data)
    elif kind == "prefill":
        step = steps.make_prefill_step(cfg, MAX_SEQ)
        with torch.no_grad(), counter:
            step(params, {k: v for k, v in data.items() if k != "labels"})
    else:
        cache = model_zoo.init_cache(cfg, B, MAX_SEQ)
        with torch.no_grad(), counter:
            steps.make_decode_step(cfg)(params, cache, data["tokens"][:, 0])
    return counter.flops


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_counted_flops_match_hlo_cost(family, kind):
    arch = FAMILIES[family]
    want, got = _jax_flops(arch, kind), _port_flops(arch, kind)
    assert want > 0
    assert abs(got - want) <= TOL[kind] * want, (arch, kind, got, want,
                                                 got / want - 1)


def _reference_counts():
    """n_params, n_active_params and model_flops (train and inference,
    one token) of every full config by the reference dry-run's rules, in
    a subprocess (``repro.launch.dryrun`` sets XLA_FLAGS on import)."""
    script = (
        "import json, jax\n"
        "from repro.launch import dryrun as d\n"
        "from repro.configs import ARCH_IDS, get_config\n"
        "out = {}\n"
        "for a in ARCH_IDS:\n"
        "    cfg = get_config(a)\n"
        "    p = d.model_zoo.param_shapes(cfg)\n"
        "    n, act = d._count_params(p), d._active_params(cfg, p)\n"
        "    out[a] = [n, act, d.model_flops(n, 4096, act, True),\n"
        "              d.model_flops(n, 1, act, False)]\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_record_counts_match_reference():
    ref = _reference_counts()
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        p = model_zoo.param_shapes(cfg)
        n = sum(t.numel() for t in jax.tree_util.tree_leaves(p))
        act = model_zoo.active_params_count(cfg, p)
        want_n, want_act, want_train, want_infer = ref[arch]
        assert n == want_n, arch
        if arch == "deepseek_moe_16b":
            assert (want_act, act) == (2_391_721_984, 2_830_747_648)
        else:
            assert act == want_act, arch
        assert analysis.model_flops(n, 4096, want_act, True) == want_train
        assert analysis.model_flops(n, 1, want_act, False) == want_infer
        assert analysis.model_flops(n, 4096, act, True) == \
            jax_analysis.model_flops(n, 4096, act, True)


def test_roofline_terms_are_the_h100s():
    """The reference's formulas over the H100 SXM data-sheet rates and
    one 400 Gb/s NIC a GPU."""
    r = analysis.Roofline(flops=989e12, hbm_bytes=3.35e12 * 2,
                          collective_bytes=50e9 * 0.5)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.5)
    assert (r.bottleneck, r.total_s) == ("memory", pytest.approx(2.0))
    assert set(r.as_dict()) == set(jax_analysis.Roofline(
        1, 1, 1, 1, True).as_dict())


# one arch of each family without routing (a MoE's shard-local capacity
# rounds per shard, so its work does not split exactly)
SPLIT = {"dense": "olmo_1b", "ssm": "mamba2_780m", "hybrid": "zamba2_1_2b",
         "audio": "whisper_base", "vlm": "llava_next_34b"}


MESH_SCRIPT = r'''
import json, os, sys, tempfile
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs
from repro_torch.configs import ShapeSpec
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.fused_mlp import fused_mlp
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import dryrun, steps
from repro_torch.models import model_zoo
from repro_torch.models.common import tree_map
from repro_torch.roofline import count
from repro_torch.train.optimizer import init_opt_state

KERNELS = (flash_attention, fused_mlp, ssd_scan)
SPLIT = %r
launches = [f.launches for f in KERNELS]
real = dryrun.get_config
dryrun.get_config = lambda a: real(a, smoke=True)
# the shapes' names and kinds, cut in size (smoke configs: whisper's
# decoder positions stop at 64)
dryrun.SHAPES = {"train_4k": ShapeSpec("train_4k", "train", 32, 16),
                 "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32, 8),
                 "decode_32k": ShapeSpec("decode_32k", "decode", 64, 8),
                 "long_500k": ShapeSpec("long_500k", "decode", 128, 1)}
out = {}


def single_device_flops(arch):
    """The counted FLOPs of the port's train step on one device, plain
    fake tensors, at train_4k's global batch."""
    cfg = dryrun.get_config(arch)
    shape = dryrun.SHAPES["train_4k"]
    counter = count.StepCounter()
    with dryrun.FakeTensorMode():
        params = tree_map(lambda _, t: torch.zeros(t.shape, dtype=t.dtype),
                          model_zoo.param_shapes(cfg))
        batch = {k: torch.zeros((shape.global_batch, shape.seq_len),
                                dtype=torch.int32)
                 for k in ("tokens", "labels")}
        if cfg.family == "audio":
            batch["frames"] = torch.zeros(
                (shape.global_batch, cfg.enc_frames, cfg.d_model),
                dtype=torch.bfloat16)
        opt = init_opt_state(params)
        with counter:
            steps.make_train_step(cfg)(params, opt, batch)
    return counter.flops


with dryrun.fake_world(8):
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    for arch in configs.ARCH_IDS:
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            rec = dryrun.lower_cell(arch, shape, False, mesh=mesh)
            out[f"{arch}/{shape}"] = [rec["roofline"]["flops"],
                                      rec["roofline"]["collective_bytes"],
                                      rec["memory"]["peak_bytes_per_device"]]
    # the split of the work: train_4k under dp and tp, and on one device
    for arch in SPLIT:
        out[f"{arch}/split"] = [
            dryrun.lower_cell(arch, "train_4k", False, mesh=mesh,
                              plan="dp")["roofline"]["flops"],
            out[f"{arch}/train_4k"][0], single_device_flops(arch)]
    # the experts are never gathered under ep: the shape of every
    # all-gather's result, and the expert weights' [E, D, F] / [E, F, D]
    gathered, in_moe = [], []

    class Shapes(count.StepCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and "all_gather" in func._opname:
                gathered.append(list(out.shape))
                f = sys._getframe()
                while f is not None and f.f_code.co_name != "_moe_sharded":
                    f = f.f_back
                if f is not None:
                    in_moe.append(out.numel() * out.element_size())
            return out
    dryrun.StepCounter = Shapes
    rec = dryrun.lower_cell("deepseek_moe_16b", "train_4k", False,
                            mesh=mesh, plan="ep")
    dryrun.StepCounter = count.StepCounter
    p = model_zoo.param_shapes(configs.get_config("deepseek_moe_16b",
                                                  smoke=True))
    moe = p["layers"]["moe"]
    out["ep"] = {"gathered": gathered, "experts": [
        list(moe[k].shape[1:]) for k in ("w1", "w2")],
        "bytes": rec["collectives"]["bytes"]["all-gather"],
        "moe_bytes": sum(in_moe), "expert_bytes": sum(
            moe[k].numel() * 4 for k in ("w1", "w2", "w3"))}
    # one traced micro-batch scaled by n_micro = 2 against both traced
    cfg = dryrun.get_config("granite_moe_1b_a400m")
    shape = dryrun.SHAPES["train_4k"]
    counts = []
    for n in (1, 2):
        with dryrun.FakeTensorMode():
            c = dryrun._trace(cfg, shape, mesh, "tp",
                              "granite_moe_1b_a400m", n_traced=n)[0]
        counts.append([c.flops, c.hbm_bytes, c.coll_counts, c.coll_bytes,
                       c.peak_bytes])
    out["micro"] = counts
# the production multi-pod mesh (its own fake group) and skip accounting
out["multi_pod"] = []
for arch, shape in (("granite_moe_1b_a400m", "decode_32k"),
                    ("whisper_base", "decode_32k"),
                    ("whisper_base", "prefill_32k")):
    rec = dryrun.lower_cell(arch, shape, True)
    out["multi_pod"].append([rec["n_chips"],
                             rec["roofline"]["collective_bytes"]])
with tempfile.TemporaryDirectory() as d:
    out["skip"] = dryrun.run_and_save("granite_8b", "long_500k", False,
                                      d)["status"]
    rec = dryrun.run_and_save("mamba2_780m", "long_500k", False, d)
    out["ssm_long"] = rec["status"]
    out["keys"] = [sorted(rec), sorted(rec["memory"])]
    out["files"] = sorted(os.listdir(d))
out["launches_moved"] = [f.launches for f in KERNELS] != launches
out["group_left"] = dist.is_initialized()
print("RESULT " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def mesh_run():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    script = MESH_SCRIPT.replace("SPLIT = %r",
                                 f"SPLIT = {list(SPLIT.values())!r}")
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def test_fake_mesh_cells_trace_with_collectives(mesh_run):
    for cell in (f"{a}/{s}" for a in configs.ARCH_IDS
                 for s in ("train_4k", "prefill_32k", "decode_32k")):
        flops, coll, peak = mesh_run[cell]
        assert flops > 0 and coll > 0 and peak > 0, cell
    for chips, coll in mesh_run["multi_pod"]:
        assert chips == 512 and coll > 0


@pytest.mark.parametrize("family", list(SPLIT))
def test_mesh_counts_split_the_single_device_work(mesh_run, family):
    """On the fake 4 x 2 mesh, rank 0's counted FLOPs of a train_4k cell
    are an exact eighth of the single-device step's at the same global
    batch under the dp plan (every rank runs its rows), and between an
    eighth and all of them under tp. An op counted twice (sharding
    propagation's global-shape ops) or dropped (work behind
    ``local_map``) breaks the equality."""
    dp, tp, single = mesh_run[f"{SPLIT[family]}/split"]
    assert single > 0
    assert dp * 8 == single, (dp * 8, single)
    assert single / 8 <= tp <= single, (tp, single)


def test_skip_accounting(mesh_run):
    assert mesh_run["skip"].startswith("skip")
    assert mesh_run["ssm_long"] == "ok"
    assert mesh_run["files"] == ["granite_8b__long_500k__16x16.json",
                                 "mamba2_780m__long_500k__16x16.json"]


# the record of repro/launch/dryrun.py (lower_cell and run_and_save)
REFERENCE_KEYS = {"arch", "shape", "mesh", "n_chips", "kind", "n_params",
                  "n_active_params", "lower_s", "compile_s", "memory",
                  "roofline", "collectives", "xla_cost_reference",
                  "model_flops", "useful_flops_ratio", "status", "plan"}
REFERENCE_MEMORY = {"output_bytes_per_device", "temp_bytes_per_device",
                    "argument_bytes_per_device", "peak_bytes_per_device",
                    "cpu_f32_dot_emulation_bytes", "tpu_peak_estimate_bytes"}


def test_record_keeps_the_reference_keys(mesh_run):
    """The reference's record, less the keys that read XLA artifacts,
    plus the HBM budget the peak is read against."""
    keys, memory = mesh_run["keys"]
    assert set(keys) == REFERENCE_KEYS - {"xla_cost_reference"}
    assert set(memory) == REFERENCE_MEMORY - {
        "cpu_f32_dot_emulation_bytes", "tpu_peak_estimate_bytes"} | {
        "hbm_budget_bytes_per_device"}


def test_ep_never_gathers_the_experts(mesh_run):
    """No all-gather of the ep cell returns a routed expert weight, and
    the all-gathers the MoE layers issue (the expert outputs back to the
    data shards, forward and recompute) move fewer bytes than the expert
    weights (fp32, every layer). The cell's other all-gathers, which the
    whole-cell sum also holds, are the optimizer's ZeRO re-gather of each
    rank's own shards, the shared expert's weights (their spec shards
    D, the fused MLP's split wants F) and activations."""
    ep = mesh_run["ep"]
    assert ep["bytes"] > 0 and ep["gathered"]
    for shape in ep["gathered"]:
        for w in ep["experts"]:
            assert shape[-3:] != w, (shape, w)
    assert 0 < ep["moe_bytes"] < ep["expert_bytes"], ep["moe_bytes"]


def test_micro_batch_scaling_equals_full_trace(mesh_run):
    """FLOPs, bytes and collectives equal; the peak within 0.1%: a
    storage in a reference cycle is freed when Python's cyclic collector
    runs, which moves the peak of a trace by such a storage (measured
    512 bytes of 2.03 MB)."""
    scaled, full = mesh_run["micro"]
    assert scaled[:4] == full[:4]
    assert abs(scaled[4] - full[4]) <= 1e-3 * full[4], (scaled[4], full[4])


def test_no_kernel_launch_and_no_group_left(mesh_run):
    assert not mesh_run["launches_moved"]
    assert not mesh_run["group_left"]
