"""Spans on the port's LM path (``repro_torch.launch.spans``) on the CPU:
off, a span is one shared no-op and records nothing; under a profiler
the trainer, the engine, the model layers and the kernel Functions open
their named ranges, nested as the code nests them, with counts of steps
times layers; the recompute is marked only inside a backward; results
are bitwise the same with spans live or not; with telemetry on the spans
reach the JSONL sink."""
import json
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import configs, obs  # noqa: E402
from repro_torch.data.synthetic import DataConfig  # noqa: E402
from repro_torch.kernels.flash_attn.ops import FlashAttention  # noqa: E402
from repro_torch.kernels.fused_mlp.ops import FusedMLP  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import SSDScan  # noqa: E402
from repro_torch.launch import spans  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

PREFIXES = ("trainer.", "engine.", "model.", "kernel.")
STEPS = 2


@pytest.fixture(autouse=True)
def _empty_table():
    obs.disable()
    spans.reset()
    yield
    obs.disable()
    spans.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _trainer(arch, remat="full"):
    cfg = configs.get_config(arch, smoke=True).with_(remat_policy=remat)
    return Trainer(cfg, OptimizerConfig(), TrainerConfig(steps=STEPS),
                   DataConfig(batch=2, seq=32), device="cpu")


def _engine(arch, new_tokens=3):
    cfg = configs.get_config(arch, smoke=True)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(cfg, params, ServeConfig(max_seq=24,
                                          max_new_tokens=new_tokens),
                 device="cpu")
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 8)).astype(np.int32)
    return eng, prompts


def _parents(prof):
    """{range name: set of names of the enclosing span ranges} of the
    profiler's events (None for a range outside every span)."""
    out = {}
    for e in prof.events():
        if not e.name.startswith(PREFIXES):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(PREFIXES):
            p = p.cpu_parent
        out.setdefault(e.name, set()).add(None if p is None else p.name)
    return out


def _count(tab, key):
    return tab.get(key, (0, 0.0))[0]


def test_off_a_span_is_the_shared_noop_and_records_nothing():
    assert not obs.enabled()
    a, b = spans.span("trainer.step"), spans.span("model.mlp")
    assert a is b
    with a:
        with b:
            pass
    eng, prompts = _engine("olmo_1b", new_tokens=2)
    eng.generate(prompts)
    assert spans.table() == {}


def test_train_ranges_nest_and_count_steps_times_layers():
    tr = _trainer("olmo_1b")
    layers = tr.cfg.n_layers
    with _cpu_profile() as prof:
        tr.run()
    par = _parents(prof)
    assert par["trainer.step"] == {None}
    assert par["trainer.forward"] == {"trainer.step"}
    assert par["trainer.backward"] == {"trainer.step"}
    assert par["trainer.optimizer"] == {"trainer.step"}
    # the CPU backward runs on the calling thread
    assert par["trainer.recompute"] == {"trainer.backward"}
    assert par["model.attention"] == {"trainer.forward", "trainer.recompute"}
    assert par["model.mlp"] == {"trainer.forward", "trainer.recompute"}
    assert par["model.unembed"] == {"trainer.forward"}
    tab = spans.table()
    fwd = "trainer.step;trainer.forward"
    rec = "trainer.step;trainer.backward;trainer.recompute"
    assert _count(tab, "trainer.step") == STEPS
    assert _count(tab, "trainer.step;trainer.optimizer") == STEPS
    assert _count(tab, fwd + ";model.attention") == STEPS * layers
    assert _count(tab, fwd + ";model.mlp") == STEPS * layers
    assert _count(tab, fwd + ";model.unembed") == STEPS
    assert _count(tab, rec) == STEPS * layers
    assert _count(tab, rec + ";model.attention") == STEPS * layers
    assert _count(tab, rec + ";model.mlp") == STEPS * layers
    # no synchronise on the CPU
    assert not any(k.endswith("trainer.sync") for k in tab)
    step_s = tab["trainer.step"][1]
    inside = sum(s for k, (_, s) in tab.items() if k.count(";") == 1)
    assert 0 < inside <= step_s


@pytest.mark.parametrize("remat", ["full", "dots", "mlp"])
def test_recompute_is_marked_only_inside_the_backward(remat):
    """Every policy runs one checkpointed function a layer again in the
    backward: the layer ("full", "dots") or its attention ("mlp")."""
    tr = _trainer("olmo_1b", remat)
    with _cpu_profile():
        tr.run()
    tab = spans.table()
    recs = {k: c for k, (c, _) in tab.items()
            if k.endswith("trainer.recompute")}
    assert recs == {"trainer.step;trainer.backward;trainer.recompute":
                    STEPS * tr.cfg.n_layers}
    assert not any("trainer.recompute" in k for k in tab
                   if "trainer.backward" not in k)


def test_a_profiler_started_before_the_backward_leaves_it_running():
    """Under remat "dots" (selective checkpointing, which records and
    replays the dispatched operations of a checkpointed layer), a
    profiler that starts between a forward and its backward opens ranges
    in the recompute alone; the backward runs, and marks the recompute."""
    cfg = configs.get_config("olmo_1b", smoke=True).with_(
        remat_policy="dots")
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    leaves = [t.requires_grad_() for t in tree_leaves(params)
              if t.is_floating_point()]
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    loss, _ = model_zoo.loss_fn(cfg, params, {"tokens": tokens,
                                              "labels": tokens})
    with _cpu_profile():
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert all(torch.isfinite(g).all() for g in grads if g is not None)
    assert _count(spans.table(), "trainer.recompute") == cfg.n_layers


@pytest.mark.parametrize("arch,mixer", [("olmo_1b", "model.attention"),
                                        ("mamba2_780m", "model.ssm")])
def test_serve_ranges_nest_and_count_layers(arch, mixer):
    new = 3
    eng, prompts = _engine(arch, new_tokens=new)
    layers = eng.cfg.n_layers
    with _cpu_profile() as prof:
        eng.generate(prompts)
    par = _parents(prof)
    assert par["engine.generate"] == {None}
    assert par["engine.first_token"] == {"engine.generate"}
    assert par["engine.prefill"] == {"engine.first_token"}
    assert par["engine.decode"] == {"engine.generate"}
    assert par["engine.sample"] == {"engine.first_token", "engine.generate"}
    assert par["engine.readback"] == {"engine.first_token",
                                      "engine.generate"}
    assert par[mixer] == {"engine.prefill", "engine.decode"}
    assert par["model.unembed"] == {"engine.prefill", "engine.decode"}
    assert "trainer.recompute" not in par
    tab = spans.table()
    g = "engine.generate"
    first = g + ";engine.first_token"
    assert _count(tab, g) == 1 and _count(tab, first) == 1
    assert _count(tab, first + ";engine.prefill") == 1
    assert _count(tab, first + ";engine.readback") == 1
    assert _count(tab, g + ";engine.readback") == new - 1
    # the trailing decode step: one a token
    assert _count(tab, g + ";engine.decode") == new
    assert _count(tab, first + ";engine.prefill;" + mixer) == layers
    assert _count(tab, g + ";engine.decode;" + mixer) == new * layers
    assert not any("trainer.recompute" in k for k in tab)


def _losses(tr):
    tr.run()
    return [h["loss"] for h in tr.metrics_history]


def test_losses_and_tokens_are_bitwise_equal_with_spans_live():
    plain = _trainer("olmo_1b")
    traced = _trainer("olmo_1b")
    want = _losses(plain)
    with _cpu_profile():
        got = _losses(traced)
    assert got == want
    for a, b in zip(tree_leaves(plain.final_state[0]),
                    tree_leaves(traced.final_state[0])):
        assert torch.equal(a, b)
    for arch in ("olmo_1b", "mamba2_780m"):
        eng, prompts = _engine(arch, new_tokens=4)
        want = eng.generate(prompts)
        with _cpu_profile():
            got = eng.generate(prompts)
        assert np.array_equal(got, want)


def test_kernel_functions_open_their_ranges_forward_and_backward():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g).requires_grad_()

    with _cpu_profile() as prof:
        FlashAttention.apply(r(1, 8, 2, 16), r(1, 8, 2, 16), r(1, 8, 2, 16),
                             True).sum().backward()
        FusedMLP.apply(r(4, 8), r(8, 16), r(8, 16), r(16, 8)
                       ).sum().backward()
        y, _ = SSDScan.apply(r(1, 8, 2, 16), torch.rand(1, 8, 2) + 0.1,
                             -torch.rand(2), r(1, 8, 1, 8), r(1, 8, 1, 8), 4)
        y.sum().backward()
    names = {e.name for e in prof.events()}
    tab = spans.table()
    for op in ("flash_attn", "fused_mlp", "ssd_scan"):
        for way in ("fwd", "bwd"):
            assert f"kernel.{op}.{way}" in names
            assert tab[f"kernel.{op}.{way}"][0] == 1


def test_telemetry_on_sends_the_spans_to_the_jsonl(tmp_path):
    path = tmp_path / "spans.jsonl"
    obs.enable(trace_path=str(path))
    try:
        eng, prompts = _engine("olmo_1b", new_tokens=2)
        eng.generate(prompts)
        _trainer("olmo_1b").run()
    finally:
        obs.disable()
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    names = {e["name"] for e in lines if e["ev"] == "span"}
    assert {"engine.generate", "engine.first_token", "engine.prefill",
            "engine.decode", "engine.sample", "engine.readback",
            "model.attention", "model.mlp", "model.unembed", "trainer.step",
            "trainer.forward", "trainer.backward", "trainer.recompute",
            "trainer.optimizer"} <= names
    # the table fills without a profiler too
    assert _count(spans.table(), "engine.generate") == 1


def test_the_table_loses_no_update_across_threads():
    threads, each = 16, 400
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    obs.enable()
    try:
        def work():
            for _ in range(each):
                with spans.span("engine.decode"):
                    with spans.span("model.mlp"):
                        pass
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(before)
        obs.disable()
    tab = spans.table()
    assert set(tab) == {"engine.decode", "engine.decode;model.mlp"}
    assert _count(tab, "engine.decode") == threads * each
    assert _count(tab, "engine.decode;model.mlp") == threads * each
