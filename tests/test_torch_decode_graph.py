"""The serving engine's decode graph on the CPU (``serve/decode_graph.py``):
the rule that picks it, the CPU engine staying eager, the decode position
as a 0-d tensor giving the int path's bits, the static cache reused
across calls leaking nothing, and the launch counters' bookkeeping. The
capture and replay themselves run on the card (tests/test_torch_cuda.py).
"""
import importlib
import os
import pkgutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import counters  # noqa: E402
from repro_torch.kernels.decode_attn import (decode_attention_ref,  # noqa: E402
                                             rope_table)
from repro_torch.kernels.decode_attn import ops as decode_ops  # noqa: E402
from repro_torch.kernels.fused_mlp import ops as mlp_ops  # noqa: E402
from repro_torch.launch import spans  # noqa: E402
from repro_torch.models import attention, model_zoo  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.serve import decode_graph  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

GRAPHED = ("dense", "ssm", "hybrid")
NEW = 4


@pytest.fixture(autouse=True)
def _empty_counters():
    spans.reset_counters()
    yield
    spans.reset_counters()


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_graph_rule_by_family_and_device(arch, device):
    """``decode_graph_ok``: the dense, ssm and hybrid families on CUDA
    parameters with grad off; never the MoE, audio or vlm families, CPU
    parameters, or with grad on. A stand-in leaf reads as a CUDA tensor
    here, where there is no card."""
    cfg = get_config(arch, smoke=True)
    leaf = (types.SimpleNamespace(is_cuda=True) if device == "cuda"
            else torch.empty(0))
    params = tree_map(lambda _, t: leaf, model_zoo.param_shapes(cfg))
    with torch.no_grad():
        ok = model_zoo.decode_graph_ok(cfg, params)
    assert ok == (device == "cuda" and cfg.family in GRAPHED)
    with torch.enable_grad():
        assert not model_zoo.decode_graph_ok(cfg, params)


def _engine(arch, max_seq=24):
    cfg = get_config(arch, smoke=True)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    return Engine(cfg, params, ServeConfig(max_seq=max_seq,
                                           max_new_tokens=NEW),
                  device="cpu")


def _prompts(vocab, s, seed):
    return np.random.RandomState(seed).randint(0, vocab, (2, s)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ["olmo_1b", "mamba2_780m", "zamba2_1_2b"])
def test_cpu_engine_stays_eager_with_the_step_loops_tokens(arch):
    """A CPU engine makes no decode graph and counts every decode step
    eager; its greedy tokens are those of prefill, then argmax and
    ``decode_step`` a token at a time."""
    eng = _engine(arch)
    prompts = _prompts(eng.cfg.vocab, 16, 0)
    with profile(activities=[ProfilerActivity.CPU]):
        got = eng.generate(prompts)
    assert eng._graphs == {}
    assert spans.counters()[decode_graph.COUNTER] == [0, 0, NEW]
    want = []
    with torch.inference_mode():
        logits, cache = model_zoo.prefill(eng.cfg, eng.params,
                                          torch.from_numpy(prompts), 24)
        for _ in range(NEW):
            tok = torch.argmax(logits, -1).to(torch.int32)
            want.append(tok.numpy())
            logits, cache = model_zoo.decode_step(eng.cfg, eng.params, cache,
                                                  tok)
    assert np.array_equal(got, np.stack(want, 1))


@pytest.mark.parametrize("b,s,h,kv,hd,pos", [(2, 40, 16, 16, 128, 0),
                                             (2, 40, 8, 4, 64, 17),
                                             (3, 20, 4, 4, 16, 19)])
@pytest.mark.parametrize("rope", [True, False])
def test_decode_attention_with_a_tensor_position_is_bitwise_the_int(
        b, s, h, kv, hd, pos, rope):
    """The plain decode path and the model-level ``decode_attention``
    give bitwise the same output and caches with ``pos`` an int and a 0-d
    int32 tensor."""
    cfg = get_config("granite_8b").with_(n_heads=h, n_kv_heads=kv,
                                         head_dim=hd, d_model=64)
    gen = torch.Generator().manual_seed(pos)

    def draw(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16)

    q, k, v = draw(b, 1, h, hd), draw(b, 1, kv, hd), draw(b, 1, kv, hd)
    ck, cv = draw(b, s, kv, hd), draw(b, s, kv, hd)
    tab = rope_table(cfg, s, "cpu") if rope else None
    at = torch.tensor(pos, dtype=torch.int32)
    caches = [(ck.clone(), cv.clone()) for _ in range(2)]
    want = decode_attention_ref(q, k, v, *caches[0], pos, tab)
    got = decode_attention_ref(q, k, v, *caches[1], at, tab)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(*caches))

    params = attention.init_attn(cfg, gen, dtype=torch.bfloat16)
    x = draw(b, 1, cfg.d_model)
    kv_caches = [{"k": ck.clone(), "v": cv.clone()} for _ in range(2)]
    with torch.inference_mode():
        want, _ = attention.decode_attention(cfg, params, x, kv_caches[0],
                                             pos, rope=rope)
        got, _ = attention.decode_attention(cfg, params, x, kv_caches[1], at,
                                            rope=rope)
    assert torch.equal(got, want)
    assert all(torch.equal(kv_caches[0][n], kv_caches[1][n]) for n in "kv")
    assert int(at) == pos       # read, not advanced, by the sublayer


class _EagerGraph(decode_graph.DecodeGraph):
    """``DecodeGraph`` whose capture and replay run the step eagerly (the
    CPU has no CUDA graph): the engine's static cache, its position as a
    0-d tensor and the routing of its steps as on the card."""

    def _capture(self):
        self.graph = self
        self.moved = counters.moved(counters.read(), counters.read())
        return self.step(self.params, self.cache, self.tok)[0]

    def replay(self):
        self.logits, _ = self.step(self.params, self.cache, self.tok)


@pytest.mark.parametrize("arch", ["olmo_1b", "mamba2_780m", "zamba2_1_2b"])
def test_static_cache_leaks_nothing_across_calls(arch, monkeypatch):
    """Two calls in a row on one engine's static cache, with other prompts
    of other lengths, return exactly what a fresh engine returns for each
    (the eager path, int ``pos``); the engine made one static cache,
    captured once and replayed the other steps, and its position ends at
    the second prompt's length plus the new tokens."""
    monkeypatch.setattr(engine_mod, "DecodeGraph", _EagerGraph)
    monkeypatch.setattr(model_zoo, "decode_graph_ok",
                        lambda cfg, params: True)
    eng = _engine(arch)
    calls = [_prompts(eng.cfg.vocab, 16, 1), _prompts(eng.cfg.vocab, 8, 2)]
    with profile(activities=[ProfilerActivity.CPU]):
        got = [eng.generate(p) for p in calls]
    graph, = eng._graphs.values()
    assert spans.counters()[decode_graph.COUNTER] == [2 * NEW - 1, 1, 0]
    assert int(graph.cache["pos"]) == 8 + NEW
    monkeypatch.undo()
    for p, out in zip(calls, got):
        assert np.array_equal(out, _engine(arch).generate(p))


def test_launch_counters_move_back_and_forth():
    """The capture's bookkeeping (``kernels.counters``): what the counters
    moved, taken back, then added per replay, plain and by regime."""
    before = counters.read()
    mlp0, reg0 = (mlp_ops.fused_mlp.launches,
                  dict(decode_ops.decode_attention.launches_by_regime))
    mlp_ops.fused_mlp.launches += 3
    decode_ops.decode_attention.launches_by_regime["split"] += 2
    moved = counters.moved(before, counters.read())
    counters.add(moved, -1)
    assert counters.read() == before
    for _ in range(2):
        counters.add(moved)
    assert mlp_ops.fused_mlp.launches == mlp0 + 6
    assert decode_ops.decode_attention.launches_by_regime == {
        **reg0, "split": reg0["split"] + 4}
    counters.add(moved, -2)
    assert counters.read() == before


def test_every_kernel_launch_counter_is_registered():
    """Every op of ``repro_torch.kernels`` that counts its launches is in
    ``counters.OPS``, so a replayed decode step adds what each of its
    kernels counted; ``reset`` zeroes every counter, by regime too."""
    import repro_torch.kernels as kernels
    found = set()
    for mod in pkgutil.iter_modules(kernels.__path__):
        if not mod.ispkg:
            continue
        ops = importlib.import_module(f"repro_torch.kernels.{mod.name}.ops")
        found |= {fn for fn in vars(ops).values() if callable(fn)
                  and any("launches" in a for a in getattr(fn, "__dict__",
                                                           ()))}
    assert found == set(counters.OPS)
    keys = set(counters.read())
    assert {("flash_attention", "launches_by_regime"),
            ("decode_attention", "launches_by_regime"),
            ("fused_mlp", "bwd_launches"), ("ssd_scan", "launches")} <= keys
    saved = counters.read()
    try:
        counters.reset()
        assert all(not any(v.values()) if isinstance(v, dict) else v == 0
                   for v in counters.read().values())
    finally:
        counters.add(saved)
