"""The serving engine's cache and decode graph on the CPU
(``serve/engine.py``, ``serve/decode_graph.py``): the rule that picks the
graph, the CPU engine staying eager on the one cache it keeps, the cache's
position as a 0-d int32 on its device advanced in place, the kept cache
leaking nothing across calls in every family, and the launch counters'
bookkeeping. The capture and replay themselves run on the card
(tests/test_torch_cuda.py).
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
from repro_torch.kernels.decode_attn import ops as decode_ops  # noqa: E402
from repro_torch.kernels.fused_mlp import ops as mlp_ops  # noqa: E402
from repro_torch.launch import spans  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
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


def _frames(cfg, seed):
    """The audio family's encoder frames [2, T, D] (None for the
    others)."""
    if cfg.family != "audio":
        return None
    return np.random.RandomState(seed).randn(
        2, cfg.enc_frames, cfg.d_model).astype(np.float32)


@pytest.mark.parametrize("arch", ["olmo_1b", "mamba2_780m", "zamba2_1_2b"])
def test_cpu_engine_stays_eager_with_the_step_loops_tokens(arch):
    """A CPU engine makes no decode graph: it keeps the one cache its
    first call made, prefills the second call into it, and counts every
    decode step eager; its greedy tokens are those of prefill, then
    argmax and ``decode_step`` a token at a time."""
    eng = _engine(arch)
    calls = [_prompts(eng.cfg.vocab, 16, 0), _prompts(eng.cfg.vocab, 8, 3)]
    with profile(activities=[ProfilerActivity.CPU]):
        got = [eng.generate(calls[0])]
        kept = eng._caches[(2, 24)]
        got.append(eng.generate(calls[1]))
    assert eng._caches == {(2, 24): kept} and eng._graphs == {(2, 24): None}
    assert spans.counters()[decode_graph.COUNTER] == [0, 0, 2 * NEW]
    for prompts, out in zip(calls, got):
        want = []
        with torch.inference_mode():
            logits, cache = model_zoo.prefill(eng.cfg, eng.params,
                                              torch.from_numpy(prompts), 24)
            for _ in range(NEW):
                tok = torch.argmax(logits, -1).to(torch.int32)
                want.append(tok.numpy())
                logits, cache = model_zoo.decode_step(eng.cfg, eng.params,
                                                      cache, tok)
        assert np.array_equal(out, np.stack(want, 1))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_position_is_a_device_scalar_advanced_in_place(arch):
    """``init_cache`` and ``prefill`` give ``pos`` as a 0-d int32 on the
    cache's device (the meta device too); a prefill into a kept cache
    sets that tensor in place, and ``decode_step`` returns the same dict
    with the same tensor advanced by one."""
    cfg = get_config(arch, smoke=True)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    meta = model_zoo.init_cache(cfg, 2, 24, device="meta")["pos"]
    assert meta.device.type == "meta" and meta.dtype == torch.int32
    cache = model_zoo.init_cache(cfg, 2, 24)
    pos = cache["pos"]
    assert pos.shape == () and pos.dtype == torch.int32
    assert pos.device.type == "cpu" and int(pos) == 0
    frames = _frames(cfg, 0)
    frames = None if frames is None else torch.from_numpy(frames)
    toks = torch.from_numpy(_prompts(cfg.vocab, 8, 0))
    start = 0 if cfg.family == "audio" else 8     # the reference's rule
    with torch.inference_mode():
        _, fresh = model_zoo.prefill(cfg, params, toks, 24, frames=frames)
        assert fresh["pos"].shape == () and fresh["pos"].dtype == torch.int32
        assert int(fresh["pos"]) == start
        _, got = model_zoo.prefill(cfg, params, toks, 24, frames=frames,
                                   cache=cache)
        assert got is cache and got["pos"] is pos and int(pos) == start
        for i in range(1, 3):
            _, got = model_zoo.decode_step(cfg, params, cache,
                                           toks[:, i].contiguous())
            assert got is cache and got["pos"] is pos
            assert int(pos) == start + i


class _EagerGraph(decode_graph.DecodeGraph):
    """``DecodeGraph`` whose capture and replay run the step eagerly (the
    CPU has no CUDA graph): the engine's kept cache, its position as a
    0-d tensor and the routing of its steps as on the card."""

    def _capture(self):
        self.graph = self
        self.moved = counters.moved(counters.read(), counters.read())
        return self.step(self.params, self.cache, self.tok)[0]

    def replay(self):
        self.logits, _ = self.step(self.params, self.cache, self.tok)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_static_cache_leaks_nothing_across_calls(arch, monkeypatch):
    """Two calls in a row on one engine's kept cache, with other prompts
    of other lengths (and other frames), return exactly what a fresh
    engine returns for each; the engine kept one cache, and as on the
    card the dense, ssm and hybrid families captured once and replayed
    the other steps while the others ran every step eagerly on it; its
    position ends at the second prompt's length (0 for the audio family)
    plus the new tokens."""
    monkeypatch.setattr(engine_mod, "DecodeGraph", _EagerGraph)
    monkeypatch.setattr(model_zoo, "decode_graph_ok",
                        lambda cfg, params: cfg.family in GRAPHED)
    eng = _engine(arch)
    calls = [(_prompts(eng.cfg.vocab, 16, 1), _frames(eng.cfg, 1)),
             (_prompts(eng.cfg.vocab, 8, 2), _frames(eng.cfg, 2))]
    with profile(activities=[ProfilerActivity.CPU]):
        got = [eng.generate(*c) for c in calls]
    cache, = eng._caches.values()
    graphed = eng.cfg.family in GRAPHED
    assert spans.counters()[decode_graph.COUNTER] == (
        [2 * NEW - 1, 1, 0] if graphed else [0, 0, 2 * NEW])
    assert list(eng._graphs) == [(2, 24)]
    if graphed:
        assert eng._graphs[(2, 24)].cache is cache
    start = 0 if eng.cfg.family == "audio" else 8
    assert int(cache["pos"]) == start + NEW
    monkeypatch.undo()
    for c, out in zip(calls, got):
        assert np.array_equal(out, _engine(arch).generate(*c))


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
