"""Granite-8B-Code served by the port at the benchmark's smoke widths on
the CPU (``bench/configs/granite_8b.json`` shrunk by
``bench/sizes/granite_8b.json``: GQA of 4 query heads a KV head):
``Engine.generate``'s logits, from the prefill and from every decode
step through the engine's kept cache, against the benchmark's plain
float32 reference (``bench.reference.model``) over the whole sequence;
the decode attention's split plan at the cell's grid; and the span
counter of decode attention launches by regime, which a replayed decode
step adds to (``kernels.counters.add``).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from bench import inputs, manifest, program  # noqa: E402
from bench.reference import model as ref  # noqa: E402
from bench.smoke import shrink  # noqa: E402
from repro_torch.kernels import counters  # noqa: E402
from repro_torch.kernels.decode_attn import ops as decode_ops  # noqa: E402
from repro_torch.launch import spans  # noqa: E402

CELL = manifest.cell("granite_8b.decode")
H100_SMS = 132
# float32 on both sides; the port's attention, cache and fused MLP sum in
# another order than the reference's full forward pass, and its logits
# are of order 1: the benchmark's float32 agreement of logits
# (bench/test_bench_reference.py) holds them to 1e-4
TOL = dict(rtol=1e-4, atol=1e-4)


def _granite(prompt=24, new=6, batch=2):
    cell = shrink(CELL, prompt=prompt, new_tokens=new, batch=batch)
    return {**cell.config, "compute_dtype": "float32"}, cell.traffic


def _recorded(eng):
    """The logits of every sampling of ``eng`` (the prefill's, then each
    decode step's), copied."""
    seen, sample = [], eng._sample

    def spy(logits, gen):
        seen.append(logits.detach().clone())
        return sample(logits, gen)

    eng._sample = spy
    return seen


def test_smoke_widths_keep_granites_grouping():
    cfg, _ = _granite()
    full = CELL.config
    assert full["n_heads"] // full["n_kv_heads"] == 4
    assert cfg["n_heads"] // cfg["n_kv_heads"] == 4
    assert cfg["n_kv_heads"] > 1 and cfg["family"] == "dense"


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_engine_logits_match_the_reference_at_every_position(seed):
    """Two calls on one engine (the second prefills into the cache the
    first left): the prefill's last logits and every decode step's (the
    last one, whose token is not served, included), for every row, equal
    the reference's full forward pass over the prompt and the served
    tokens, position by position."""
    cfg, traffic = _granite()
    new, prompt_len = traffic["new_tokens"], traffic["prompt"]
    w = inputs.weights(cfg, seed, "cpu")
    eng = program.engine(cfg, traffic, inputs.nest(
        {k: v.clone() for k, v in w.items()}), seed, "cpu")
    seen = _recorded(eng)
    for call in (1, 2):
        seen.clear()
        prompts = inputs.prompts(traffic, cfg["vocab"], seed, call)
        out = eng.generate(prompts)
        assert out.shape == (traffic["batch"], new)
        assert len(seen) == new + 1     # the prefill, then every step
        for row in range(traffic["batch"]):
            seq = np.concatenate([prompts[row], out[row]])
            rows = torch.arange(prompt_len - 1, prompt_len + new)
            want = ref.logits(cfg, w, torch.as_tensor(seq.astype(np.int64)),
                              rows=rows)
            got = torch.stack([z[row, :cfg["vocab"]] for z in seen])
            torch.testing.assert_close(got.float(), want, **TOL)
        assert (eng._caches[(traffic["batch"], prompt_len + new)]["pos"]
                .item() == prompt_len + new)


def test_the_cells_decode_attention_splits_the_keys():
    """At the cell's grid (8 rows x 8 KV heads, 64 blocks on the H100's
    132 SMs) the 640-slot cache is cut into 3 splits of 224 keys: every
    call is in the split regime, two launches. olmo_1b.decode's grid (32
    x 16) is not split."""
    t, c = CELL.traffic, CELL.config
    slots = t["prompt"] + t["new_tokens"]
    plan = decode_ops.split_plan(t["batch"], c["n_kv_heads"], slots, H100_SMS)
    assert plan == (3, 224)
    assert decode_ops.regime(plan[0]) == "split"
    olmo = manifest.cell("olmo_1b.decode")
    assert decode_ops.split_plan(olmo.traffic["batch"],
                                 olmo.config["n_kv_heads"], slots,
                                 H100_SMS)[0] == 1


def test_replays_add_the_regimes_to_the_span_counter():
    """``counters.add`` (a replay adds what the capture moved) adds the
    decode attention's launches by regime to its span counter while spans
    are live, and takes them back with the capture's sign -1; with spans
    off it counts nothing there."""
    spans.reset_counters()
    before = counters.read()
    decode_ops.decode_attention.launches_by_regime["split"] += 36
    moved = counters.moved(before, counters.read())
    counters.add(moved, -1)
    assert counters.read() == before
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(3):
                counters.add(moved)
            assert spans.counters()[decode_ops.COUNTER] == [0, 3 * 36]
            counters.add(moved, -1)
        assert spans.counters()[decode_ops.COUNTER] == [0, 2 * 36]
        counters.add(moved)               # spans off: not counted there
        assert spans.counters()[decode_ops.COUNTER] == [0, 2 * 36]
    finally:
        counters.add(moved, -3)
        spans.reset_counters()
    assert counters.read() == before
