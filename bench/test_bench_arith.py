"""The yardstick's arithmetic: traffic from the seed, the rate and tail
readers on made-up timings, the frozen work formulas against hand counts,
and the roofline share."""
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from bench import harness, inputs, manifest, roofline, work  # noqa: E402

OLMO = json.loads((manifest.ROOT / "bench/configs/olmo_1b.json").read_text())
MAMBA = json.loads(
    (manifest.ROOT / "bench/configs/mamba2_780m.json").read_text())
TRAIN = json.loads((manifest.ROOT / "bench/traffic/train.json").read_text())
PREFILL = json.loads(
    (manifest.ROOT / "bench/traffic/prefill.json").read_text())
SEED = 2 ** 31 + 12345            # larger than 32 signed bits


def test_traffic_is_a_function_of_the_seed():
    a = inputs.train_batch(TRAIN, 50304, SEED, 3)
    b = inputs.train_batch(TRAIN, 50304, SEED, 3)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert a["tokens"].shape == (4, 2048) and a["tokens"].max() < 50304
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    rows = {r.tobytes() for r in a["tokens"]}
    rows |= {r.tobytes() for r in inputs.train_batch(
        TRAIN, 50304, SEED, 4)["tokens"]}
    assert len(rows) == 8                           # every row differs
    other = inputs.train_batch(TRAIN, 50304, SEED + 1, 3)
    assert not np.array_equal(a["tokens"], other["tokens"])
    p = inputs.prompts(PREFILL, 50277, SEED, 1)
    assert np.array_equal(p, inputs.prompts(PREFILL, 50277, SEED, 1))
    assert p.shape == (4, 2048) and p.max() < 50277


@pytest.mark.parametrize("calls,batch,k", [(25, 4, 48), (8, 32, 32),
                                           (3, 32, 40), (2, 4, 3)])
def test_the_checked_sample_covers_every_slot(calls, batch, k):
    s = inputs.sample(SEED, calls, batch, k)
    assert np.array_equal(s, inputs.sample(SEED, calls, batch, k))
    assert len(set(s.tolist())) == len(s) == min(k, calls * batch)
    assert s.min() >= 0 and s.max() < calls * batch
    per_slot = np.bincount(s % batch, minlength=batch)
    assert per_slot.max() - per_slot.min() <= 1     # as even as k allows
    if k >= batch:
        assert per_slot.min() >= 1                  # every slot checked
    assert not np.array_equal(s, inputs.sample(SEED + 1, calls, batch, k))


def test_weights_are_a_function_of_the_seed():
    cfg = {**OLMO, "n_layers": 1, "d_model": 32, "n_heads": 2,
           "n_kv_heads": 2, "d_ff": 64, "vocab": 100}
    a = inputs.weights(cfg, SEED, "cpu")
    b = inputs.weights(cfg, SEED, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    served = inputs.weights(cfg, SEED, "cpu", served=True)
    assert served["layers/mlp/w1"].dtype == torch.bfloat16
    assert served["layers/attn_norm"].dtype == torch.float32
    assert torch.equal(served["embed"], a["embed"].bfloat16())
    assert abs(float(a["layers/mlp/w2"].std()) - 64 ** -0.5) < 0.02


def _ctx(kind, starts, ends, tokens=100, requests=2):
    return harness.Context(kind=kind, cfg={}, traffic={}, setup_s=1.0,
                           starts=starts, ends=ends, tokens_per_unit=tokens,
                           requests_per_unit=requests)


def test_rates_count_every_unit_and_a_stall_moves_them():
    rate = manifest.reader("train_tokens_per_s")
    starts = [0.0, 1.0, 2.0, 3.0]
    assert rate(_ctx("train", starts, [1.0, 2.0, 3.0, 4.0])) == 100.0
    # one unit stalls for 4 s: the rate is over all the time, not a median
    stalled = rate(_ctx("train", [0.0, 1.0, 6.0, 7.0], [1.0, 6.0, 7.0, 8.0]))
    assert stalled == 50.0
    serve = manifest.reader("serve_tokens_per_s")
    assert serve(_ctx("serve", [0.0, 2.0], [2.0, 4.0])) == 50.0
    assert serve(_ctx("train", [0.0], [1.0])) is None


def test_p95_is_the_nearest_rank_over_requests():
    p95 = manifest.reader("request_ms_p95")
    starts = [float(i) for i in range(20)]
    ends = [s + 0.1 for s in starts]
    ends[7] = starts[7] + 0.5          # two slow calls: 4 of 40 requests
    ends[12] = starts[12] + 0.4
    assert p95(_ctx("serve", starts, ends, requests=2)) == pytest.approx(400)
    ends[12] = starts[12] + 0.1        # 2 of 40: under the 95th percentile
    assert p95(_ctx("serve", starts, ends, requests=2)) == pytest.approx(100)


def test_work_formulas_against_hand_counts():
    # olmo_1b's train shape: 4 x 2048, 16 heads of 128, K 2048, F 8192
    pairs = 2048 * 2049 // 2
    f, b = work.flash_fwd(4, 2048, 16, 16, 128)
    assert f == 4 * 4 * 16 * 128 * pairs
    assert b == 2 * 4 * (4 * 2048 * 16 * 128)
    f, b = work.flash_bwd(4, 2048, 16, 16, 128)
    assert f == 2.5 * work.flash_fwd(4, 2048, 16, 16, 128)[0]
    assert b == 2 * 8 * (4 * 2048 * 16 * 128) + 4 * 4 * 16 * 2048
    f, b = work.mlp_fwd(8192, 2048, 8192)
    assert f == 3 * 2 * 8192 * 2048 * 8192
    assert b == 2 * (2 * 8192 * 2048 + 3 * 2048 * 8192)
    assert work.mlp_bwd(8192, 2048, 8192)[0] == 2 * f
    # an MLP call at M 32 (decode) is bound by its weights' bytes
    f, b = work.mlp_fwd(32, 2048, 8192)
    assert work.least_seconds(f, b) == b / work.PEAK_BYTES
    # mamba2_780m's SSD forward at 4 x 2048, 48 heads of 64, N 128, chunk
    # 256
    f, _ = work.ssd_fwd(4, 2048, 48, 1, 128, 64, 256)
    tri = 256 * 257 / 2
    assert f == 2.0 * 4 * 8 * (tri * (128 + 48 * 64)
                               + 2 * 48 * 256 * 128 * 64)


@pytest.mark.parametrize("shape,ms", [
    ((4, 2048, 48, 1, 128, 64, 256), 0.0485),      # mamba2_780m
    ((4, 2048, 64, 1, 64, 64, 256), 0.0626)])      # zamba2_1_2b
def test_ssd_backward_bound_matches_the_programs_formula(shape, ms):
    from repro_torch.kernels.ssd_scan.ops import bwd_work
    assert work.ssd_bwd(*shape) == bwd_work(*shape)
    assert work.least_seconds(*work.ssd_bwd(*shape)) * 1e3 == pytest.approx(
        ms, abs=5e-5)


def test_model_flops_by_hand():
    per_layer = 4 * 2048 * 2048 + 3 * 2048 * 8192
    assert work.matmul_params(OLMO) == 16 * per_layer + 2048 * 50688
    attn = 16 * 4 * 4 * 16 * 128 * (2048 * 2049 // 2)
    assert work.train_step_flops(OLMO, 4, 2048) == 3 * (
        2 * work.matmul_params(OLMO) * 8192 + attn)
    mamba = 1536 * (2 * 3072 + 2 * 128 + 48) + 3072 * 1536
    assert work.matmul_params(MAMBA) == 48 * mamba + 1536 * 50688
    recurrence = 48 * 4 * 48 * 128 * 64             # a token, all layers
    assert work.train_step_flops(MAMBA, 4, 2048) == 3 * 8192 * (
        2 * work.matmul_params(MAMBA) + recurrence)
    # a decode token attends over the prompt and the tokens before it
    assert work.serve_call_flops(OLMO, 32, 512, 3) == (
        2 * work.matmul_params(OLMO) * 32 * 514
        + 16 * 4 * 32 * 16 * 128 * (512 * 513 // 2 + 513 + 514))


def test_kernel_calls_of_a_unit():
    calls = work.kernel_calls(MAMBA, TRAIN)
    assert [c for c, _ in calls["ssd_fwd"]] == [96]
    assert [c for c, _ in calls["ssd_bwd"]] == [48]
    assert set(calls) == {"ssd_fwd", "ssd_bwd"}
    calls = work.kernel_calls(MAMBA, PREFILL)
    assert set(calls) == {"ssd_fwd"}
    (n, w), = calls["ssd_fwd"]
    assert n == 48 and w == work.ssd_fwd(4, 2048, 48, 1, 128, 64, 256)
    calls = work.kernel_calls(OLMO, TRAIN)
    assert [c for c, _ in calls["flash_fwd"]] == [32]
    assert [c for c, _ in calls["mlp_bwd"]] == [16]
    decode = json.loads(
        (manifest.ROOT / "bench/traffic/decode.json").read_text())
    calls = work.kernel_calls(OLMO, decode)
    assert [c for c, _ in calls["mlp_fwd"]] == [16, 16 * 128]
    assert "flash_bwd" not in calls


def test_roofline_share_needs_the_counted_calls():
    cfg, traffic = OLMO, TRAIN
    (n, w), = work.kernel_calls(cfg, traffic)["mlp_fwd"]
    least = 2 * n * work.least_seconds(*w)
    ctx = harness.Context(
        kind="train", cfg=cfg, traffic=traffic, setup_s=0.0, starts=[],
        ends=[], tokens_per_unit=0, requests_per_unit=0,
        traced={"device_ops": {"void mlp_prefill<2>(CUtensorMap)":
                               2 * least, "flash_fwd": 1.0}},
        traced_units=2, launches={"mlp_fwd": 2 * n})
    assert roofline.share(ctx, "mlp_fwd") == pytest.approx(50.0)
    ctx.launches["mlp_fwd"] += 1            # a call the arithmetic lacks
    assert roofline.share(ctx, "mlp_fwd") is None
    assert roofline.share(ctx, "ssd_fwd") is None
    assert math.isclose(roofline.device_seconds(ctx, "flash_fwd"), 1.0)
