"""The decode attention roofline (``bench/decode_roofline.py``): its
work formula against hand counts, the calls a serving cell makes, the
share over the kernels found by name, and None wherever the program's
count of launches in the window is not the one expected."""
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from bench import decode_roofline, harness, manifest, work  # noqa: E402

GRANITE = manifest.cell("granite_8b.decode")
KERNEL = "void (anonymous namespace)::decode_attn_kernel<128, 4>(Args)"
COMBINE = "(anonymous namespace)::decode_attn_combine(Args, int, int)"


def test_one_call_by_hand():
    # b 2, h 4, kv 2, hd 8, 5 keys: 4 * 2*4*8*5 FLOPs; q and out 2*2*4*8
    # bf16 values, keys and values 2*2*5*2*8
    flops, nbytes = decode_roofline.decode_attn(2, 4, 2, 8, 5)
    assert flops == 1280.0
    assert nbytes == 2 * (2 * 2 * 4 * 8 + 2 * 2 * 5 * 2 * 8)


def test_a_generate_call_is_every_layer_at_every_step():
    cfg, traffic = GRANITE.config, GRANITE.traffic
    calls = decode_roofline.calls(cfg, traffic)
    assert len(calls) == traffic["new_tokens"] == 128
    assert all(c == cfg["n_layers"] == 36 for c, _ in calls)
    first, last = calls[0][1], calls[-1][1]
    assert first == decode_roofline.decode_attn(8, 32, 8, 128, 513)
    assert last == decode_roofline.decode_attn(8, 32, 8, 128, 640)
    # the bytes bound it: a 640-key call streams 8 x 640 x 8 x 128 keys
    # and values in bf16, about 21 MB, against 21 MFLOP
    assert work.least_seconds(*last) == last[1] / work.PEAK_BYTES


@pytest.mark.parametrize("workload", ["olmo_1b.train", "mamba2_780m.prefill",
                                      "deepseek_moe_16b.train"])
def test_cells_without_decode_attention_expect_no_calls(workload):
    cell = manifest.cell(workload)
    assert decode_roofline.calls(cell.config, cell.traffic) == []


def _ctx(cell, ops, counters, units=1):
    ctx = harness.Context(kind=cell.kind, cfg=cell.config,
                          traffic=cell.traffic, setup_s=1.0, starts=[0.0],
                          ends=[1.0], tokens_per_unit=1, requests_per_unit=1,
                          traced={"device_ops": ops, "window_s": 1.0,
                                  "busy_s": 1.0},
                          traced_units=units)
    if counters is not None:
        ctx.program_counters = counters
    return ctx


def _least(cell, units=1):
    return units * sum(c * work.least_seconds(*w) for c, w in
                       decode_roofline.calls(cell.config, cell.traffic))


@pytest.mark.parametrize("units", [1, 3])
def test_the_share_is_the_least_time_over_both_kernels(units):
    least = _least(GRANITE, units)
    n = units * 36 * 128
    ops = {KERNEL: 1.5 * least, COMBINE: 0.5 * least, "mlp_decode": 9.0}
    read = manifest.reader("decode_attn_roofline.serve")
    got = read(_ctx(GRANITE, ops, {decode_roofline.COUNTER: [0, n]}, units))
    assert got == pytest.approx(50.0)
    # the count by regime does not matter, the total does
    got = read(_ctx(GRANITE, ops, {decode_roofline.COUNTER: [n - 5, 5]},
                    units))
    assert got == pytest.approx(50.0)
    # the time of exactly the least work reads 100%
    got = read(_ctx(GRANITE, {KERNEL: least}, {decode_roofline.COUNTER:
                                               [0, n]}, units))
    assert got == pytest.approx(100.0)


@pytest.mark.parametrize("counters", [
    {}, {decode_roofline.COUNTER: [0, 36 * 128 - 1]},
    {decode_roofline.COUNTER: [0, 36 * 128 + 36]},
    {decode_roofline.COUNTER: [0, 0]}, {"engine.decode_graph": [127, 0, 0]}])
def test_a_count_that_is_not_the_expected_reads_none(counters):
    ops = {KERNEL: 1.0, COMBINE: 0.1}
    assert decode_roofline.share(_ctx(GRANITE, ops, counters)) is None


def test_no_kernel_time_no_trace_or_another_cell_reads_none():
    n = {decode_roofline.COUNTER: [0, 36 * 128]}
    assert decode_roofline.share(_ctx(GRANITE, {"mlp_decode": 1.0}, n)) is None
    ctx = _ctx(GRANITE, {KERNEL: 1.0}, n)
    ctx.traced = None
    assert decode_roofline.share(ctx) is None
    mamba = manifest.cell("mamba2_780m.prefill")
    assert decode_roofline.share(_ctx(mamba, {KERNEL: 1.0}, n)) is None


def test_the_counters_are_taken_once_a_run():
    """The first read of a traced run takes the program's span counters
    and empties them; the run's other readers share what it took, and a
    run that was not traced takes nothing."""
    from repro_torch.launch import spans
    spans.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        spans.count(decode_roofline.COUNTER, [2, 3])
    ctx = _ctx(GRANITE, {KERNEL: 1.0}, None)
    got = decode_roofline.program_counters(ctx)
    assert got == {decode_roofline.COUNTER: [2, 3]}
    assert spans.counters() == {}
    assert decode_roofline.program_counters(ctx) is got
    untraced = _ctx(GRANITE, {}, None)
    untraced.traced = None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        spans.count(decode_roofline.COUNTER, [1, 0])
    assert decode_roofline.program_counters(untraced) == {}
    assert spans.counters() == {decode_roofline.COUNTER: [1, 0]}
    spans.reset_counters()


def test_the_manifest_lists_the_metric_for_the_decode_cells():
    man = manifest.load()
    m, = [m for m in man["per_layer"]
          if m["name"] == "decode_attn_roofline.serve"]
    assert m["workloads"] == ["olmo_1b.decode", "granite_8b.decode"]
    for w in m["workloads"]:
        cell = manifest.cell(w)
        assert decode_roofline.calls(cell.config, cell.traffic)
    traffic = json.loads((manifest.ROOT / "bench/traffic/decode_b8.json")
                         .read_text())
    assert (traffic["batch"], traffic["prompt"], traffic["new_tokens"],
            traffic["check_requests"]) == (8, 512, 128, 16)
