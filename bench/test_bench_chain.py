"""The Mamba-2 chain kernels' roofline (``bench/chain_roofline.py``): its
byte counts against hand counts, the calls each cell makes, the share
over the two kernels found by name, and None wherever the program's
count of launches in the window is not the one expected."""
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from bench import chain_roofline, harness, manifest, work  # noqa: E402

GRANITE = manifest.cell("granite_4_h_small.prefill")
MAMBA = manifest.cell("mamba2_780m.prefill")
CONV = "void (anonymous namespace)::mamba2_conv_silu(ConvArgs)"
NORM = "void (anonymous namespace)::mamba2_gated_rmsnorm<8>(NormArgs)"


def test_one_call_of_each_by_hand():
    # 2 rows, W 16, GN 8, H 2, K 4: x, B, C and dt read, xc, B, C
    # written in bf16 (2 * 2 * (16 + 16) + 2 * 2 values), the taps
    # 4 * 32; dt written and dt_bias, A_log, A in fp32
    flops, nbytes = chain_roofline.conv_silu(2, 16, 8, 2)
    assert flops == 0.0
    assert nbytes == 2 * (2 * 2 * 32 + 2 * 2 + 4 * 32) + 4 * (2 * 2 + 3 * 2)
    # y, xc, z read and the output written in bf16, D and gn_scale fp32
    assert chain_roofline.gated_rmsnorm(2, 16, 2) == (
        0.0, 2 * 4 * 2 * 16 + 4 * (2 + 16))


def test_mamba2_bytes_are_the_kernel_tables():
    """At mamba2_780m's prefill (B 4 x S 2048, W 3072, G*N 128, H 48)
    the counts are PERF.md's kernel table rows: 111.4 MB and 201.3 MB."""
    (n, conv), (m, norm) = chain_roofline.calls(MAMBA.config, MAMBA.traffic)
    assert n == m == 48
    assert round(conv[1] / 1e6, 1) == 111.4
    assert round(norm[1] / 1e6, 1) == 201.3


def test_granite_calls_are_its_mamba_layers_alone():
    """36 of its 40 layers are Mamba-2 layers; each call covers the
    batch's 8 x 4096 rows at W 8192, G*N 128, H 128."""
    calls = chain_roofline.calls(GRANITE.config, GRANITE.traffic)
    rows = 8 * 4096
    assert calls == [(36, chain_roofline.conv_silu(rows, 8192, 128, 128)),
                     (36, chain_roofline.gated_rmsnorm(rows, 8192, 128))]
    assert chain_roofline.mamba_layers(GRANITE.config) == 36


@pytest.mark.parametrize("workload", ["olmo_1b.train", "olmo_1b.decode",
                                      "deepseek_moe_16b.train",
                                      "granite_8b.decode",
                                      "olmo_1b.train_b16"])
def test_cells_without_a_serving_chain_expect_no_calls(workload):
    cell = manifest.cell(workload)
    assert chain_roofline.calls(cell.config, cell.traffic) == []


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
                       chain_roofline.calls(cell.config, cell.traffic))


@pytest.mark.parametrize("cell,n", [(GRANITE, 36), (MAMBA, 48)])
@pytest.mark.parametrize("units", [1, 2])
def test_the_share_is_the_least_time_over_both_kernels(cell, n, units):
    least = _least(cell, units)
    want = {chain_roofline.COUNTER: [units * n, units * n]}
    ops = {CONV: 0.5 * least, NORM: 1.5 * least, "ssd_chunk_scan": 9.0}
    read = manifest.reader("ssm_chain_roofline.prefill")
    assert read(_ctx(cell, ops, want, units)) == pytest.approx(50.0)
    # the time of exactly the least work reads 100%
    assert read(_ctx(cell, {CONV: least}, want, units)) == pytest.approx(
        100.0)


@pytest.mark.parametrize("counters", [
    {}, {chain_roofline.COUNTER: [36, 35]},
    {chain_roofline.COUNTER: [72, 0]}, {chain_roofline.COUNTER: [37, 37]},
    {"decode_attention.launches_by_regime": [36, 36]}])
def test_a_count_that_is_not_the_expected_reads_none(counters):
    ops = {CONV: 1.0, NORM: 1.0}
    assert chain_roofline.share(_ctx(GRANITE, ops, counters)) is None


def test_no_kernel_time_no_trace_or_a_training_cell_reads_none():
    n = {chain_roofline.COUNTER: [36, 36]}
    assert chain_roofline.share(_ctx(GRANITE, {"mlp_prefill": 1.0}, n)) \
        is None
    ctx = _ctx(GRANITE, {CONV: 1.0}, n)
    ctx.traced = None
    assert chain_roofline.share(ctx) is None
    olmo = manifest.cell("olmo_1b.train")
    assert chain_roofline.share(_ctx(olmo, {CONV: 1.0}, n)) is None


def test_the_manifest_lists_the_metric_for_the_prefill_cells():
    m, = [m for m in manifest.load()["per_layer"]
          if m["name"] == "ssm_chain_roofline.prefill"]
    assert m["workloads"] == ["mamba2_780m.prefill",
                              "granite_4_h_small.prefill"]
    for w in m["workloads"]:
        cell = manifest.cell(w)
        assert chain_roofline.calls(cell.config, cell.traffic)
