"""The Granite 4.0-H family's work counts (``bench/families/hybrid.py``)
against hand counts at the cell's size, the program's parameter counts
of the same layout, and the layer pattern and published keys of the
configuration file."""
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from bench import manifest, program, work  # noqa: E402
from bench.families import hybrid  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402

CELL = manifest.cell("granite_4_h_small.prefill")
CFG, PREFILL = CELL.config, CELL.traffic

MAMBA = 4096 * (2 * 8192 + 2 * 128 + 128) + 8192 * 4096   # z, x, B, C, dt; out
ATTN = 4096 * 128 * (2 * 32 + 2 * 8)                      # wq, wk, wv, wo
ROUTER = 4096 * 72
SHARED = 3 * 4096 * 1536
EXPERT = 3 * 4096 * 768


def test_the_layer_pattern_and_the_published_keys():
    """Layers 5, 15, 25 and 35 attend, the other 36 are Mamba-2; every
    published key the file states is the port field it names."""
    types = hybrid.layer_types(CFG)
    assert [i for i, t in enumerate(types) if t == "attention"] == [5, 15,
                                                                   25, 35]
    assert types.count("mamba") == 36
    mcfg = program.model_config(CFG, PREFILL)
    assert mcfg.published_mismatches() == []
    assert (mcfg.hidden_size, mcfg.mamba_n_heads, mcfg.ssm_heads,
            mcfg.shared_intermediate_size, mcfg.shared_width) == (
        4096, 128, 128, 1536, 1536)
    with pytest.raises(ValueError, match="attn_every"):
        hybrid.layer_types({**CFG, "attn_every": 6})


def test_matmul_params_by_hand():
    # a token meets 10 of 72 experts, 9 of them here: 10 x 9 / 72 experts
    ffn = ROUTER + SHARED + EXPERT * 10 * 9 // 72
    assert hybrid.matmul_params(CFG) == 36 * MAMBA + 4 * ATTN + 40 * ffn
    assert work.matmul_params(CFG) == (4096 * 12800 + 36 * MAMBA + 4 * ATTN
                                       + 40 * ffn) == 5_139_333_120


def test_a_call_s_flops_by_hand():
    """The prefill of 8 x 4096 (the generated token's forward is never
    run: one new token): 2 x the matmul weights a token, the 4 attention
    layers' products over the causal pairs and the 36 Mamba-2 layers'
    recurrence, 4 H N P a token."""
    pairs = 4096 * 4097 // 2
    attn = 4 * 4 * 8 * 32 * 128 * pairs
    ssm = 36 * 4 * 128 * 128 * 64 * 8 * 4096
    assert hybrid.mix_flops(CFG, 8, 4096, 0) == attn + ssm
    flops = work.serve_call_flops(CFG, 8, 4096, 1)
    assert flops == 2 * 5_139_333_120 * 8 * 4096 + attn + ssm
    assert 346.1e12 < flops < 346.2e12


def test_kernel_calls_are_ssd_and_flash():
    calls = work.kernel_calls(CFG, PREFILL)
    assert calls == {
        "ssd_fwd": [(36, work.ssd_fwd(8, 4096, 128, 1, 128, 64, 256))],
        "flash_fwd": [(4, work.flash_fwd(8, 4096, 32, 8, 128))]}
    train = json.loads((manifest.ROOT / "bench/traffic/train.json")
                       .read_text())
    calls = work.kernel_calls(CFG, train)
    assert [n for op in ("ssd_fwd", "ssd_bwd", "flash_fwd", "flash_bwd")
            for n, _ in calls[op]] == [72, 36, 8, 4]


def test_the_programs_parameter_counts():
    """8.12 B parameters (16.2 GB in bf16); a token's active ones are the
    matrix weights it meets, the embedding row, the norms and the
    Mamba-2 layers' conv taps and per-head vectors."""
    mcfg = program.model_config(CFG, PREFILL)
    shapes = model_zoo.param_shapes(mcfg)
    embed = 2 * 4096 * 12800
    norms = (2 * 40 + 1) * 4096
    ssm_small = 4 * (8192 + 2 * 128) + 3 * 128 + 8192  # taps, dt_bias, A, D, gn
    total = (embed + norms + 36 * (MAMBA + ssm_small) + 4 * ATTN
             + 40 * (ROUTER + SHARED + 9 * EXPERT))
    assert mcfg.params_count(shapes) == total == 8_119_145_984
    active = model_zoo.active_params_count(mcfg, shapes)
    assert active == (work.matmul_params(CFG) + embed // 2 + norms
                      + 36 * ssm_small)
