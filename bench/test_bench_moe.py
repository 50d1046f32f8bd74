"""The DeepSeekMoE family's work counts (``bench/families/moe.py``)
against hand counts at the cell's size, and the program's parameter
counts of the same layout."""
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from bench import manifest, program, work  # noqa: E402
from bench.families import moe  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402

CFG = json.loads(
    (manifest.ROOT / "bench/configs/deepseek_moe_16b.json").read_text())
TRAIN = manifest.cell("deepseek_moe_16b.train").traffic

ATTN = 4 * 2048 * 2048                       # wq, wk, wv, wo: 16 x 128
DENSE = 3 * 2048 * 10944                     # the first layer's SwiGLU
EXPERT = 3 * 2048 * 1408                     # one routed expert
SHARED = 3 * 2048 * 2816                     # 2 shared experts' width
ROUTER = 2048 * 64


def test_matmul_params_by_hand():
    # a token meets 6 of 64 experts, 8 of them here: 6 x 8 / 64 experts
    moe_layer = ROUTER + SHARED + EXPERT * 6 * 8 // 64
    assert moe.matmul_params(CFG) == 16 * ATTN + DENSE + 15 * moe_layer
    assert work.matmul_params(CFG) == (2048 * 12800 + 16 * ATTN + DENSE
                                       + 15 * moe_layer) == 720_699_392


def test_train_step_flops_by_hand():
    pairs = 4096 * 4097 // 2
    attn = 16 * 4 * 8 * 16 * 128 * pairs     # 16 layers, batch 8
    assert moe.mix_flops(CFG, 8, 4096, 0) == attn
    flops = work.train_step_flops(CFG, 8, 4096)
    assert flops == 3 * (2 * 720_699_392 * 8 * 4096 + attn)
    assert 168.0e12 < flops < 168.2e12


def test_kernel_calls_are_flash_alone():
    calls = work.kernel_calls(CFG, TRAIN)
    assert set(calls) == {"flash_fwd", "flash_bwd"}
    assert calls["flash_fwd"] == [(32, work.flash_fwd(8, 4096, 16, 16,
                                                      128))]
    assert calls["flash_bwd"] == [(16, work.flash_bwd(8, 4096, 16, 16,
                                                      128))]
    serve = {"kind": "serve", "batch": 4, "prompt": 512}
    assert work.kernel_calls(CFG, serve) == {
        "flash_fwd": [(16, work.flash_fwd(4, 512, 16, 16, 128))]}


def test_the_programs_parameter_counts():
    """1.69 B parameters; a token's active ones are the matrix weights
    it meets, the embedding row and the norms."""
    mcfg = program.model_config(CFG, TRAIN)
    shapes = model_zoo.param_shapes(mcfg)
    embed = 2 * 2048 * 12800
    norms = (2 * 16 + 1) * 2048
    total = (embed + norms + 16 * ATTN + DENSE
             + 15 * (ROUTER + SHARED + 8 * EXPERT))
    assert mcfg.params_count(shapes) == total == 1_687_750_656
    active = model_zoo.active_params_count(mcfg, shapes)
    assert active == work.matmul_params(CFG) + embed // 2 + norms
