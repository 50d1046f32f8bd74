"""The PyTorch port on a CUDA GPU: each hand-written kernel against its
plain version; the dense, MoE and Mamba-2 LMs', the encoder-decoder's and
the VLM's card path against their CPU path; and training: the kernels'
autograd Functions against autograd of their plain versions, the
gradient guard, and train steps on the card.

Every test here needs a GPU and skips without one; the file imports no
JAX, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import DataConfig  # noqa: E402
from repro_torch.kernels.flash_attn import (FlashAttention,  # noqa: E402
                                            attention_lse, attention_ref,
                                            flash_attention,
                                            flash_attention_backward)
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attn.ops import REGIMES, regime  # noqa: E402
from repro_torch.kernels.fused_mlp import (FusedMLP, fused_mlp,  # noqa: E402
                                           fused_mlp_backward, fused_mlp_ref)
from repro_torch.kernels.fused_mlp import ops as mlp_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import (SSDScan, from_pallas_layout,  # noqa: E402
                                          ssd_ref, ssd_scan,
                                          ssd_scan_backward, to_pallas_layout)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import adamw  # noqa: E402
from repro_torch.kernels.adamw import ops as adamw_ops  # noqa: E402
from repro_torch.kernels.decode_attn import (decode_attention,  # noqa: E402
                                             decode_attention_ref,
                                             rope_table, split_plan)
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels import ssm_chain  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import attention, mlp, model_zoo  # noqa: E402
from repro_torch.models.common import rope_freqs  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.models.common import (tree_get, tree_leaves,  # noqa: E402
                                       tree_map)
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         adamw_update, global_norm,
                                         init_opt_state, lr_schedule)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

pytestmark = pytest.mark.cuda

BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # the repo's bf16 kernel tolerance
SSD_TOL = dict(rtol=5e-2, atol=5e-2)   # the repo's bf16 SSD tolerance


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(torch.bfloat16)


@pytest.mark.parametrize("b,sq,skv,h,kv,hd,causal", [
    (2, 128, 128, 8, 2, 128, True),
    (1, 77, 77, 4, 4, 64, True),
    (2, 50, 200, 8, 1, 96, True),
    (1, 130, 70, 4, 2, 80, False),
    # ragged query tiles on both sides of the 128-row tile, end-aligned
    # Sq < Skv, every head dim
    (1, 1, 1, 4, 2, 128, True),
    (2, 63, 63, 4, 1, 64, True),
    (1, 127, 300, 4, 2, 80, True),
    (1, 129, 129, 6, 3, 96, True),
    (2, 500, 500, 4, 2, 128, True),
    (1, 1, 257, 4, 4, 96, True),
    (1, 129, 400, 2, 1, 80, False),
    (1, 500, 620, 8, 8, 64, True),
    # whisper_base: the encoder (non-causal, 1500 frames, 1500 = 11 x 128
    # + 92) and the cross-attention (non-causal, Sq != Skv)
    (4, 1500, 1500, 8, 8, 64, False),
    (4, 128, 1500, 8, 8, 64, False),
])
def test_flash_kernel_matches_plain(cuda, b, sq, skv, h, kv, hd, causal):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, b, sq, h, hd)
    k, v = _randn(gen, b, skv, kv, hd), _randn(gen, b, skv, kv, hd)
    before = flash_attention.launches
    by_regime = dict(flash_attention.launches_by_regime)
    y = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    key = regime(causal, sq, skv)
    assert {r: n - by_regime[r] for r, n in
            flash_attention.launches_by_regime.items()} == {
        r: int(r == key) for r in REGIMES}
    torch.testing.assert_close(y.float(),
                               attention_ref(q, k, v, causal).float(),
                               **BF16_TOL)


@pytest.mark.parametrize("sq,skv,hd", [(63, 63, 80), (129, 200, 96),
                                       (500, 500, 128), (1, 64, 64)])
def test_flash_kernel_pallas_layout(cuda, sq, skv, hd):
    """The Pallas layout [BH, S, hd] goes through the same 4-D TMA
    descriptors (as B = 1, H = BH) and matches the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(gen, 8, sq, hd)
    k, v = _randn(gen, 4, skv, hd), _randn(gen, 4, skv, hd)
    y = flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(y.float(),
                               attention_ref(q, k, v, True).float(),
                               **BF16_TOL)


@pytest.mark.parametrize("m,k,f", [
    (m, k, f) for m in (1, 4, 63, 64, 65, 100, 256)
    for k, f in ((128, 256), (256, 384), (512, 1024))] + [
    (70, 256, 384),
    (300, 128, 1024),  # 3 row chunks of the prefill kernels
])
def test_fused_mlp_kernel_matches_plain(cuda, m, k, f):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = _randn(gen, m, k)
    w1 = _randn(gen, k, f, scale=k ** -0.5)
    w3 = _randn(gen, k, f, scale=k ** -0.5)
    w2 = _randn(gen, f, k, scale=f ** -0.5)
    before = fused_mlp.launches
    y = fused_mlp(x, w1, w3, w2)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    torch.testing.assert_close(y.float(),
                               fused_mlp_ref(x, w1, w3, w2).float(),
                               **BF16_TOL)


@pytest.mark.parametrize("m", [4, 256])
def test_fused_mlp_kernel_at_llava_width(cuda, m):
    """llava_next_34b's MLP, K 7168 and F 20480, in the decode (M 4) and
    the prefill regime."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    k, f = 7168, 20480
    x = _randn(gen, m, k)
    w1 = _randn(gen, k, f, scale=k ** -0.5)
    w3 = _randn(gen, k, f, scale=k ** -0.5)
    w2 = _randn(gen, f, k, scale=f ** -0.5)
    torch.testing.assert_close(fused_mlp(x, w1, w3, w2).float(),
                               fused_mlp_ref(x, w1, w3, w2).float(),
                               **BF16_TOL)


@pytest.mark.parametrize("m", [4, 100])
def test_fused_mlp_kernel_is_deterministic(cuda, m):
    """No atomics: two calls on the same inputs are bit-identical, in both
    regimes."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    k, f = 512, 1024
    x = _randn(gen, m, k)
    w1 = _randn(gen, k, f, scale=k ** -0.5)
    w3 = _randn(gen, k, f, scale=k ** -0.5)
    w2 = _randn(gen, f, k, scale=f ** -0.5)
    assert torch.equal(fused_mlp(x, w1, w3, w2), fused_mlp(x, w1, w3, w2))


def _ssd_inputs(gen, b, s, h, g, n, p=64):
    """Model-layout SSD inputs as the model path makes them: bf16 x, B, C;
    fp32 dt > 0 and A < 0."""
    dev = gen.device
    x = torch.randn((b, s, h, p), generator=gen, device=dev).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=dev))
    a = -torch.exp(torch.randn((h,), generator=gen, device=dev) * 0.2)
    bm, cm = (torch.randn((b, s, g, n), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    return x, dt, a, bm, cm


@pytest.mark.parametrize("b,s,h,g,n,chunk", [
    (2, 256, 4, 1, 128, 256),   # mamba2_780m head geometry
    (1, 192, 4, 2, 64, 64),     # grouped, zamba2's state size
    (2, 100, 2, 1, 16, 100),    # ragged chunk (a 100-token prompt)
    (1, 320, 2, 2, 24, 64),     # N not a multiple of the 64-row tile
    (1, 2048, 2, 1, 128, 256),  # the state carried across 8 chunks
    (1, 512, 64, 1, 64, 256),   # zamba2_1_2b geometry (H=64, N=64)
    (1, 1024, 2, 1, 128, 512),  # two 256-row scan items per chunk
    (1, 2048, 1, 1, 64, 2048),  # one chunk of 2048: 8 scan items
])
def test_ssd_kernel_matches_plain(cuda, b, s, h, g, n, chunk):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, dt, a, bm, cm = _ssd_inputs(gen, b, s, h, g, n)
    before = ssd_scan.launches
    y, state = ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want_y, want_state = from_pallas_layout(
        *ssd_ref(*to_pallas_layout(x, dt, a, bm, cm)), b)
    torch.testing.assert_close(y.float(), want_y.float(), **SSD_TOL)
    torch.testing.assert_close(state, want_state, **SSD_TOL)


def test_ssd_kernel_pallas_layout_and_chunk_invariance(cuda):
    """The Pallas layout [BH, S, *] runs without a copy and gives the
    model layout's numbers; chunk 64 and 256 agree up to rounding."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, s, h, n = 2, 512, 3, 128
    x, dt, a, bm, cm = _ssd_inputs(gen, b, s, h, h, n)
    y, state = ssd_scan(x, dt, a, bm, cm, chunk=256)
    y64, state64 = ssd_scan(x, dt, a, bm, cm, chunk=64)
    torch.testing.assert_close(y64.float(), y.float(), **SSD_TOL)
    torch.testing.assert_close(state64, state, **SSD_TOL)
    y3, state3 = ssd_scan(*to_pallas_layout(x, dt, a, bm, cm), chunk=256)
    y3, state3 = from_pallas_layout(y3, state3, b)
    torch.testing.assert_close(y3, y, rtol=0, atol=0)
    torch.testing.assert_close(state3, state, rtol=0, atol=0)


@pytest.mark.parametrize("n,chunk", [(128, 256), (24, 100)])
def test_ssd_kernel_is_deterministic(cuda, n, chunk):
    """No atomics: two calls on the same inputs give bit-identical y and
    final state."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x, dt, a, bm, cm = _ssd_inputs(gen, 2, 4 * chunk, 4, 1, n)
    y, state = ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    y2, state2 = ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(state, state2)


def test_kernels_raise_for_unsupported_input(cuda):
    """What no padding makes fit is refused with ValueError: non-bf16
    inputs, flash head dims above 128 or off the multiples of 8, fused_mlp
    K or F off the multiples of 64, ssd_scan head dims above 64, chunks
    that do not divide S, tensors off the card."""
    x = torch.zeros(4, 128, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_mlp(x, x.T.contiguous(), x.T.contiguous(), x)
    xb = torch.zeros(4, 96, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(96, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiples of 64"):
        fused_mlp(xb, w, w, w.T.contiguous())
    for hd in (136, 20):
        q = torch.zeros(1, 8, 2, hd, dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention(q, q, q)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, dt, a, bm, cm = _ssd_inputs(gen, 1, 64, 2, 1, 16)
    with pytest.raises(ValueError, match="bfloat16"):
        ssd_scan(x.float(), dt, a, bm, cm)
    x72, *_ = _ssd_inputs(gen, 1, 64, 2, 1, 16, p=72)
    with pytest.raises(ValueError, match="head dim"):
        ssd_scan(x72, dt, a, bm, cm)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan(x, dt, a, bm, cm, chunk=48)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(x, dt.cpu(), a, bm, cm)


# the smoke configs' shapes (hd 16, K 64, P 16) and others off the kernels'
# native sizes run the kernels on zero-padded operands


@pytest.mark.parametrize("b,sq,skv,h,kv,hd,causal", [
    (4, 16, 16, 4, 4, 16, True),     # the serve launcher's smoke prefill
    (8, 128, 128, 4, 2, 16, True),   # a smoke train step
    (1, 8, 8, 2, 2, 48, True),
    (2, 70, 130, 4, 2, 72, True),
    (1, 33, 33, 2, 1, 8, False),
])
def test_flash_kernel_pads_small_head_dims(cuda, b, sq, skv, h, kv, hd,
                                           causal):
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = _randn(gen, b, sq, h, hd)
    k, v = _randn(gen, b, skv, kv, hd), _randn(gen, b, skv, kv, hd)
    before = flash_attention.launches
    y = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert y.shape == q.shape and y.is_contiguous()
    torch.testing.assert_close(y.float(),
                               attention_ref(q, k, v, causal).float(),
                               **BF16_TOL)


@pytest.mark.parametrize("m,k,f", [(64, 64, 128), (1024, 64, 128),
                                   (4, 64, 64), (200, 192, 320)])
def test_fused_mlp_kernel_pads_k_and_f(cuda, m, k, f):
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = _randn(gen, m, k)
    w1 = _randn(gen, k, f, scale=k ** -0.5)
    w3 = _randn(gen, k, f, scale=k ** -0.5)
    w2 = _randn(gen, f, k, scale=f ** -0.5)
    before = fused_mlp.launches
    y = fused_mlp(x, w1, w3, w2)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    assert y.shape == (m, k) and y.is_contiguous()
    torch.testing.assert_close(y.float(),
                               fused_mlp_ref(x, w1, w3, w2).float(),
                               **BF16_TOL)


@pytest.mark.parametrize("b,s,h,g,n,p,chunk", [
    (4, 16, 8, 1, 16, 16, 16),     # the serve launcher's smoke prefill
    (8, 128, 8, 1, 16, 16, 16),    # a smoke train step
    (2, 192, 4, 2, 64, 32, 64),
    (1, 100, 2, 1, 24, 8, 100),
])
def test_ssd_kernel_pads_small_head_dims(cuda, b, s, h, g, n, p, chunk):
    gen = torch.Generator(device=cuda).manual_seed(9)
    x, dt, a, bm, cm = _ssd_inputs(gen, b, s, h, g, n, p=p)
    before = ssd_scan.launches
    y, state = ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.shape == x.shape and state.shape == (b, h, n, p)
    want_y, want_state = from_pallas_layout(
        *ssd_ref(*to_pallas_layout(x, dt, a, bm, cm)), b)
    torch.testing.assert_close(y.float(), want_y.float(), **SSD_TOL)
    torch.testing.assert_close(state, want_state, **SSD_TOL)


# ---------------------------------------------------------------------------
# the Mamba-2 chain around the scan (kernels/ssm_chain)
# ---------------------------------------------------------------------------

# (b, s, W, G*N, H, P): mamba2_780m's and zamba2_1_2b's widths and the
# smoke configs' (W 128, G*N 16, H 8, P 16); two or more sequences in a
# batch, a prompt shorter than the conv (S 2), one of 256 and one of 2048
CHAIN_SHAPES = [
    (4, 2048, 3072, 128, 48, 64),
    (2, 256, 3072, 128, 48, 64),
    (3, 2, 3072, 128, 48, 64),
    (2, 2048, 4096, 64, 64, 64),
    (2, 256, 4096, 64, 64, 64),
    (4, 2, 4096, 64, 64, 64),
    (4, 16, 128, 16, 8, 16),
    (2, 256, 128, 16, 8, 16),
]


def _chain_inputs(dev, b, s, w, gn, h, p, seed=0):
    """The chain's inputs as a prefill makes them: bf16 projections and
    conv weights, fp32 dt_bias, A_log, D and gn_scale off their init
    values, the scan's y and the gate z."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def f32(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    conv = [_randn(gen, b, s, w), _randn(gen, b, s, gn),
            _randn(gen, b, s, gn), _randn(gen, 4, w, scale=0.5),
            _randn(gen, 4, gn, scale=0.5), _randn(gen, 4, gn, scale=0.5),
            _randn(gen, b, s, h, scale=2.0), f32(h), f32(h, scale=0.5)]
    norm = [_randn(gen, b, s, h, p), _randn(gen, b, s, w), f32(h, shift=1.0),
            f32(w, scale=0.2, shift=1.0)]
    return conv, norm


def _fp32(ts):
    return [t.float() for t in ts]


@pytest.mark.parametrize("b,s,w,gn,h,p", CHAIN_SHAPES)
def test_conv_silu_kernel_matches_plain(cuda, b, s, w, gn, h, p):
    """The pre-scan kernel against its plain version in fp32 on the same
    bf16 inputs: xc, B and C within the bf16 tolerance (the first rows of
    every sequence included: the conv pads each with zeros), dt and A
    within fp32 rounding; one launch; two calls bitwise equal."""
    args, _ = _chain_inputs(cuda, b, s, w, gn, h, p)
    before = ssm_chain.conv_silu.launches
    got = ssm_chain.conv_silu(*args)
    again = ssm_chain.conv_silu(*args)
    torch.cuda.synchronize()
    assert ssm_chain.conv_silu.launches == before + 2
    want = ssm_chain.conv_silu_ref(*_fp32(args))
    for g, wt in zip(got[:3], want[:3]):
        assert g.dtype == torch.bfloat16 and g.shape == wt.shape
        torch.testing.assert_close(g.float(), wt, **BF16_TOL)
    for g, wt in zip(got[3:], want[3:]):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, wt, rtol=1e-5, atol=1e-6)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("b,s,w,gn,h,p", CHAIN_SHAPES)
def test_gated_rmsnorm_kernel_matches_plain(cuda, b, s, w, gn, h, p):
    """The post-scan kernel against its plain version in fp32 on the same
    bf16 inputs, within the bf16 tolerance; one launch; two calls bitwise
    equal."""
    conv, (y, z, d, scale) = _chain_inputs(cuda, b, s, w, gn, h, p, seed=1)
    xc = conv[0]
    before = ssm_chain.gated_rmsnorm.launches
    got = ssm_chain.gated_rmsnorm(y, xc, z, d, scale)
    again = ssm_chain.gated_rmsnorm(y, xc, z, d, scale)
    torch.cuda.synchronize()
    assert ssm_chain.gated_rmsnorm.launches == before + 2
    want = ssm_chain.gated_rmsnorm_ref(*_fp32((y, xc, z)), d, scale)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, w)
    torch.testing.assert_close(got.float(), want, **BF16_TOL)
    assert torch.equal(got, again)


def test_chain_kernels_refuse_cpu_tensors_and_grad(cuda):
    """A CPU tensor among CUDA ones and an input that requires grad are
    refused before a launch."""
    args, _ = _chain_inputs(cuda, 2, 16, 128, 16, 8, 16)
    before = ssm_chain.conv_silu.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssm_chain.conv_silu(*args[:-1], args[-1].cpu())
    args[-1].requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        ssm_chain.conv_silu(*args)
    assert ssm_chain.conv_silu.launches == before


def _chain_counts():
    return (ssm_chain.conv_silu.launches, ssm_chain.gated_rmsnorm.launches)


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_1_2b"])
def test_ssm_prefill_runs_the_chain_kernels_once_a_layer(cuda, arch):
    """A smoke prefill under inference mode (as ``Engine.generate`` runs
    it) launches each chain kernel once a Mamba-2 layer, and its logits
    stay within 3% relative RMS of the CPU's fp32 path."""
    cfg = get_config(arch, smoke=True)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda _, t: t.to(cuda), params)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 32)).astype(np.int32))
    c0 = _chain_counts()
    with torch.inference_mode():
        got, _ = model_zoo.prefill(cfg, card, toks.to(cuda), 40)
        torch.cuda.synchronize()
        assert _chain_counts() == (c0[0] + cfg.n_layers,
                                   c0[1] + cfg.n_layers)
        want, _ = model_zoo.prefill(cfg.with_(compute_dtype="float32"),
                                    params, toks, 40)
    g, w = got.float().cpu()[:, :cfg.vocab], want[:, :cfg.vocab]
    assert torch.isfinite(g).all()
    assert float((g - w).norm() / w.norm()) < 3e-2


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

# (b, s_max, h, kv, hd, pos): olmo_1b, granite_8b (G 4), llava_next_34b
# (G 7), granite_moe_1b_a400m (hd 64, G 2), stablelm_3b (hd 80),
# phi3_mini (hd 96), the smoke configs' hd 16; pos 0, a middle one and
# the last slot; split grids (few rows and heads) and unsplit ones
DECODE_SHAPES = [
    (32, 640, 16, 16, 128, 639),
    (32, 640, 16, 16, 128, 511),
    (32, 640, 16, 16, 128, 0),
    (4, 640, 32, 8, 128, 575),
    (4, 640, 32, 8, 128, 639),
    (1, 640, 56, 8, 128, 300),
    (1, 640, 56, 8, 128, 0),
    (4, 256, 16, 8, 64, 200),
    (32, 256, 16, 8, 64, 255),
    (1, 300, 32, 32, 80, 131),
    (4, 128, 32, 32, 96, 127),
    (4, 40, 4, 4, 16, 20),
    (1, 40, 4, 2, 16, 39),
    (32, 40, 4, 1, 16, 7),
]


def _at(cuda, pos):
    """A decode position as the caches hold it: a 0-d int32 on the card."""
    return torch.tensor(pos, dtype=torch.int32, device=cuda)


def _decode_inputs(cuda, b, s, h, kv, hd, rope, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = _randn(gen, b, 1, h, hd)
    k, v = _randn(gen, b, 1, kv, hd), _randn(gen, b, 1, kv, hd)
    ck, cv = _randn(gen, b, s, kv, hd), _randn(gen, b, s, kv, hd)
    cfg = get_config("granite_8b").with_(n_heads=h, n_kv_heads=kv,
                                         head_dim=hd)
    return q, k, v, ck, cv, (rope_table(cfg, s, cuda) if rope else None)


@pytest.mark.parametrize("b,s,h,kv,hd,pos", DECODE_SHAPES)
@pytest.mark.parametrize("rope", [True, False])
def test_decode_kernel_matches_plain(cuda, b, s, h, kv, hd, pos, rope):
    """The decode kernel against its plain version on the card: output
    within the forward kernels' 2e-2; the cache row at ``pos`` bitwise the
    plain version's (the same fp32 products and difference of
    ``apply_rope``, rounded once to bf16, from the same table), every
    other slot untouched; one launch counted in its regime, the split
    plan of the cache's capacity."""
    q, k, v, ck, cv, tab = _decode_inputs(cuda, b, s, h, kv, hd, rope)
    pos = _at(cuda, pos)
    want_ck, want_cv = ck.clone(), cv.clone()
    want = decode_attention_ref(q, k, v, want_ck, want_cv, pos, tab)
    splits, _ = split_plan(b, kv, s, _build.sm_count(cuda.index or 0))
    key = "split" if splits > 1 else "no split"
    before = decode_attention.launches
    by = decode_attention.launches_by_regime[key]
    got = decode_attention(q, k, v, ck, cv, pos, tab)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert decode_attention.launches_by_regime[key] == by + 1
    assert got.shape == (b, 1, h * hd) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    assert torch.equal(ck, want_ck) and torch.equal(cv, want_cv)


def test_decode_kernel_splits_at_granite_shape(cuda):
    """granite_8b's decode grid (4 rows x 8 KV heads) splits the keys
    of its 640-slot cache; olmo_1b's (32 x 16) does not."""
    sms = _build.sm_count(cuda.index or 0)
    assert split_plan(4, 8, 640, sms)[0] > 1
    assert split_plan(32, 16, 640, sms)[0] == 1


@pytest.mark.parametrize("b,s,h,kv,hd,pos", [DECODE_SHAPES[0],
                                             DECODE_SHAPES[3],
                                             DECODE_SHAPES[11]])
def test_decode_kernel_is_deterministic(cuda, b, s, h, kv, hd, pos):
    """Two calls on equal inputs give bitwise equal outputs and caches,
    split or not."""
    q, k, v, ck, cv, tab = _decode_inputs(cuda, b, s, h, kv, hd, True)
    pos = _at(cuda, pos)
    ck2, cv2 = ck.clone(), cv.clone()
    y = decode_attention(q, k, v, ck, cv, pos, tab)
    y2 = decode_attention(q, k, v, ck2, cv2, pos, tab)
    assert torch.equal(y, y2)
    assert torch.equal(ck, ck2) and torch.equal(cv, cv2)


def test_rope_table_on_card_is_rope_freqs(cuda):
    """The card's table rows are ``rope_freqs`` at each position on the
    card, bitwise, so the kernel rotates with the plain path's values."""
    cfg = get_config("olmo_1b")
    cos, sin = rope_table(cfg, 640, cuda)
    for p in (0, 1, 255, 511, 639):
        c, s = rope_freqs(cfg, torch.tensor([p], device=cuda))
        assert torch.equal(cos[p], c[0]) and torch.equal(sin[p], s[0])


def test_decode_kernel_raises_for_unsupported_input(cuda):
    """Non-bf16 inputs, groups above 8 query heads, head dims above 128 or
    off the multiples of 8, a RoPE table off the card and a query that
    needs a gradient are refused before a launch."""
    q, k, v, ck, cv, tab = _decode_inputs(cuda, 2, 16, 4, 2, 64, True)
    at = _at(cuda, 3)
    before = decode_attention.launches
    with pytest.raises(ValueError, match="bfloat16"):
        decode_attention(q.float(), k, v, ck, cv, at, tab)
    q9 = torch.zeros(2, 1, 18, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="whole groups"):
        decode_attention(q9, k, v, ck, cv, at, tab)
    for hd in (136, 20):
        t = torch.zeros(2, 1, 2, hd, dtype=torch.bfloat16, device=cuda)
        c = torch.zeros(2, 16, 2, hd, dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            decode_attention(t, t, t, c, c, at)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(q, k, v, ck, cv, at, tuple(t.cpu() for t in tab))
    with pytest.raises(NotImplementedError, match="no backward"):
        decode_attention(q.requires_grad_(), k, v, ck, cv, at, tab)
    assert decode_attention.launches == before


def test_decode_attention_sublayer_makes_no_sync(cuda):
    """A decode step's attention sublayer on one card (projections, the
    kernel, the output projection) makes no host-to-device copy and no
    stream synchronisation, with the position read on the card and
    advanced there as a decode step does: it runs under
    ``set_sync_debug_mode("error")``, which raises on the per-step
    ``torch.tensor([pos])`` copy the torch path made. The first call
    builds the RoPE table and is left out."""
    cfg = get_config("olmo_1b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda _, t: t.to(cuda), attention.init_attn(
        cfg, gen, dtype=torch.bfloat16))
    cache = attention.init_kv_cache(4, 24, cfg.n_kv_heads, cfg.hd,
                                    device=cuda)
    x = torch.randn((4, 1, cfg.d_model), generator=gen).to(
        device=cuda, dtype=torch.bfloat16)
    pos = _at(cuda, 3)
    with torch.inference_mode():
        attention.decode_attention(cfg, params, x, cache, pos)
        pos.add_(1)
        torch.cuda.synchronize()
        before = decode_attention.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                y, _ = attention.decode_attention(cfg, params, x, cache, pos)
                pos.add_(1)
            with pytest.raises(RuntimeError):
                torch.tensor([7], device=cuda)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 3 and int(pos) == 7
    assert y.shape == (4, 1, cfg.d_model) and bool(torch.isfinite(y).all())


def test_dense_lm_card_path_matches_cpu_path(cuda):
    """bf16 kernel path on the card vs fp32 plain path on the CPU, same
    weights: prefill and three decode steps (each fed the CPU's greedy
    token) within 3% relative RMS (bf16 rounding compounded over two
    layers; a wrong kernel is O(1)); every decode step runs the decode
    kernel once per layer."""
    cfg = get_config("granite_8b").with_(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab=1000)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    cpu_cfg = cfg.with_(compute_dtype="float32")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 33)).astype(np.int32))
    eng = Engine(cfg, params, ServeConfig(max_seq=40, max_new_tokens=4),
                 device=cuda)
    flash0, mlp0 = flash_attention.launches, fused_mlp.launches
    pairs = []
    with torch.inference_mode():
        want, cpu_cache = model_zoo.prefill(cpu_cfg, params, toks, 40)
        got, cache = model_zoo.prefill(cfg, eng.params, toks.to(cuda), 40)
        pairs.append((got, want))
        for _ in range(3):
            nxt = torch.argmax(want, -1).to(torch.int32)
            dec0 = decode_attention.launches
            want, cpu_cache = model_zoo.decode_step(cpu_cfg, params,
                                                    cpu_cache, nxt)
            got, cache = model_zoo.decode_step(cfg, eng.params, cache,
                                               nxt.to(cuda))
            assert decode_attention.launches - dec0 == cfg.n_layers
            pairs.append((got, want))
    assert flash_attention.launches - flash0 == cfg.n_layers
    assert fused_mlp.launches - mlp0 == 4 * cfg.n_layers
    for g, w in pairs:
        # real vocab only: padded logits are -1e9 and would swamp the norm
        g, w = g.float().cpu()[:, :cfg.vocab], w[:, :cfg.vocab]
        assert torch.isfinite(g).all()
        assert float((g - w).norm() / w.norm()) < 3e-2
    out = eng.generate(toks.numpy()[:, :32])
    assert out.shape == (2, 4) and ((out >= 0) & (out < cfg.vocab)).all()


def test_mamba2_card_path_matches_cpu_path(cuda):
    """Small-width Mamba-2 (head dim 64, as the kernel takes): bf16 kernel
    path on the card vs fp32 plain path on the CPU, same weights; prefill
    and one decode step within 3% relative RMS. ssd_scan and the chain's
    two kernels run once per layer in prefill and never in decode."""
    cfg = get_config("mamba2_780m").with_(n_layers=2, d_model=256,
                                          ssm_state=64, vocab=1000)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    cpu_cfg = cfg.with_(compute_dtype="float32")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 512)).astype(np.int32))
    eng = Engine(cfg, params, ServeConfig(max_seq=520, max_new_tokens=4),
                 device=cuda)
    with torch.inference_mode():
        want, cpu_cache = model_zoo.prefill(cpu_cfg, params, toks, 520)
        ssd0, chain0 = ssd_scan.launches, _chain_counts()
        got, cache = model_zoo.prefill(cfg, eng.params, toks.to(cuda), 520)
        assert ssd_scan.launches - ssd0 == cfg.n_layers
        assert _chain_counts() == tuple(n + cfg.n_layers for n in chain0)
        nxt = torch.argmax(want, -1).to(torch.int32)
        want_d, _ = model_zoo.decode_step(cpu_cfg, params, cpu_cache, nxt)
        got_d, _ = model_zoo.decode_step(cfg, eng.params, cache,
                                         nxt.to(cuda))
        assert ssd_scan.launches - ssd0 == cfg.n_layers
    for g, w in ((got, want), (got_d, want_d)):
        # real vocab only: padded logits are -1e9 and would swamp the norm
        g, w = g.float().cpu()[:, :cfg.vocab], w[:, :cfg.vocab]
        assert torch.isfinite(g).all()
        assert float((g - w).norm() / w.norm()) < 3e-2
    out = eng.generate(toks.numpy()[:, :256])
    assert out.shape == (2, 4) and ((out >= 0) & (out < cfg.vocab)).all()


# ---------------------------------------------------------------------------
# the serving engine's decode graph (serve/decode_graph.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,kv,hd,pos", [DECODE_SHAPES[0],
                                             DECODE_SHAPES[1],
                                             DECODE_SHAPES[3],
                                             DECODE_SHAPES[4],
                                             DECODE_SHAPES[5],
                                             DECODE_SHAPES[6],
                                             DECODE_SHAPES[11]])
def test_decode_kernel_reads_its_position_on_the_card(cuda, b, s, h, kv, hd,
                                                      pos):
    """``pos`` as a 0-d int32 on the card: the keys split by the cache's
    capacity (granite_8b's grid splits, llava's too), the splits past
    ``pos`` adding nothing; the output within 2e-2 of the plain version;
    the cache row bitwise the plain version's; the position itself
    unchanged; one launch in the cache's regime."""
    q, k, v, ck, cv, tab = _decode_inputs(cuda, b, s, h, kv, hd, True)
    at = _at(cuda, pos)
    want_ck, want_cv = ck.clone(), cv.clone()
    want = decode_attention_ref(q, k, v, want_ck, want_cv, at, tab)
    sms = _build.sm_count(cuda.index or 0)
    full, _ = split_plan(b, kv, s, sms)
    key = "split" if full > 1 else "no split"
    by = decode_attention.launches_by_regime[key]
    got = decode_attention(q, k, v, ck, cv, at, tab)
    torch.cuda.synchronize()
    assert decode_attention.launches_by_regime[key] == by + 1
    assert int(at) == pos
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    assert torch.equal(ck, want_ck) and torch.equal(cv, want_cv)


def test_decode_kernel_refuses_a_wrong_device_position(cuda):
    """A position that is an int, a tensor off the card, of another dtype
    or not 0-d is refused before a launch."""
    q, k, v, ck, cv, tab = _decode_inputs(cuda, 2, 16, 4, 2, 64, True)
    before = decode_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(q, k, v, ck, cv, torch.tensor(3, dtype=torch.int32),
                         tab)
    for bad in (3, torch.tensor(3, device=cuda),
                torch.tensor([3], dtype=torch.int32, device=cuda)):
        with pytest.raises(ValueError, match="0-d int32"):
            decode_attention(q, k, v, ck, cv, bad, tab)
    assert decode_attention.launches == before


def _graph_cfg(kind):
    """A small dense config whose decode grid fills the card's SMs (one
    split of the keys), the same at granite_8b's grid of 4 rows x 8 KV
    heads over a cache of 232 slots (3 splits, the last empty until the
    position passes 191), and a small Mamba-2 one; (config, batch, prompt
    lengths)."""
    if kind.startswith("dense"):
        cfg = get_config("granite_8b").with_(
            n_layers=2, d_model=256, n_heads=8, n_kv_heads=4, d_ff=512,
            vocab=1000)
        if kind == "dense_split":
            cfg = cfg.with_(n_heads=16, n_kv_heads=8)
            return cfg, 4, (200, 120)
        return cfg, -(-_build.sm_count(0) // cfg.n_kv_heads), (40, 24)
    cfg = get_config("mamba2_780m").with_(n_layers=2, d_model=256,
                                          ssm_state=64, ssm_chunk=64,
                                          vocab=1000)
    return cfg, 4, (128, 64)


def _eager_steps(cfg, params, prompt, max_seq, steps):
    """Prefill into a fresh cache of its own and ``steps`` greedy decode
    steps run eagerly, on the card: (logits of each step, tokens)."""
    logits, cache = model_zoo.prefill(cfg, params, prompt, max_seq)
    out, toks = [], []
    for _ in range(steps):
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks.append(tok.cpu().numpy())
        logits, cache = model_zoo.decode_step(cfg, params, cache, tok)
        out.append(logits.clone())
    return out, np.stack(toks, 1)


def _recorded(eng):
    """The logits of every ``eng._decode`` call, copied as it returns
    (a replay rewrites the graph's buffer at the next step)."""
    seen, decode = [], eng._decode

    def spy(params, cache, tok):
        logits, cache = decode(params, cache, tok)
        seen.append(logits.clone())
        return logits, cache

    eng._decode = spy
    return seen


@pytest.mark.parametrize("kind", ["dense", "dense_split", "ssm"])
def test_graphed_decode_is_bitwise_the_eager(cuda, kind):
    """The engine's graphed decode against ``model_zoo``'s eager steps on
    a cache of their own on the card, over 32 steps and two calls of
    other prompt lengths on the engine's kept cache: every step's logits
    and every token bitwise equal, with the decode kernel's keys split or
    not; the launch counters move by what the eager steps move them, by
    regime too; one capture, the other steps replays."""
    cfg, b, lengths = _graph_cfg(kind)
    if kind == "dense_split":
        assert split_plan(b, cfg.n_kv_heads, max(lengths) + 32,
                          _build.sm_count(0)) == (3, 96)
    new = 32
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    scfg = ServeConfig(max_seq=max(lengths) + new, max_new_tokens=new)
    eng = Engine(cfg, params, scfg, device=cuda)
    seen = _recorded(eng)
    rng = np.random.RandomState(0)
    for call, s in enumerate(lengths):
        prompts = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
        dev = torch.from_numpy(prompts).to(cuda)
        with torch.inference_mode():
            c0, r0 = _counts(), dict(decode_attention.launches_by_regime)
            want, want_toks = _eager_steps(cfg, eng.params, dev,
                                           scfg.max_seq, new)
            eager = _delta(c0), _regime_delta(r0)
            c0, r0 = _counts(), dict(decode_attention.launches_by_regime)
            seen.clear()
            got_toks = eng.generate(prompts)
            torch.cuda.synchronize()
            assert (_delta(c0), _regime_delta(r0)) == eager
        graph, = eng._graphs.values()
        assert graph.graph is not None
        assert graph.cache is eng._caches[(b, scfg.max_seq)]
        assert len(seen) == new
        for i in range(new):
            assert torch.equal(seen[i], want[i]), (call, i)
        assert np.array_equal(got_toks, want_toks), call


def _regime_delta(before):
    return {k: v - before[k]
            for k, v in decode_attention.launches_by_regime.items()}


def test_split_regime_under_the_decode_graph_at_granite_grid(cuda):
    """granite_8b.decode's decode grid at small widths: 8 rows x 8 KV
    heads of 4 query heads each, a 640-slot cache cut into 3 splits of 224
    keys on the H100 (two launches a call, the split kernel's workspace
    made inside the capture). Over two calls on the engine's kept cache
    the graphed steps' logits and tokens are bitwise the eager steps' on
    a cache of their own, and every decode attention launch, the replayed
    ones too, is counted as split: by the host counter and by the span
    counter of the profiled calls."""
    from repro_torch.kernels.decode_attn.ops import COUNTER
    from repro_torch.launch import spans
    cfg = get_config("granite_8b").with_(n_layers=2, d_model=512,
                                         n_heads=32, n_kv_heads=8,
                                         head_dim=128, d_ff=512, vocab=1000)
    b, prompt, new, slots = 8, 512, 16, 640
    splits, chunk = split_plan(b, cfg.n_kv_heads, slots, _build.sm_count(0))
    assert splits > 1 and (_build.sm_count(0) != 132
                           or (splits, chunk) == (3, 224))
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(1))
    eng = Engine(cfg, params, ServeConfig(max_seq=slots, max_new_tokens=new),
                 device=cuda)
    seen = _recorded(eng)
    rng = np.random.RandomState(1)
    for call in range(2):
        prompts = rng.randint(0, cfg.vocab, (b, prompt)).astype(np.int32)
        with torch.inference_mode():
            want, want_toks = _eager_steps(
                cfg, eng.params, torch.from_numpy(prompts).to(cuda), slots,
                new)
        seen.clear()
        r0 = dict(decode_attention.launches_by_regime)
        spans.reset_counters()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got_toks = eng.generate(prompts)
        torch.cuda.synchronize()
        launches = cfg.n_layers * new
        assert _regime_delta(r0) == {"no split": 0, "split": launches}
        assert spans.counters()[COUNTER] == [0, launches]
        assert len(seen) == new
        for i in range(new):
            assert torch.equal(seen[i], want[i]), (call, i)
        assert np.array_equal(got_toks, want_toks), call
    graph, = eng._graphs.values()
    assert graph.graph is not None
    spans.reset_counters()


@pytest.mark.parametrize("arch", ["olmo_1b", "mamba2_780m", "zamba2_1_2b"])
def test_decode_graph_captures_and_replays_without_a_sync(cuda, arch):
    """The smoke dense, ssm and hybrid engines capture their decode step
    (a host sync inside it would make the capture raise), and a replay on
    the engine's kept cache, with its token copy, runs under
    ``set_sync_debug_mode("error")``; the counter reads one capture, then
    replays."""
    from repro_torch.launch import spans
    from repro_torch.serve.decode_graph import COUNTER
    cfg = get_config(arch, smoke=True)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(cfg, params, ServeConfig(max_seq=40, max_new_tokens=4),
                 device=cuda)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab, (3, 32)).astype(
        np.int32)
    spans.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = eng.generate(prompts)
    assert spans.counters()[COUNTER] == [3, 1, 0]
    assert out.shape == (3, 4) and ((out >= 0) & (out < cfg.vocab)).all()
    cache = eng._caches[(3, 40)]
    assert eng._graphs[(3, 40)].cache is cache
    tok = torch.zeros(3, dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        eng._prefill(eng.params, eng.batch(prompts), cache=cache)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                logits, _ = eng._decode(eng.params, cache, tok)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(cache["pos"]) == 32 + 3
    assert bool(torch.isfinite(logits[:, :cfg.vocab]).all())


# ---------------------------------------------------------------------------
# training: the kernels under autograd
# ---------------------------------------------------------------------------

def _scaled_close(got, want):
    """The repo's bf16 tolerance on gradients scaled by their largest
    magnitude (tests/test_torch_kernels.py's bf16 backward test)."""
    for g, w in zip(got, want):
        top = w.float().abs().max()
        torch.testing.assert_close(g.float() / top, w.float() / top,
                                   **BF16_TOL)


@pytest.mark.parametrize("m,k,f", [(64, 128, 256), (300, 256, 512)])
def test_fused_mlp_function_grads_match_plain(cuda, m, k, f):
    gen = torch.Generator(device=cuda).manual_seed(4)
    args = (_randn(gen, m, k).requires_grad_(),
            _randn(gen, k, f, scale=k ** -0.5).requires_grad_(),
            _randn(gen, k, f, scale=k ** -0.5).requires_grad_(),
            _randn(gen, f, k, scale=f ** -0.5).requires_grad_())
    dy = _randn(gen, m, k)
    before, bwd = fused_mlp.launches, fused_mlp.bwd_launches
    y = FusedMLP.apply(*args)
    assert fused_mlp.launches == before + 1
    got = torch.autograd.grad(y, args, dy)
    assert fused_mlp.launches == before + 1   # no forward in the backward
    assert fused_mlp.bwd_launches == bwd + 1
    want = torch.autograd.grad(fused_mlp_ref(*args), args, dy)
    _scaled_close(got, want)


def _mlp_args(gen, m, k, f):
    """bf16 x [M, K], W1/W3 [K, F], W2 [F, K] (fan-in scaled) that require
    grad, and dy [M, K]."""
    return ((_randn(gen, m, k).requires_grad_(),
             _randn(gen, k, f, scale=k ** -0.5).requires_grad_(),
             _randn(gen, k, f, scale=k ** -0.5).requires_grad_(),
             _randn(gen, f, k, scale=f ** -0.5).requires_grad_()),
            _randn(gen, m, k))


@pytest.mark.parametrize("m,k,f", [
    (512, 2048, 8192),     # olmo_1b's width, M cut from 8192
    (640, 7168, 20480),    # llava_next_34b's one-step check (576 + 64 rows)
    (128, 64, 128),        # the smoke configs' K 64 (padded to 128)
    (200, 64, 64),         # deepseek smoke's shared expert, both padded
    (1, 256, 512),         # M tails: one row, one 64-row box, past 128
    (64, 256, 512),
    (200, 256, 512),
])
def test_fused_mlp_backward_kernel_matches_plain(cuda, m, k, f):
    """FusedMLP (kernel forward keeping g and u, backward kernels) against
    autograd of ``fused_mlp_ref`` on the same bf16 inputs, each gradient
    scaled by its largest magnitude and held to the repo's bf16 tolerance
    (the kernels round g, u, h, dg and du to bf16, as ``fused_mlp_bwd``
    does); one backward launch counted a call, and no forward launch."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    args, dy = _mlp_args(gen, m, k, f)
    y = FusedMLP.apply(*args)
    before, bwd = fused_mlp.launches, fused_mlp.bwd_launches
    got = torch.autograd.grad(y, args, dy)
    torch.cuda.synchronize()
    assert (fused_mlp.launches, fused_mlp.bwd_launches) == (before, bwd + 1)
    for g_, a in zip(got, args):
        assert g_.shape == a.shape and g_.dtype == torch.bfloat16
        assert bool(torch.isfinite(g_).all())
    want = torch.autograd.grad(fused_mlp_ref(*args), args, dy)
    _scaled_close(got, want)


@pytest.mark.parametrize("m,k,f,split", [
    (640, 7168, 20480, ("dh", "dx")),   # llava_next_34b's train step
    (768, 7168, 20480, ("dx",)),
    (1, 2048, 8192, ("dh", "dx")),      # one row: pieces within a tile
    (8192, 1024, 4096, ()),             # olmo_1b's M, K and F cut
])
def test_fused_mlp_backward_kernel_each_split(cuda, m, k, f, split):
    """Each work split ``bwd_plan`` can choose on the card (stream-K for
    dh and dx, for dx alone, none): the gradients against autograd of
    ``fused_mlp_ref`` within the repo's bf16 tolerance, and two backward
    calls bitwise equal (the partial tiles are added in block order)."""
    plan = mlp_ops.bwd_plan(m, k, f, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert tuple(p.name for p in plan if p.stream_k) == split
    gen = torch.Generator(device=cuda).manual_seed(21)
    args, dy = _mlp_args(gen, m, k, f)
    y = FusedMLP.apply(*args)
    got = torch.autograd.grad(y, args, dy, retain_graph=True)
    again = torch.autograd.grad(y, args, dy, retain_graph=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = torch.autograd.grad(fused_mlp_ref(*args), args, dy)
    _scaled_close(got, want)


def test_fused_mlp_backward_stream_k_on_more_blocks_than_fit(cuda,
                                                             monkeypatch):
    """Stream-K with three times the card's SMs as the grid, so most blocks
    wait for an SM while others run: a block waits only for ranges whose
    blocks took their tickets before it, so the launch completes; the
    gradients against autograd of ``fused_mlp_ref`` within the repo's bf16
    tolerance, two calls bitwise equal."""
    sms = 3 * torch.cuda.get_device_properties(cuda).multi_processor_count
    m, k, f = 256, 1024, 4096
    assert all(p.stream_k for p in mlp_ops.bwd_plan(m, k, f, sms)
               if p.name in ("dh", "dx"))
    gen = torch.Generator(device=cuda).manual_seed(23)
    args, dy = _mlp_args(gen, m, k, f)
    y = FusedMLP.apply(*args)
    monkeypatch.setattr(mlp_ops._build, "sm_count", lambda index=None: sms)
    got = torch.autograd.grad(y, args, dy, retain_graph=True)
    again = torch.autograd.grad(y, args, dy, retain_graph=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = torch.autograd.grad(fused_mlp_ref(*args), args, dy)
    _scaled_close(got, want)


def test_fused_mlp_backward_kernel_is_deterministic(cuda):
    """Two backward calls, and two ``retain_graph`` passes through one
    graph, give the same bits (no atomics; no saved tensor is
    overwritten)."""
    gen = torch.Generator(device=cuda).manual_seed(18)
    args, dy = _mlp_args(gen, 300, 256, 1024)
    y = FusedMLP.apply(*args)
    one = torch.autograd.grad(y, args, dy, retain_graph=True)
    two = torch.autograd.grad(y, args, dy, retain_graph=True)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    x, w1, w3, w2 = (t.detach() for t in args)
    with torch.no_grad():
        _, g, u = mlp_ops._forward(x, w1, w3, w2, keep=True)
    three = fused_mlp_backward(x, w1, w3, w2, dy, g, u)
    four = fused_mlp_backward(x, w1, w3, w2, dy, g, u)
    assert all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(three, four, one))


def test_fused_mlp_forward_keeps_g_and_u(cuda):
    """Under grad the forward stores g = x W1 and u = x W3 in bf16 (the
    prefill kernels at every M, decode-sized too) and its output equals
    the serving forward's bitwise at prefill M."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    for m in (4, 64, 200):
        (x, w1, w3, w2), _ = _mlp_args(gen, m, 256, 512)
        x, w1, w3, w2 = (t.detach() for t in (x, w1, w3, w2))
        y, g, u = mlp_ops._forward(x, w1, w3, w2, keep=True)
        for got, w in ((g, w1), (u, w3)):
            torch.testing.assert_close(got.float(), (x.float() @ w.float()),
                                       **BF16_TOL)
        torch.testing.assert_close(y.float(), fused_mlp_ref(
            x, w1, w3, w2).float(), **BF16_TOL)
        if m > 64:
            assert torch.equal(y, fused_mlp(x, w1, w3, w2))


def test_fused_mlp_backward_refuses_what_it_cannot_take(cuda):
    """The backward kernels take bf16 only, and need the forward's g and
    u; neither falls back to the torch backward."""
    gen = torch.Generator(device=cuda).manual_seed(20)
    (x, w1, w3, w2), dy = _mlp_args(gen, 64, 128, 256)
    x, w1, w3, w2 = (t.detach() for t in (x, w1, w3, w2))
    g = u = torch.zeros((64, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_mlp_backward(*(t.float() for t in (x, w1, w3, w2)),
                           dy.float(), g.float(), u.float())
    with pytest.raises(ValueError, match="forward's g"):
        fused_mlp_backward(x, w1, w3, w2, dy)
    with pytest.raises(ValueError, match="dy must be"):
        fused_mlp_backward(x, w1, w3, w2, dy.float(), g, u)
    with pytest.raises(ValueError, match="bfloat16"):
        FusedMLP.apply(*(t.float().requires_grad_() for t in (x, w1, w3,
                                                              w2)))


@pytest.mark.parametrize("b,s,h,kv,hd", [(2, 128, 4, 2, 64),
                                         (1, 300, 4, 4, 128)])
def test_flash_function_grads_match_plain(cuda, b, s, h, kv, hd):
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = _randn(gen, b, s, h, hd).requires_grad_()
    k, v = (_randn(gen, b, s, kv, hd).requires_grad_() for _ in range(2))
    do = _randn(gen, b, s, h, hd)
    before, bwd = flash_attention.launches, flash_attention.bwd_launches
    y = FlashAttention.apply(q, k, v, True)
    got = torch.autograd.grad(y, (q, k, v), do)
    assert flash_attention.launches == before + 1
    assert flash_attention.bwd_launches == bwd + 1
    want = torch.autograd.grad(attention_ref(q, k, v, True), (q, k, v), do)
    _scaled_close(got, want)


# the training path's attention shapes (chip_smoke.py's check_train_kernels)
# and the head dims and smoke sizes the ops pad: b, sq, skv, h, kv, hd,
# causal
FLASH_BWD_SHAPES = [
    (4, 2048, 2048, 16, 16, 128, True),   # olmo_1b
    (2, 2048, 2048, 16, 8, 64, True),     # granite_moe_1b_a400m, GQA 16/8
    (4, 448, 448, 8, 8, 64, True),        # whisper_base decoder
    (2, 1500, 1500, 8, 8, 64, False),     # whisper_base encoder
    (4, 448, 1500, 8, 8, 64, False),      # whisper_base cross-attention
    (1, 640, 640, 56, 8, 128, True),      # llava_next_34b, GQA 56/8
    (2, 300, 300, 32, 32, 80, True),      # stablelm_3b's hd 80
    (2, 256, 256, 32, 32, 96, True),      # phi3_mini_3_8b's hd 96
    (8, 128, 128, 4, 2, 16, True),        # a smoke train step, hd 16
    (1, 100, 260, 4, 2, 64, True),        # end-aligned Sq < Skv, ragged
    # the dQ order across key tiles: one query tile summed over 32 key
    # tiles (non-causal), and causal Sq < Skv ragged across a 128-key tile
    (1, 64, 4096, 4, 4, 64, False),
    (1, 130, 390, 8, 2, 128, True),
    # a head count that is not a multiple of 4 (the delta pass's groups)
    (1, 100, 260, 6, 3, 64, True),
]


@pytest.mark.parametrize("b,sq,skv,h,kv,hd,causal", FLASH_BWD_SHAPES)
def test_flash_backward_kernel_matches_plain(cuda, b, sq, skv, h, kv, hd,
                                             causal):
    """The backward kernels (through FlashAttention) against autograd of
    the plain version, each gradient scaled by its largest magnitude and
    held to the repo's bf16 tolerance; one backward launch a call; the
    forward's log-sum-exp (log2 units) against the plain one."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q = _randn(gen, b, sq, h, hd).requires_grad_()
    k, v = (_randn(gen, b, skv, kv, hd).requires_grad_() for _ in range(2))
    do = _randn(gen, b, sq, h, hd)
    bwd = flash_attention.bwd_launches
    got = torch.autograd.grad(FlashAttention.apply(q, k, v, causal),
                              (q, k, v), do)
    torch.cuda.synchronize()
    assert flash_attention.bwd_launches == bwd + 1
    for g, t in zip(got, (q, k, v)):
        assert g.shape == t.shape and g.dtype == torch.bfloat16
    want = torch.autograd.grad(attention_ref(q, k, v, causal), (q, k, v), do)
    _scaled_close(got, want)
    if hd in flash_ops.HEAD_DIMS:
        with torch.no_grad():
            _, lse = flash_ops._attend(q, k, v, causal, with_lse=True)
        torch.testing.assert_close(
            lse, attention_lse(q, k, causal) * 1.4426950408889634,
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq,skv,hd,causal", [(63, 63, 80, True),
                                              (129, 200, 96, False),
                                              (200, 200, 16, True)])
def test_flash_backward_kernel_pallas_layout(cuda, sq, skv, hd, causal):
    """The Pallas layout [BH, S, hd] (as B = 1, H = BH through the same
    descriptors) gives the gradients of autograd of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    q = _randn(gen, 8, sq, hd).requires_grad_()
    k, v = (_randn(gen, 4, skv, hd).requires_grad_() for _ in range(2))
    do = _randn(gen, 8, sq, hd)
    got = torch.autograd.grad(FlashAttention.apply(q, k, v, causal),
                              (q, k, v), do)
    want = torch.autograd.grad(attention_ref(q, k, v, causal), (q, k, v), do)
    _scaled_close(got, want)


def _flash_bwd_call(gen, b, sq, skv, h, kv, hd, causal):
    """(inputs, backward) at one shape: the forward kernel's output and
    lse, and a function that runs the backward kernels on them."""
    q = _randn(gen, b, sq, h, hd)
    k, v = _randn(gen, b, skv, kv, hd), _randn(gen, b, skv, kv, hd)
    do = _randn(gen, b, sq, h, hd)
    with torch.no_grad():
        o, lse = flash_ops._attend(q, k, v, causal, with_lse=True)

    def backward():
        with torch.no_grad():
            return flash_attention_backward(q, k, v, o, lse, do, causal)
    return backward


@pytest.mark.parametrize("b,sq,skv,h,kv,hd,causal", [
    (2, 700, 700, 16, 8, 64, True),       # GQA, causal
    (4, 448, 1500, 8, 8, 64, False),      # whisper_base cross-attention
    (1, 640, 640, 56, 8, 128, True),      # llava_next_34b, GQA 56/8
])
def test_flash_backward_kernel_is_deterministic(cuda, b, sq, skv, h, kv, hd,
                                                causal):
    """Two backward calls give the same bits: dq is summed over key tiles
    in an order the semaphores fix, whatever the timing."""
    backward = _flash_bwd_call(torch.Generator(device=cuda).manual_seed(13),
                               b, sq, skv, h, kv, hd, causal)
    one, two = backward(), backward()
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_flash_backward_kernel_resets_its_scratch(cuda):
    """A call made after a call at another shape on the same stream gives
    the bits it gives alone: every call zeroes its semaphores and ticket
    counter and overwrites its dq accumulator."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    first = _flash_bwd_call(gen, 1, 130, 390, 8, 2, 128, True)
    other = _flash_bwd_call(gen, 2, 448, 1500, 8, 8, 64, False)
    alone = first()
    other()
    after = first()
    assert all(torch.equal(a, b) for a, b in zip(alone, after))


SSD_BWD_SHAPES = [   # b, s, h, g, n, p, chunk, with dstate
    (4, 2048, 48, 1, 128, 64, 256, False),   # mamba2_780m's train shape
    (2, 1024, 64, 1, 64, 64, 256, False),    # zamba2_1_2b's geometry
    (2, 512, 4, 2, 128, 64, 64, True),       # chunk 64, grouped B/C
    (1, 300, 4, 2, 24, 64, 100, True),       # ragged chunk, N 24
    (8, 128, 8, 1, 16, 16, 16, False),       # a smoke train step, P 16
]
SSD_GRAD_BF16, SSD_GRAD_FP32 = 8e-3, 1e-4   # chip_smoke.py's limits


@pytest.mark.parametrize("b,s,h,g,n,p,chunk,with_state", SSD_BWD_SHAPES)
def test_ssd_backward_kernel_matches_plain(cuda, b, s, h, g, n, p, chunk,
                                           with_state):
    """The backward kernels (through SSDScan) against autograd of the
    plain chunked form ``ssd_chunked`` (fp32) on the same inputs, each
    gradient scaled by its largest magnitude: dx, dB, dC (bf16) within one
    bf16 step, ddt and dA (fp32) within 1e-4, all finite, one backward
    launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    args = [t.requires_grad_() for t in _ssd_inputs(gen, b, s, h, g, n, p=p)]
    dy = _randn(gen, b, s, h, p)
    dstate = (torch.randn((b, h, n, p), generator=gen, device=cuda)
              if with_state else None)
    bwd = ssd_scan.bwd_launches
    y, state = SSDScan.apply(*args, chunk)
    outs, cots = ((y, state), (dy, dstate)) if with_state else ((y,), (dy,))
    got = torch.autograd.grad(outs, args, cots)
    torch.cuda.synchronize()
    assert ssd_scan.bwd_launches == bwd + 1
    y_ref, state_ref = ssd_chunked(*args, chunk)
    outs = (y_ref, state_ref) if with_state else (y_ref,)
    want = torch.autograd.grad(outs, args, cots)
    for name, gt, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert gt.dtype == w.dtype and bool(torch.isfinite(gt).all()), name
        top = w.float().abs().max()
        limit = SSD_GRAD_BF16 if gt.dtype == torch.bfloat16 \
            else SSD_GRAD_FP32
        torch.testing.assert_close(gt.float() / top, w.float() / top,
                                   rtol=0, atol=limit, msg=name)


def test_ssd_backward_kernel_is_deterministic(cuda):
    """Two backward calls give the same bits (no atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    x, dt, a, bm, cm = _ssd_inputs(gen, 2, 1024, 8, 1, 128)
    dy = _randn(gen, 2, 1024, 8, 64)
    with torch.no_grad():
        kept = ssd_ops._scan(x, dt, a, bm, cm, 256, keep=True)[2]
    one = ssd_scan_backward(x, dt, a, bm, cm, dy, None, 256, kept)
    two = ssd_scan_backward(x, dt, a, bm, cm, dy, None, 256, kept)
    assert all(torch.equal(u, v) for u, v in zip(one, two))


def test_ssd_forward_keeps_chunk_states_for_the_backward(cuda):
    """Under grad the forward keeps the chunks' (cum, dt) pairs and
    previous states (``ssd_scan_keep_bytes``), the same bits as a keeping
    forward run alone, and the backward kernels read them: the gradients
    through autograd equal a direct backward call given that buffer;
    serving keeps nothing; a missing buffer, or one of another size, is
    refused (the backward never runs the forward again)."""
    gen = torch.Generator(device=cuda).manual_seed(22)
    b, s, h, g, n, chunk = 2, 512, 8, 1, 128, 256
    args = [t.requires_grad_() for t in _ssd_inputs(gen, b, s, h, g, n)]
    dy = _randn(gen, b, s, h, 64)
    y, _ = SSDScan.apply(*args, chunk)
    kept = y.grad_fn.saved_tensors[-1]
    _, _, keep_bytes = ssd_ops._bind(_build.load("ssd_scan"))
    assert kept.dtype == torch.uint8
    assert kept.numel() == keep_bytes(b, s, h, n, chunk) > 0
    got = torch.autograd.grad(y, args, dy)
    x, dt, a, bm, cm = (t.detach() for t in args)
    with torch.no_grad():
        alone = ssd_ops._scan(x, dt, a, bm, cm, chunk, keep=True)[2]
        assert ssd_ops._scan(x, dt, a, bm, cm, chunk, keep=False)[2] is None
    assert torch.equal(kept, alone)
    again = ssd_scan_backward(x, dt, a, bm, cm, dy, None, chunk, alone)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    with pytest.raises(ValueError, match="kept must be"):
        ssd_scan_backward(x, dt, a, bm, cm, dy, None, chunk, kept[:-16])
    with pytest.raises(ValueError, match="chunk states the forward kept"):
        ssd_scan_backward(x, dt, a, bm, cm, dy, None, chunk)


def test_backward_kernels_never_call_plain_versions(cuda, monkeypatch):
    """On CUDA tensors the Functions' backwards launch the kernels: the
    plain ``attention_bwd``, ``ssd_scan_bwd`` and ``fused_mlp_bwd`` are
    never called."""
    def refuse(*_, **__):
        raise AssertionError("a plain backward ran on CUDA tensors")

    monkeypatch.setattr(flash_ops, "attention_bwd", refuse)
    monkeypatch.setattr(ssd_ops, "ssd_scan_bwd", refuse)
    monkeypatch.setattr(mlp_ops, "fused_mlp_bwd", refuse)
    gen = torch.Generator(device=cuda).manual_seed(16)
    q = _randn(gen, 2, 128, 4, 64).requires_grad_()
    k, v = (_randn(gen, 2, 128, 2, 64).requires_grad_() for _ in range(2))
    FlashAttention.apply(q, k, v, True).float().sum().backward()
    args = [t.requires_grad_() for t in _ssd_inputs(gen, 1, 256, 4, 1, 64)]
    SSDScan.apply(*args, 128)[0].float().sum().backward()
    mlp_args, _ = _mlp_args(gen, 100, 128, 256)
    FusedMLP.apply(*mlp_args).float().sum().backward()
    assert all(t.grad is not None for t in (q, k, v, *args, *mlp_args))


def test_raw_kernels_refuse_to_drop_gradients(cuda):
    """A raw wrapper called under grad with an input that requires grad
    raises instead of launching (its output would carry no grad_fn);
    the same call under no_grad launches."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = _randn(gen, 64, 128).requires_grad_()
    w = _randn(gen, 128, 128)
    with pytest.raises(NotImplementedError, match="FusedMLP.apply"):
        fused_mlp(x, w, w, w)
    q = _randn(gen, 1, 64, 2, 64).requires_grad_()
    with pytest.raises(NotImplementedError, match="FlashAttention.apply"):
        flash_attention(q, q, q)
    xs, dt, a, bm, cm = _ssd_inputs(gen, 1, 64, 2, 1, 16)
    with pytest.raises(NotImplementedError, match="SSDScan.apply"):
        ssd_scan(xs.requires_grad_(), dt, a, bm, cm)
    with torch.no_grad():
        fused_mlp(x, w, w, w)
        flash_attention(q, q, q)
        ssd_scan(xs, dt, a, bm, cm)


@pytest.mark.parametrize("b,s,h,g,n,p,chunk", [
    (2, 512, 4, 1, 128, 64, 256),   # mamba2_780m's head geometry and chunk
    (1, 256, 8, 2, 64, 64, 64),     # grouped, zamba2's state size
    (2, 64, 4, 1, 16, 16, 16),      # the smoke configs' padded P = 16
])
def test_ssd_function_grads_match_plain(cuda, b, s, h, g, n, p, chunk):
    """SSDScan (kernel forward, kernel backward) against autograd of the
    plain chunked form ``ssd_chunked`` on the same inputs: the backward
    reads no kernel output, so it differs from that autograd by fp32 sums
    in another order, bf16 hi/lo state operands and one bf16 rounding of
    dx, dB, dC; every gradient is finite (dt ~ softplus(N(0,1)) at chunk
    256 overflows exp above the diagonal, which the masked decay never
    reaches)."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    args = [t.requires_grad_() for t in _ssd_inputs(gen, b, s, h, g, n, p=p)]
    dy = _randn(gen, b, s, h, p)
    dstate = torch.randn((b, h, n, p), generator=gen, device=cuda)
    before, bwd = ssd_scan.launches, ssd_scan.bwd_launches
    y, state = SSDScan.apply(*args, chunk)
    got = torch.autograd.grad((y, state), args, (dy, dstate))
    assert ssd_scan.launches == before + 1
    assert ssd_scan.bwd_launches == bwd + 1
    y_ref, state_ref = ssd_chunked(*args, chunk)
    want = torch.autograd.grad((y_ref, state_ref), args, (dy, dstate))
    for g_, w in zip(got, want):
        assert g_.dtype == w.dtype and bool(torch.isfinite(g_).all())
    _scaled_close(got, want)


def _train_launches(cfg, policy="full"):
    """Kernel launches of one train step: every attention block, MLP and
    Mamba-2 layer runs its kernel in the forward and again in the remat
    recompute, except the MLP under "mlp", which keeps its input; every
    attention block, MLP and Mamba-2 layer runs its backward kernel once.
    An MoE layer's only fused MLP is its shared expert (deepseek)."""
    if cfg.is_ssm_family:
        blocks = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        mlps, ssd = blocks, 2 * cfg.n_layers
    else:
        blocks, ssd = cfg.n_layers, 0
        mlps = blocks if cfg.family != "moe" or cfg.n_shared_experts else 0
    return {"flash": 2 * blocks, "mlp": (1 if policy == "mlp" else 2) * mlps,
            "ssd": ssd, "decode": 0, "flash_bwd": blocks, "mlp_bwd": mlps,
            "ssd_bwd": ssd // 2}


FORWARD = ("flash", "mlp", "ssd", "decode")  # forward kernel counters
NO_BWD = {"flash_bwd": 0, "mlp_bwd": 0, "ssd_bwd": 0}  # what serving launches


def _counts():
    return {"flash": flash_attention.launches, "mlp": fused_mlp.launches,
            "ssd": ssd_scan.launches, "decode": decode_attention.launches,
            "flash_bwd": flash_attention.bwd_launches,
            "mlp_bwd": fused_mlp.bwd_launches,
            "ssd_bwd": ssd_scan.bwd_launches}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


def test_mamba2_train_step_raises_on_card(cuda):
    """The ssm family's train step on the card: mamba2_780m at one layer
    and d_model 256 (4 heads of 64, N = 128), at its own chunk 256 and S =
    512, where the reference's chunked gradient is NaN: SSDScan runs the
    kernel in the forward and the remat recompute, and every gradient leaf
    is finite and non-zero."""
    cfg = get_config("mamba2_780m").with_(n_layers=1, d_model=256,
                                          vocab=1000)
    params = model_zoo.init_params(cfg, torch.Generator(
        device=cuda).manual_seed(0))
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 513)).astype(np.int32)).to(cuda)
    before = _counts()
    loss, _, grads = value_and_grad(cfg, params, {"tokens": toks[:, :-1],
                                                  "labels": toks[:, 1:]})
    torch.cuda.synchronize()
    assert _delta(before) == _train_launches(cfg)
    assert torch.isfinite(loss)
    tree_map(lambda path, g: None if (bool(torch.isfinite(g).all()) and bool(
        g.abs().sum() > 0)) else pytest.fail(f"{path}: {g.abs().sum()}"),
        grads)


@pytest.mark.parametrize("policy,mlp_per_layer", [("full", 2), ("dots", 2),
                                                  ("mlp", 1)])
def test_card_train_step_launches_and_gradients(cuda, policy, mlp_per_layer):
    """One card train step of olmo_1b_smoke (hd 16, K 64: padded inside
    the kernels' ops) runs flash twice per layer (forward and remat
    recompute) and its backward kernel once, and the fused MLP twice
    (once under "mlp", which keeps the MLP's input) and its backward
    kernels once; every projection and
    MLP weight of every layer gets a non-zero gradient; the policies
    agree."""
    cfg = get_config("olmo_1b", smoke=True).with_(remat_policy=policy)
    params = tree_map(lambda _, t: t.to(cuda), model_zoo.init_params(
        cfg, torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 65)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    f0, m0 = flash_attention.launches, fused_mlp.launches
    b0, mb0 = flash_attention.bwd_launches, fused_mlp.bwd_launches
    loss, _, grads = value_and_grad(cfg, params, batch)
    torch.cuda.synchronize()
    assert flash_attention.launches - f0 == 2 * cfg.n_layers
    assert fused_mlp.launches - m0 == mlp_per_layer * cfg.n_layers
    assert flash_attention.bwd_launches - b0 == cfg.n_layers
    assert fused_mlp.bwd_launches - mb0 == cfg.n_layers
    assert torch.isfinite(loss)
    for name in ("wq", "wk", "wv", "wo"):
        assert (grads["layers"]["attn"][name].flatten(1).abs().sum(1)
                > 0).all(), name
    for name in ("w1", "w3", "w2"):
        assert (grads["layers"]["mlp"][name].flatten(1).abs().sum(1)
                > 0).all(), name


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_1_2b"])
@pytest.mark.parametrize("policy", ["full", "dots", "mlp"])
def test_ssm_train_step_launches_under_each_policy(cuda, arch, policy):
    """The smoke ssm and hybrid configs' card train step (P 16, hd 16,
    K 64: padded inside the ops): ssd_scan runs twice per Mamba-2 layer
    under every policy (the Mamba-2 sublayer is always recomputed) and its
    backward kernel once, the hybrid's shared block as the dense layers do
    (one flash backward a firing); the loss and gradients are finite, and
    the policies give the same loss."""
    cfg = get_config(arch, smoke=True).with_(remat_policy=policy)
    params = tree_map(lambda _, t: t.to(cuda), model_zoo.init_params(
        cfg, torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 65)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before, chain = _counts(), _chain_counts()
    loss, _, grads = value_and_grad(cfg, params, batch)
    torch.cuda.synchronize()
    assert _delta(before) == _train_launches(cfg, policy)
    assert _chain_counts() == chain    # training keeps the torch chain
    full, _, _ = value_and_grad(cfg.with_(remat_policy="full"), params,
                                batch)
    assert torch.isfinite(loss) and float(loss) == float(full)
    tree_map(lambda path, g: None if bool(torch.isfinite(g).all())
             else pytest.fail(path), grads)


def test_olmo_smoke_trains_on_card(cuda):
    """Two Trainer steps on the card (olmo_1b_smoke as registered) lower
    the loss, through both kernels in each step."""
    cfg = get_config("olmo_1b", smoke=True)
    tr = Trainer(cfg, OptimizerConfig(lr=3e-3, warmup_steps=0,
                                      total_steps=2),
                 TrainerConfig(steps=2, log_every=1),
                 DataConfig(batch=4, seq=64), device=cuda)
    f0, m0 = flash_attention.launches, fused_mlp.launches
    mb0 = fused_mlp.bwd_launches
    tr.run()
    losses = [h["loss"] for h in tr.metrics_history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[1] < losses[0]
    assert flash_attention.launches - f0 == 2 * 2 * cfg.n_layers
    assert fused_mlp.launches - m0 == 2 * 2 * cfg.n_layers
    assert fused_mlp.bwd_launches - mb0 == 2 * cfg.n_layers


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_1_2b"])
def test_ssm_smoke_trains_on_card(cuda, arch):
    """Two Trainer steps on the card of the ssm and hybrid smoke configs
    as registered lower the loss, through their kernels in each step."""
    cfg = get_config(arch, smoke=True)
    tr = Trainer(cfg, OptimizerConfig(lr=3e-3, warmup_steps=0,
                                      total_steps=2),
                 TrainerConfig(steps=2, log_every=1),
                 DataConfig(batch=4, seq=64), device=cuda)
    before = _counts()
    tr.run()
    losses = [h["loss"] for h in tr.metrics_history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[1] < losses[0]
    assert _delta(before) == {k: 2 * v for k, v in
                              _train_launches(cfg).items()}


@pytest.mark.parametrize("arch", ["olmo_1b", "mamba2_780m", "zamba2_1_2b",
                                  "granite_moe_1b_a400m", "deepseek_moe_16b"])
def test_launchers_defaults_run_on_card(cuda, arch, capsys):
    """``launch.train`` and ``launch.serve`` with their defaults (the
    smoke config on cuda) train 2 steps and serve 4 prompts through the
    kernels."""
    cfg = get_config(arch, smoke=True)
    before = _counts()
    train_launcher.main(["--arch", arch, "--steps", "2"])
    assert _delta(before) == {k: 2 * v for k, v in
                              _train_launches(cfg).items()}
    capsys.readouterr()
    before = _counts()
    serve_launcher.main(["--arch", arch])
    out = capsys.readouterr().out
    assert out.count("seq") == 4
    launched = _delta(before)
    assert all(launched[k] > 0 for k, v in _train_launches(cfg).items()
               if v and k in FORWARD), launched
    assert {k: launched[k] for k in NO_BWD} == NO_BWD   # serving
    # every decode step of an attention model runs the decode kernel
    assert (launched["decode"] > 0) == (cfg.n_heads > 0), launched


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE = ["granite_moe_1b_a400m", "deepseek_moe_16b"]


@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_card_matches_cpu(cuda, arch):
    """One MoE layer of the smoke config (deepseek's shared expert K 64 F
    64, padded inside the fused MLP op): the card's bf16 path against the
    CPU's fp32 path on the same bf16 inputs and weights. The fp32 router
    sees the same x on both, so the routes are equal; y within the repo's
    bf16 tolerance, aux within 1e-5 relative. The shared expert is the
    layer's one kernel launch."""
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(0)
    params = mlp.init_moe(cfg, gen, dtype=torch.bfloat16)
    x = torch.randn((2, 96, cfg.d_model), generator=gen).to(torch.bfloat16)
    card = tree_map(lambda _, t: t.to(cuda), params)
    before = _counts()
    with torch.inference_mode():
        y, aux = mlp.moe(cfg, card, x.to(cuda))
        torch.cuda.synchronize()
        launched = _delta(before)
        route = mlp._route(cfg, card, x.to(cuda).reshape(1, -1, cfg.d_model))
        cpu = tree_map(lambda _, t: t.float(), params)
        want_y, want_aux = mlp.moe(cfg, cpu, x.float())
        want_route = mlp._route(cfg, cpu, x.float().reshape(
            1, -1, cfg.d_model))
    assert launched == {"flash": 0, "mlp": int(bool(cfg.n_shared_experts)),
                        "ssd": 0, "decode": 0, **NO_BWD}
    for i in (2, 3, 4):             # gate_idx, pos, keep
        assert torch.equal(route[i].cpu(), want_route[i])
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
    torch.testing.assert_close(y.float().cpu(), want_y, **BF16_TOL)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=0)


def test_dropless_moe_layer_card_matches_cpu(cuda):
    """The dropless MoE layer (deepseek's smoke widths, 4 of 8 experts
    held, top 3 unnormalised) under autograd: one fused MLP launch forward
    and one backward per held expert that has rows, and the shared
    expert's; the bf16 output and the gradients of x and of every weight
    within the repo's bf16 tolerance (over each tensor's largest entry) of
    the CPU's fp32 path on the same bf16 inputs; two calls bitwise
    equal."""
    cfg = get_config("deepseek_moe_16b", smoke=True).with_(
        n_experts=8, experts_held=4, top_k=3, moe_norm_topk=False,
        moe_impl="dropless")
    gen = torch.Generator().manual_seed(0)
    params = mlp.init_moe(cfg, gen, dtype=torch.bfloat16)
    x = torch.randn((2, 96, cfg.d_model), generator=gen).to(torch.bfloat16)

    def run(tree, xx):
        leaves = tree_map(lambda _, t: t.clone().requires_grad_(), tree)
        xx = xx.clone().requires_grad_()
        y, aux = mlp.moe(cfg, leaves, xx)
        (y.float().square().sum() + aux).backward()
        grads = {}
        tree_map(lambda path, t: grads.__setitem__(path, t.grad), leaves)
        return y.detach(), xx.grad, grads

    card = tree_map(lambda _, t: t.to(cuda), params)
    before = _counts()
    y, dx, grads = run(card, x.to(cuda))
    torch.cuda.synchronize()
    launched = _delta(before)
    again = run(card, x.to(cuda))
    want = run(tree_map(lambda _, t: t.float(), params), x.float())
    idx = torch.topk(torch.softmax(x.float().reshape(-1, cfg.d_model)
                                   @ params["router"].float(), -1),
                     cfg.top_k, -1).indices
    experts = len(torch.unique(idx[idx < cfg.experts_held]))
    assert launched["mlp"] == launched["mlp_bwd"] == experts + 1, launched
    assert torch.equal(y, again[0]) and torch.equal(dx, again[1])
    assert all(torch.equal(grads[k], again[2][k]) for k in grads)
    torch.testing.assert_close(y.float().cpu(), want[0], **BF16_TOL)
    for got, ref in [(dx, want[1])] + [(grads[k], want[2][k])
                                       for k in grads]:
        scale = float(ref.abs().max())
        assert float((got.float().cpu() - ref).abs().max()) <= 2e-2 * scale


@pytest.mark.parametrize("router_aux", ["gshard", "seq"])
def test_dropless_moe_waits_for_the_card_once(cuda, router_aux):
    """The dropless MoE layer's one wait for the card is the event before
    its read of the segments' sizes: forward and backward, balance loss
    on, run under ``set_sync_debug_mode("error")``, which raises on any
    other synchronising operation (a bincount reads its input's maximum
    back to size its output). The first call builds the kernels."""
    cfg = get_config("deepseek_moe_16b", smoke=True).with_(
        n_experts=8, experts_held=4, top_k=3, moe_norm_topk=False,
        moe_impl="dropless", router_aux=router_aux, router_aux_coef=0.01)
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda _, t: t.to(cuda).requires_grad_(),
                      mlp.init_moe(cfg, gen, dtype=torch.bfloat16))
    x = torch.randn((2, 96, cfg.d_model), generator=gen).to(
        device=cuda, dtype=torch.bfloat16).requires_grad_()
    for debug in (0, "error"):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode(debug)
        try:
            y, aux = mlp.moe(cfg, params, x)
            (y.float().square().sum() + aux).backward()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert float(aux.detach()) > 0 and bool(torch.isfinite(x.grad).all())


@pytest.mark.parametrize("arch", MOE)
def test_moe_smoke_serves_on_card(cuda, arch):
    """The smoke MoE Engine on the card: flash once per layer in prefill,
    deepseek's shared expert once per layer in prefill and in every
    decode step; greedy tokens in range."""
    cfg = get_config(arch, smoke=True)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(cfg, params, ServeConfig(max_seq=40, max_new_tokens=4),
                 device=cuda)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab, (3, 32)).astype(
        np.int32)
    before = _counts()
    out = eng.generate(prompts)
    torch.cuda.synchronize()
    shared = int(bool(cfg.n_shared_experts))
    # one prefill and 4 decode steps (the Engine runs one per new token)
    assert _delta(before) == {"flash": cfg.n_layers,
                              "mlp": shared * cfg.n_layers * 5, "ssd": 0,
                              "decode": cfg.n_layers * 4, **NO_BWD}
    assert out.shape == (3, 4) and ((out >= 0) & (out < cfg.vocab)).all()


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("policy", ["full", "dots", "mlp"])
def test_moe_train_step_on_card(cuda, arch, policy):
    """One card train step of the MoE smoke configs: flash twice per layer
    (forward and recompute), the shared expert's fused MLP twice (once
    under "mlp"); the loss and every gradient are finite, every
    kernel-fed weight (attention, the shared expert) and the router and
    experts of every layer get a non-zero gradient, and the policies give
    the same loss."""
    cfg = get_config(arch, smoke=True).with_(remat_policy=policy)
    params = tree_map(lambda _, t: t.to(cuda), model_zoo.init_params(
        cfg, torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 65)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before = _counts()
    loss, metrics, grads = value_and_grad(cfg, params, batch)
    torch.cuda.synchronize()
    assert _delta(before) == _train_launches(cfg, policy)
    full, _, _ = value_and_grad(cfg.with_(remat_policy="full"), params,
                                batch)
    assert torch.isfinite(loss) and float(loss) == float(full)
    assert float(metrics["aux"]) > 0
    tree_map(lambda path, g: None if bool(torch.isfinite(g).all())
             else pytest.fail(path), grads)
    fed = {f"attn/{n}": grads["layers"]["attn"][n]
           for n in ("wq", "wk", "wv", "wo")}
    fed.update({f"moe/{n}": g for n, g in grads["layers"]["moe"].items()
                if n != "shared"})
    fed.update({f"moe/shared/{n}": g for n, g in
                grads["layers"]["moe"].get("shared", {}).items()})
    for name, g in fed.items():
        assert (g.flatten(1).abs().sum(1) > 0).all(), name


def _mesh_step_is_meshless(cuda, tmp_path, arch):
    """One smoke train step of ``arch`` on a one-rank NCCL group's (1, 1)
    mesh (params, ZeRO moments and batch DTensors; the kernels behind
    ``local_call``) against the meshless step: bitwise equal, with the
    same kernel launches, which are ``_train_launches``'."""
    import torch.distributed as dist
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.optimizer import init_opt_state
    cfg = get_config(arch, smoke=True)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (4, 65)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def fresh():
        return tree_map(lambda _, t: t.to(cuda), model_zoo.init_params(
            cfg, torch.Generator().manual_seed(0)))
    params = fresh()
    before = _counts()
    p1, o1, m1 = make_train_step(cfg, opt)(params, init_opt_state(params),
                                           batch)
    torch.cuda.synchronize()
    plain = _delta(before)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_host_mesh(data=1, model=1, device_type="cuda")
        params = fresh()
        pspecs = sharding.param_specs(params, mesh)
        ospecs = sharding.opt_state_specs(pspecs, params, mesh)
        dp = sharding.distribute(params, pspecs, mesh)
        before = _counts()
        p2, o2, m2 = make_train_step(cfg, opt)(
            dp, init_opt_state(dp, sharding.spec_placements(ospecs, mesh)),
            sharding.distribute(batch, sharding.batch_specs(
                cfg, 4, mesh, "train"), mesh))
        torch.cuda.synchronize()
        meshed = _delta(before)
        got = sharding.gather({"params": p2, "mu": o2["mu"],
                               "nu": o2["nu"]})
    finally:
        dist.destroy_process_group()
    assert plain == meshed == _train_launches(cfg), (plain, meshed)
    assert {k: float(v) for k, v in m1.items()} == \
        {k: float(v) for k, v in m2.items()}
    want = {"params": p1, "mu": o1["mu"], "nu": o1["nu"]}
    tree_map(lambda path, t: None if torch.equal(
        t, tree_get(want, path)) else pytest.fail(path), got)
    return meshed


def test_moe_mesh_step_at_world_size_one_is_meshless(cuda, tmp_path):
    """granite_moe_1b_a400m smoke: one train step on a one-rank NCCL
    group's (1, 1) mesh (params, ZeRO moments and batch DTensors; the MoE
    layer's three local_calls) is bitwise the meshless step, with the
    same kernel launches (flash twice a layer: forward and recompute)."""
    _mesh_step_is_meshless(cuda, tmp_path, "granite_moe_1b_a400m")


def test_dense_mesh_step_launches_mlp_backward_through_local_call(
        cuda, tmp_path):
    """olmo_1b smoke on the (1, 1) mesh: ``_swiglu_sharded`` reaches the
    fused MLP through ``local_call``, and its backward kernels launch
    there once per layer, as in the meshless step, which it equals
    bitwise."""
    cfg = get_config("olmo_1b", smoke=True)
    meshed = _mesh_step_is_meshless(cuda, tmp_path, "olmo_1b")
    assert meshed["mlp_bwd"] == cfg.n_layers > 0


# ---------------------------------------------------------------------------
# encoder-decoder and VLM
# ---------------------------------------------------------------------------

def _serve_launches(cfg, decode_steps):
    """Kernel launches of one prefill and ``decode_steps`` decode steps.
    whisper: the encoder once (enc_layers non-causal blocks) and each
    decoder layer's causal self- and non-causal cross-attention in
    prefill, GELU MLPs (no kernel), in decode the decode kernel for each
    decoder layer's self-attention (its cross-attention reads the cache
    in torch); llava: one flash per layer in prefill, one fused MLP per
    layer and step, one decode kernel per layer and decode step."""
    decode = cfg.n_layers * decode_steps
    if cfg.family == "audio":
        return {"flash": cfg.enc_layers + 2 * cfg.n_layers, "mlp": 0,
                "ssd": 0, "decode": decode, **NO_BWD}
    return {"flash": cfg.n_layers, "mlp": cfg.n_layers * (1 + decode_steps),
            "ssd": 0, "decode": decode, **NO_BWD}


@pytest.mark.parametrize("arch", ["whisper_base", "llava_next_34b"])
def test_encdec_vlm_smoke_serve_on_card(cuda, arch):
    """The smoke Engine on the card (heads of 16 padded inside the flash
    op, llava's K 64 inside the fused MLP's): the kernels launch as the
    model runs them, and the greedy tokens are in range (whisper's may
    fall in the padded vocab, which encdec does not mask)."""
    cfg = get_config(arch, smoke=True)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(cfg, params, ServeConfig(max_seq=40, max_new_tokens=4),
                 device=cuda)
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab, (3, 32)).astype(np.int32)
    frames = (rng.randn(3, cfg.enc_frames, cfg.d_model).astype(np.float32)
              if cfg.family == "audio" else None)
    before = _counts()
    by_regime = dict(flash_attention.launches_by_regime)
    out = eng.generate(prompts, frames)
    torch.cuda.synchronize()
    assert _delta(before) == _serve_launches(cfg, 4)
    # whisper: decoder self causal, encoder non-causal Sq == Skv, cross
    # non-causal Sq != Skv; llava: every block causal
    want = ((cfg.n_layers, cfg.enc_layers, cfg.n_layers)
            if cfg.family == "audio" else (cfg.n_layers, 0, 0))
    assert {r: n - by_regime[r] for r, n in
            flash_attention.launches_by_regime.items()} == dict(
        zip(REGIMES, want))
    top = cfg.padded_vocab if cfg.family == "audio" else cfg.vocab
    assert out.shape == (3, 4) and ((out >= 0) & (out < top)).all()


@pytest.mark.parametrize("arch", ["whisper_base", "llava_next_34b"])
def test_encdec_vlm_card_prefill_matches_cpu(cuda, arch):
    """Smoke prefill logits, card bf16 kernels vs the CPU's fp32 path on
    the same weights (whisper with its frames), within 3% relative RMS,
    as the dense LM's (bf16 rounding compounded over the layers; a wrong
    kernel is O(1))."""
    cfg = get_config(arch, smoke=True)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda _, t: t.to(cuda), params)
    rng = np.random.RandomState(1)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 16)).astype(
        np.int32))
    frames = (torch.from_numpy(rng.randn(2, cfg.enc_frames, cfg.d_model)
                               .astype(np.float32))
              if cfg.family == "audio" else None)
    with torch.inference_mode():
        got, _ = model_zoo.prefill(cfg, card, toks.to(cuda), 24,
                                   frames=None if frames is None
                                   else frames.to(cuda))
        want, _ = model_zoo.prefill(cfg.with_(compute_dtype="float32"),
                                    params, toks, 24, frames=frames)
    g, w = got.float().cpu()[:, :cfg.vocab], want[:, :cfg.vocab]
    assert torch.isfinite(g).all()
    assert float((g - w).norm() / w.norm()) < 3e-2


@pytest.mark.parametrize("arch", ["whisper_base", "llava_next_34b"])
def test_encdec_vlm_serve_launcher_defaults_on_card(cuda, arch, capsys):
    """``launch.serve --arch whisper_base|llava_next_34b`` with its
    defaults (smoke config, cuda, 4 prompts, 16 new tokens) serves through
    the kernels; whisper's frames come from the seed."""
    cfg = get_config(arch, smoke=True)
    before = _counts()
    serve_launcher.main(["--arch", arch])
    assert capsys.readouterr().out.count("seq") == 4
    assert _delta(before) == _serve_launches(cfg, 16)


# AdamW's two passes (kernels/adamw)

# olmo_1b's leaves (embed, final_norm, the stacked norms, attention and
# MLP weights; unembed is embed's shape transposed), then ragged ones
OLMO_LEAVES = [(50688, 2048), (2048,), (16, 2048), (16, 2048, 2048),
               (16, 2048, 8192)]
RAGGED_LEAVES = [(1,), (3,), (4 * 1000 + 3,), (16384 + 5,), (2, 3, 5)]


def _adamw_leaf(gen, shape, pd, gd, offset=0):
    """p (pd), g (gd), m and v (fp32, v > 0) on the card, as a few steps
    in; ``offset`` elements into their storage, so an offset of 1 starts
    each off its 16-byte alignment (the kernel's element-by-element
    path)."""
    n = int(np.prod(shape))

    def draw(dtype, scale=1.0):
        t = torch.randn(n + offset, generator=gen, device=gen.device)
        return (t * scale).to(dtype)[offset:].view(shape)

    return (draw(pd), draw(gd, 3.0), draw(torch.float32, 0.1),
            draw(torch.float32, 0.01).abs())


def _adamw_scalars(dev, cfg, k=3, scale=0.43):
    """(scale, lr, bc1, bc2) of step ``k``, fp32 on the card, as
    ``adamw_update`` computes them."""
    step = torch.tensor(k, dtype=torch.int32, device=dev)
    t = step.to(torch.float32)
    return (torch.tensor(scale, device=dev), lr_schedule(cfg, step),
            1 - torch.pow(cfg.b1, t), 1 - torch.pow(cfg.b2, t))


@pytest.mark.parametrize("shape,pd,gd,offset", [
    *((s, "float32", "float32", 0) for s in OLMO_LEAVES),
    *((s, pd, gd, off) for s in RAGGED_LEAVES
      for pd, gd in (("float32", "float32"), ("bfloat16", "float32"),
                     ("float32", "bfloat16"), ("bfloat16", "bfloat16"))
      for off in (0, 1)),
])
def test_adamw_step_kernel_is_bitwise_the_plain_version(cuda, shape, pd, gd,
                                                        offset):
    """One launch gives the plain version's p, m and v on the card bit for
    bit, given the same scale, lr and bias corrections: at olmo_1b's leaf
    shapes and at ragged ones, p and g fp32 or bf16, aligned or not."""
    cfg = OptimizerConfig()
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + offset)
    p, g, m, v = _adamw_leaf(gen, shape, getattr(torch, pd),
                             getattr(torch, gd), offset)
    want = [t.clone() for t in (p, m, v)]
    scalars = _adamw_scalars(cuda, cfg)
    before = adamw_ops.adamw_step.launches
    adamw.adamw_step(cfg, p, g, m, v, *scalars)
    adamw.adamw_step_ref(cfg, want[0], g, want[1], want[2], *scalars)
    torch.cuda.synchronize()
    assert adamw_ops.adamw_step.launches == before + 1
    for name, got, w in zip("pmv", (p, m, v), want):
        assert got.dtype == w.dtype
        assert torch.equal(got, w), (name, float((got.float() - w.float())
                                                 .abs().max()))


def test_adamw_sumsq_kernel_norm_scale_and_bits(cuda):
    """The clip's pass over olmo_1b's leaves and ragged ones (bf16,
    unaligned and empty ones too): the norm within 1e-5 relative of a
    float64 sum, the scale min(clip / norm, 1), and two calls the same
    bits."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    leaves = [_adamw_leaf(gen, s, torch.float32, torch.float32)[1]
              for s in OLMO_LEAVES]
    leaves += [_adamw_leaf(gen, s, torch.float32, dt, off)[1]
               for s in RAGGED_LEAVES
               for dt, off in ((torch.bfloat16, 0), (torch.float32, 1))]
    leaves.append(torch.zeros(0, device=cuda))
    want = float(np.sqrt(sum(float(torch.sum(g.double() ** 2))
                             for g in leaves)))
    before = adamw_ops.adamw_sumsq.launches
    for clip in (1.0, 1e9):
        norm, scale = adamw.adamw_sumsq(leaves, clip)
        again, scale2 = adamw.adamw_sumsq(leaves, clip)
        torch.cuda.synchronize()
        assert norm.shape == () and norm.device == leaves[0].device
        assert abs(float(norm) - want) <= 1e-5 * want
        assert torch.equal(norm, again) and torch.equal(scale, scale2)
        assert float(scale) == pytest.approx(min(clip / float(norm), 1.0),
                                             rel=1e-6)
    assert adamw_ops.adamw_sumsq.launches == before + 4


def test_adamw_kernels_refuse_strided_and_other_dtypes(cuda):
    cfg = OptimizerConfig()
    scalars = _adamw_scalars(cuda, cfg)
    z = torch.zeros((64, 32), device=cuda)
    before = (adamw_ops.adamw_step.launches, adamw_ops.adamw_sumsq.launches)
    with pytest.raises(ValueError, match="contiguous"):
        adamw.adamw_step(cfg, z.t(), z.t().clone(), z.t().clone(),
                         z.t().clone(), *scalars)
    with pytest.raises(ValueError, match="contiguous"):
        adamw.adamw_step(cfg, z.clone(), torch.zeros((32, 64),
                                                     device=cuda).t(),
                         z.clone(), z.clone(), *scalars)
    with pytest.raises(ValueError, match="float16"):
        adamw.adamw_step(cfg, z.half(), z.clone(), z.clone(), z.clone(),
                         *scalars)
    with pytest.raises(ValueError, match="contiguous"):
        adamw.adamw_sumsq([z, z.t()], 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        adamw.adamw_sumsq([z, z.cpu()], 1.0)
    assert (adamw_ops.adamw_step.launches,
            adamw_ops.adamw_sumsq.launches) == before


def _adamw_tree(gen):
    shapes = {"a": (2048, 512), "b": (16, 2048), "c": (4099,),
              "d": {"e": (3, 1000)}, "one": (1,)}

    def draw(_, s):
        return torch.randn(s, generator=gen, device=gen.device)

    params = tree_map(draw, shapes)
    params["d"]["e"] = params["d"]["e"].to(torch.bfloat16)
    return shapes, params, draw


def _plain_adamw_update(cfg, params, grads, state):
    """``adamw_update`` with the plain versions on the card: the torch
    update as it ran before the kernels."""
    norm = global_norm(grads)
    scale = adamw.clip_scale_ref(norm, cfg.clip_norm)
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    t = step.to(torch.float32)
    bc1, bc2 = 1 - torch.pow(cfg.b1, t), 1 - torch.pow(cfg.b2, t)
    for p, g, m, v in zip(*(tree_leaves(x) for x in (
            params, grads, state["mu"], state["nu"]))):
        adamw.adamw_step_ref(cfg, p, g, m, v, scale, lr, bc1, bc2)
    state["step"] = step
    return norm


def test_adamw_update_makes_no_sync_and_launches_once_a_leaf(cuda):
    """A full ``adamw_update`` on the card runs under
    ``set_sync_debug_mode("error")``: nothing read back to the host. It
    makes one clip pass and one step launch a leaf; two identical runs of
    two steps give the same bits."""
    cfg = OptimizerConfig(warmup_steps=2)
    runs = []
    for _ in range(2):
        gen = torch.Generator(device=cuda).manual_seed(7)
        shapes, params, draw = _adamw_tree(gen)
        state = init_opt_state(params)
        grads = [tree_map(draw, shapes) for _ in range(2)]
        adamw_update(cfg, params, tree_map(draw, shapes), state)  # builds
        torch.cuda.synchronize()
        before = (adamw_ops.adamw_sumsq.launches,
                  adamw_ops.adamw_step.launches)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for g in grads:
                params, state, out = adamw_update(cfg, params, g, state)
            with pytest.raises(RuntimeError):
                torch.tensor([7], device=cuda)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        leaves = len(list(tree_leaves(params)))
        assert (adamw_ops.adamw_sumsq.launches,
                adamw_ops.adamw_step.launches) == (before[0] + 2,
                                                   before[1] + 2 * leaves)
        assert out["grad_norm"].is_cuda and out["lr"].is_cuda
        runs.append(list(tree_leaves({"p": params, "mu": state["mu"],
                                      "nu": state["nu"]}))
                    + [out["grad_norm"]])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_adamw_update_on_card_tracks_the_plain_update(cuda):
    """Three steps through the kernels against three through the plain
    versions on the card, from the same params and gradients: each leaf's
    change within the benchmark's ``change_gap`` rule (the gap of the
    change's norms over the larger of the leaf's and the median leaf's,
    at most olmo_1b.train's limit of 1e-3), and the norms within 1e-5."""
    cfg = OptimizerConfig(warmup_steps=1, clip_norm=0.5)
    gen = torch.Generator(device=cuda).manual_seed(9)
    shapes, params, draw = _adamw_tree(gen)
    plain = tree_map(lambda _, t: t.clone(), params)
    p0 = tree_map(lambda _, t: t.float().clone(), params)
    state, plain_state = init_opt_state(params), init_opt_state(plain)
    for _ in range(3):
        g = tree_map(draw, shapes)
        params, state, out = adamw_update(cfg, params, g, state)
        norm = _plain_adamw_update(cfg, plain, g, plain_state)
        assert float(out["grad_norm"]) == pytest.approx(float(norm),
                                                        rel=1e-5)
    got, want = ([float((p.float() - q).norm()) for p, q in zip(
        tree_leaves(t), tree_leaves(p0))] for t in (params, plain))
    med = float(np.median(want))
    gaps = [abs(a - b) / max(b, med) for a, b in zip(got, want)]
    assert max(gaps) <= 1e-3, gaps
