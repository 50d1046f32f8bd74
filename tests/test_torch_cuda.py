"""The PyTorch port on a CUDA GPU: each hand-written kernel against its
plain version, and the dense LM's card path against its CPU path.

Every test here needs a GPU and skips without one; the file imports no
JAX, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attn import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.fused_mlp import fused_mlp, fused_mlp_ref  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

pytestmark = pytest.mark.cuda

BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # the repo's bf16 kernel tolerance


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
])
def test_flash_kernel_matches_plain(cuda, b, sq, skv, h, kv, hd, causal):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, b, sq, h, hd)
    k, v = _randn(gen, b, skv, kv, hd), _randn(gen, b, skv, kv, hd)
    before = flash_attention.launches
    y = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(y.float(),
                               attention_ref(q, k, v, causal).float(),
                               **BF16_TOL)


@pytest.mark.parametrize("m,k,f", [(1, 128, 256), (70, 256, 384),
                                   (256, 512, 1024)])
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


def test_kernels_raise_for_unsupported_input(cuda):
    x = torch.zeros(4, 128, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_mlp(x, x.T.contiguous(), x.T.contiguous(), x)
    q = torch.zeros(1, 8, 2, 48, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)


def test_dense_lm_card_path_matches_cpu_path(cuda):
    """bf16 kernel path on the card vs fp32 plain path on the CPU, same
    weights: prefill and one decode step within 3% relative RMS (bf16
    rounding compounded over two layers; a wrong kernel is O(1))."""
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
    with torch.inference_mode():
        want, cpu_cache = model_zoo.prefill(cpu_cfg, params, toks, 40)
        got, cache = model_zoo.prefill(cfg, eng.params, toks.to(cuda), 40)
        nxt = torch.argmax(want, -1).to(torch.int32)
        want_d, _ = model_zoo.decode_step(cpu_cfg, params, cpu_cache, nxt)
        got_d, _ = model_zoo.decode_step(cfg, eng.params, cache,
                                         nxt.to(cuda))
    assert flash_attention.launches - flash0 == cfg.n_layers
    assert fused_mlp.launches - mlp0 == 2 * cfg.n_layers
    for g, w in ((got, want), (got_d, want_d)):
        g = g.float().cpu()
        assert torch.isfinite(g).all()
        assert float((g - w).norm() / w.norm()) < 3e-2
    out = eng.generate(toks.numpy()[:, :32])
    assert out.shape == (2, 4) and ((out >= 0) & (out < cfg.vocab)).all()
