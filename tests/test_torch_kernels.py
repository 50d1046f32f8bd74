"""PyTorch port's kernel ops vs the JAX Pallas kernels (interpret mode)
and their jnp oracles, in the grid of tests/test_kernels.py.

On CPU tensors each op runs its plain version; the CUDA kernels are
checked against the same plain versions in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attn import flash_attention_op  # noqa: E402
from repro.kernels.fused_mlp import fused_mlp_op  # noqa: E402
from repro.kernels.fused_mlp import fused_mlp_ref as jax_fused_mlp_ref  # noqa: E402
from repro.models.attention import flash_attention as jax_model_flash  # noqa: E402
from repro_torch.kernels.flash_attn import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.fused_mlp import fused_mlp  # noqa: E402
from repro_torch.models.attention import flash_attention as model_flash  # noqa: E402

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):  # the repo's tolerances (tests/test_kernels.py:20)
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(arr, dtype):
    """One numpy draw as a jax array and a torch tensor of ``dtype``."""
    _, jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(arr).astype(jdt)
    # round through jax so both sides hold bit-identical bf16 values
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ---------------------------------------------------------------------------
# fused MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,f,tm,tf", [
    (128, 256, 512, 64, 128),
    (256, 128, 256, 128, 256),
    (64, 64, 128, 64, 64),
])
def test_fused_mlp_matches_pallas(dtype, m, k, f, tm, tf):
    rng = np.random.RandomState(0)
    x, tx = _pair(rng.randn(m, k) * 0.5, dtype)
    w1, t1 = _pair(rng.randn(k, f) * 0.05, dtype)
    w3, t3 = _pair(rng.randn(k, f) * 0.05, dtype)
    w2, t2 = _pair(rng.randn(f, k) * 0.05, dtype)
    y = fused_mlp(tx, t1, t3, t2)
    assert y.dtype == DTYPES[dtype][2] and y.shape == (m, k)
    yk = fused_mlp_op(x, w1, w3, w2, tm=tm, tf=tf, interpret=True)
    np.testing.assert_allclose(_np(y), _np(yk), **_tol(dtype))
    np.testing.assert_allclose(_np(y), _np(jax_fused_mlp_ref(x, w1, w3, w2)),
                               **_tol(dtype))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,kv,sq,sk,hd", [
    (2, 4, 2, 128, 128, 64),    # GQA g=2
    (1, 8, 1, 64, 256, 32),     # MQA, rectangular
    (2, 2, 2, 256, 256, 128),   # MHA
])
def test_flash_attention_matches_pallas(dtype, causal, b, h, kv, sq, sk, hd):
    rng = np.random.RandomState(1)
    q, tq = _pair(rng.randn(b * h, sq, hd), dtype)
    k, tk = _pair(rng.randn(b * kv, sk, hd), dtype)
    v, tv = _pair(rng.randn(b * kv, sk, hd), dtype)
    y = flash_attention(tq, tk, tv, causal=causal)
    assert y.dtype == DTYPES[dtype][2] and y.shape == (b * h, sq, hd)
    np.testing.assert_allclose(_np(y), _np(jax_attention_ref(q, k, v,
                                                             causal=causal)),
                               **_tol(dtype))
    yk = flash_attention_op(q, k, v, causal=causal, tq=64, tk=64,
                            interpret=True)
    np.testing.assert_allclose(_np(y), _np(yk), **_tol(dtype))


@pytest.mark.parametrize("sq,sk", [(100, 100), (37, 130), (1, 77)])
def test_flash_attention_ragged_lengths(sq, sk):
    """Lengths no tile divides (the Pallas kernel asserts divisibility;
    the port must take real prompt lengths), held to the JAX oracle."""
    rng = np.random.RandomState(2)
    q, tq = _pair(rng.randn(6, sq, 32), "float32")
    k, tk = _pair(rng.randn(2, sk, 32), "float32")
    v, tv = _pair(rng.randn(2, sk, 32), "float32")
    for causal in (True, False):
        y = flash_attention(tq, tk, tv, causal=causal)
        np.testing.assert_allclose(_np(y),
                                   _np(jax_attention_ref(q, k, v, causal)),
                                   rtol=2e-5, atol=2e-5)


def test_flash_attention_model_layout_matches_pallas_layout():
    """The [B, S, H, hd] entry agrees with the [BH, S, hd] entry under the
    layout shuffle of tests/test_kernels.py:114-122."""
    rng = np.random.RandomState(3)
    b, s, h, kv, hd = 2, 40, 4, 2, 16
    q = torch.from_numpy(rng.randn(b, s, h, hd).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, s, kv, hd).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, s, kv, hd).astype(np.float32))
    y4 = flash_attention(q, k, v, causal=True)
    y3 = flash_attention(q.permute(0, 2, 1, 3).reshape(b * h, s, hd),
                         k.permute(0, 2, 1, 3).reshape(b * kv, s, hd),
                         v.permute(0, 2, 1, 3).reshape(b * kv, s, hd))
    torch.testing.assert_close(
        y4, y3.reshape(b, h, s, hd).permute(0, 2, 1, 3), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,q_offset,chunk", [
    (True, 0, 1024), (True, 0, 24), (False, 0, 32), (True, 16, 40)])
def test_model_flash_matches_jax(dtype, causal, q_offset, chunk):
    """The model's chunked online softmax (start-aligned, q*scale in the
    input dtype) against repro.models.attention.flash_attention."""
    rng = np.random.RandomState(4)
    b, sq, skv, h, kv, hd = 2, 48, 96 if q_offset else 48, 4, 2, 16
    if q_offset == 0:
        skv = sq
    q, tq = _pair(rng.randn(b, sq, h, hd), dtype)
    k, tk = _pair(rng.randn(b, skv, kv, hd), dtype)
    v, tv = _pair(rng.randn(b, skv, kv, hd), dtype)
    want = jax_model_flash(q, k, v, causal=causal, q_offset=q_offset,
                           chunk=chunk)
    got = model_flash(tq, tk, tv, causal=causal, q_offset=q_offset,
                      chunk=chunk)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_model_flash_matches_kernel_oracle():
    """Model flash (start-aligned) == kernel oracle (end-aligned) when
    sq == skv, as on the prefill path where the kernel replaces it."""
    rng = np.random.RandomState(5)
    q = torch.from_numpy(rng.randn(2, 64, 4, 32).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, 64, 2, 32).astype(np.float32))
    v = torch.from_numpy(rng.randn(2, 64, 2, 32).astype(np.float32))
    torch.testing.assert_close(model_flash(q, k, v, causal=True, chunk=16),
                               attention_ref(q, k, v, causal=True),
                               rtol=2e-5, atol=2e-5)


def test_ops_reject_bad_input():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        fused_mlp(x[None], x, x, x)
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(2, 4, 8), torch.zeros(1, 2, 4, 8),
                        torch.zeros(1, 2, 4, 8))
