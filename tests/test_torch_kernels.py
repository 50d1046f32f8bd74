"""PyTorch port's kernel ops vs the JAX Pallas kernels (interpret mode)
and their jnp oracles, in the grid of tests/test_kernels.py; the SSD
scan also against the models' chunked form (``ssd_chunked``).

On CPU tensors each op runs its plain version; the CUDA kernels are
checked against the same plain versions in tests/test_torch_cuda.py.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attn import flash_attention_op  # noqa: E402
from repro.kernels.fused_mlp import fused_mlp_op  # noqa: E402
from repro.kernels.fused_mlp import fused_mlp_ref as jax_fused_mlp_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_op  # noqa: E402
from repro.models.attention import flash_attention as jax_model_flash  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attn import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.flash_attn import attention_lse, flash_attention_backward  # noqa: E402
from repro_torch.kernels.flash_attn.ops import attention_bwd  # noqa: E402
from repro_torch.kernels.flash_attn.ops import admit as flash_admit  # noqa: E402
from repro_torch.kernels.flash_attn.ops import REGIMES as FLASH_REGIMES  # noqa: E402
from repro_torch.kernels.flash_attn.ops import regime as flash_regime  # noqa: E402
from repro_torch.kernels.flash_attn import FlashAttention  # noqa: E402
from repro_torch.kernels.fused_mlp import FusedMLP, fused_mlp, fused_mlp_ref  # noqa: E402
from repro_torch.kernels.fused_mlp.ops import (decode_split, regime,  # noqa: E402
                                               row_chunks)
from repro_torch.kernels.ssd_scan import (from_pallas_layout, ssd_ref,  # noqa: E402
                                          ssd_scan, to_pallas_layout)
from repro_torch.models.attention import flash_attention as model_flash  # noqa: E402
from repro_torch.models.attention import init_attn  # noqa: E402
from repro.models.attention import init_attn as jax_init_attn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

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


@pytest.mark.parametrize("m,want", [(1, "decode"), (4, "decode"),
                                    (64, "decode"), (65, "prefill"),
                                    (2048, "prefill")])
def test_fused_mlp_regime_by_m(m, want):
    """M <= 64 runs the weight-streaming decode kernels, larger M the
    tensor-core prefill kernels."""
    assert regime(m) == want


@pytest.mark.parametrize("m,k,f", [
    (2048, 4096, 14336),   # granite_8b prefill
    (4, 4096, 14336),      # granite_8b decode
    (65, 128, 256), (100, 256, 384), (300, 128, 1024), (1000, 512, 1024),
    (4096, 2048, 5632), (129, 4096, 14336),
])
def test_fused_mlp_row_chunks_cap_h(m, k, f):
    """The chunks tile [0, M) in order, all but the last of one size in
    whole 128-row tiles, and h ([rows, F] bf16) never exceeds the fp32
    [M, K] workspace it replaces, or one tile where that is smaller."""
    chunks = row_chunks(m, k, f)
    assert [s for s, _ in chunks] == list(
        np.cumsum([0] + [r for _, r in chunks[:-1]]))
    assert sum(r for _, r in chunks) == m
    rows = max(r for _, r in chunks)
    if regime(m) == "prefill":
        assert len(chunks) == 1 or rows % 128 == 0
        assert all(r == rows for _, r in chunks[:-1])
        assert rows * f * 2 <= max(m * k * 4, 128 * f * 2)
    else:
        assert chunks == [(0, m)]


def test_fused_mlp_row_chunks_granite_prefill():
    """granite_8b prefill (M 2048): two equal chunks of 8 tiles, so the
    down GEMM's 8 x 32 tiles fill 132 SMs in two rounds each."""
    assert row_chunks(2048, 4096, 14336) == [(0, 1024), (1024, 1024)]


@pytest.mark.parametrize("outputs,reduction,sms,want", [
    (14336, 4096, 132, 1),   # granite_8b gate/up: 224 blocks, no split
    (4096, 14336, 132, 4),   # granite_8b down: 64 x 4 blocks
    (256, 128, 132, 2),      # capped by the 2 blocks of the reduction
    (128, 64, 132, 1),
    (8192, 8192, 4, 1),      # already a block per SM
])
def test_fused_mlp_decode_split(outputs, reduction, sms, want):
    cs = decode_split(outputs, reduction, sms)
    assert cs == want
    assert cs in (1, 2, 4, 8) and cs <= max(1, reduction // 64)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_flash_admission_takes_model_and_pallas_layouts():
    for hd in (64, 80, 96, 128):
        q, k = _bf16(2, 33, 8, hd), _bf16(2, 40, 2, hd)
        flash_admit(q, k, k)
        qp, kp = _bf16(16, 33, hd), _bf16(4, 40, hd)
        flash_admit(*(t.permute(1, 0, 2).unsqueeze(0) for t in (qp, kp, kp)))


@pytest.mark.parametrize("case,match", [
    ("head_dim_48", "head dim"),
    ("float32", "bfloat16"),
    ("gqa_3_over_2", "multiple of"),
    ("stride_not_16_bytes", "stride"),
    ("misaligned", "aligned"),
    ("kv_shape", "shape mismatch"),
])
def test_flash_admission_rejects(case, match):
    """What the kernel's TMA descriptors cannot take is refused before a
    launch: strides that are not multiples of 16 bytes, misaligned data,
    a head dim outside 64/80/96/128, and the shape rules."""
    q, k = _bf16(1, 8, 2, 64), _bf16(1, 8, 2, 64)
    if case == "head_dim_48":
        q, k = _bf16(1, 8, 2, 48), _bf16(1, 8, 2, 48)
    elif case == "float32":
        q = q.float()
    elif case == "gqa_3_over_2":
        q = _bf16(1, 8, 3, 64)
    elif case == "stride_not_16_bytes":
        q = _bf16(1, 8, 2, 68)[..., :64]
    elif case == "misaligned":
        q = _bf16(1 * 8 * 2 * 64 + 1)[1:].view(1, 8, 2, 64)
    elif case == "kv_shape":
        k = _bf16(1, 8, 2, 80)
    with pytest.raises(ValueError, match=match):
        flash_admit(q, k, k)


def test_build_library_name_hashes_shared_headers(tmp_path, monkeypatch):
    """A kernel library's file name changes with its source and with any
    shared header in csrc/, so an edited header never loads a stale
    library; nothing here needs nvcc."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (csrc / "k.cu").write_text('#include "shared.cuh"\n')
    (csrc / "shared.cuh").write_text("// v1\n")
    first = _build.library("k")
    assert first.parent == tmp_path / "build"
    assert first.name.startswith("libk-") and first.suffix == ".so"
    assert _build.library("k") == first
    (csrc / "shared.cuh").write_text("// v2\n")
    second = _build.library("k")
    assert second != first
    (csrc / "other.cuh").write_text("// new header\n")
    assert _build.library("k") != second
    (csrc / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert _build.library("k") not in (first, second)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,kv,sq,sk,hd", [
    (2, 4, 2, 128, 128, 64),    # GQA g=2
    (1, 8, 1, 64, 256, 32),     # MQA, rectangular
    (2, 2, 2, 256, 256, 128),   # MHA
    (2, 8, 8, 64, 192, 64),     # whisper's cross-attention: hd 64, Sq != Skv
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


@pytest.mark.parametrize("causal,sq,sk,want", [
    (True, 64, 64, "causal"), (True, 1, 77, "causal"),
    (False, 1500, 1500, "non-causal Sq=Skv"),
    (False, 128, 1500, "non-causal Sq!=Skv")])
def test_flash_regime_keys(causal, sq, sk, want):
    """``launches_by_regime`` splits the kernel's launches by mask and
    shape: causal (whatever the lengths), non-causal self (Sq == Skv, an
    encoder), non-causal cross (Sq != Skv). The plain version on CPU
    tensors launches nothing and counts in no regime."""
    assert flash_regime(causal, sq, sk) == want
    assert set(flash_attention.launches_by_regime) == set(FLASH_REGIMES)
    before = dict(flash_attention.launches_by_regime)
    flash_attention(torch.zeros(1, 4, 2, 16), torch.zeros(1, 6, 2, 16),
                    torch.zeros(1, 6, 2, 16), causal=causal)
    assert flash_attention.launches_by_regime == before


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


def _jax_lse(q, k, causal):
    """jax.nn.logsumexp of the reference oracle's scaled and masked scores
    (repro/kernels/flash_attn/ref.py: GQA by repeat, scale 1/sqrt(hd),
    the causal mask end-aligned at -inf); Pallas layout."""
    bh, sq, hd = q.shape
    bkv, skv, _ = k.shape
    kk = jnp.repeat(k, bh // bkv, axis=0)
    s = jnp.einsum("bqd,bkd->bqk", q, kk) / (hd ** 0.5)
    if causal:
        mask = jnp.tril(jnp.ones((sq, skv), bool), k=skv - sq)
        s = jnp.where(mask[None], s, -jnp.inf)
    return jax.nn.logsumexp(s, axis=-1)


@pytest.mark.parametrize("causal,sq,sk,h,kv", [
    (True, 64, 64, 4, 2),       # causal, end-aligned at Sq = Skv, GQA
    (True, 37, 130, 4, 1),      # causal end-aligned, Sq < Skv, MQA
    (False, 96, 96, 4, 4),      # non-causal self-attention
    (False, 48, 150, 8, 2),     # non-causal cross-attention, Sq != Skv
])
def test_attention_lse_matches_jax_logsumexp(causal, sq, sk, h, kv):
    """The plain version's row log-sum-exp (what the forward kernel keeps,
    in log2 units, for its backward) against jax.nn.logsumexp of the
    reference's scaled, masked scores, in fp32 within 1e-5, in both
    layouts."""
    rng = np.random.RandomState(12)
    b, hd = 2, 32
    q = rng.randn(b * h, sq, hd).astype(np.float32)
    k = rng.randn(b * kv, sk, hd).astype(np.float32)
    want = np.asarray(_jax_lse(jnp.asarray(q), jnp.asarray(k), causal))
    got = attention_lse(torch.from_numpy(q), torch.from_numpy(k), causal)
    assert got.dtype == torch.float32 and got.shape == (b * h, sq)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    q4 = torch.from_numpy(q).reshape(b, h, sq, hd).permute(0, 2, 1, 3)
    k4 = torch.from_numpy(k).reshape(b, kv, sk, hd).permute(0, 2, 1, 3)
    got4 = attention_lse(q4, k4, causal)
    assert got4.shape == (b, h, sq)
    np.testing.assert_allclose(got4.reshape(b * h, sq).numpy(), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["model", "pallas"])
@pytest.mark.parametrize("causal,sq,sk,h,kv", [
    (True, 40, 40, 8, 2), (True, 24, 56, 4, 4), (False, 40, 40, 4, 1),
    (False, 32, 72, 8, 2)])
def test_flash_function_matches_jax_vjp(layout, causal, sq, sk, h, kv):
    """FlashAttention on CPU tensors (the plain forward, the plain
    backward that ``flash_attention_backward`` runs there) against
    jax.vjp of the reference oracle, fp32, in both layouts: causal at
    Sq = Skv and end-aligned at Sq < Skv, non-causal self and cross, GQA
    and MHA; within the repo's fp32 tolerance."""
    rng = np.random.RandomState(13)
    b, hd = 2, 16
    q, k, v = (rng.randn(*shape).astype(np.float32) for shape in
               ((b * h, sq, hd), (b * kv, sk, hd), (b * kv, sk, hd)))
    do = rng.randn(b * h, sq, hd).astype(np.float32)
    want = _vjp_jax(lambda q, k, v: jax_attention_ref(q, k, v, causal),
                    (q, k, v), do)

    def model(t, heads):  # [B*heads, S, hd] -> [B, S, heads, hd]
        return t.reshape(b, heads, -1, hd).permute(0, 2, 1, 3)

    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    if layout == "model":
        args = (model(ts[0], h), model(ts[1], kv), model(ts[2], kv))
        cot = model(torch.from_numpy(do), h)
    else:
        args, cot = ts, torch.from_numpy(do)
    y = FlashAttention.apply(*args, causal)
    assert y.grad_fn.name() == "FlashAttentionBackward"
    got = torch.autograd.grad(y, ts, cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **_tol("float32"))


def _flash_bwd_kernel_emulation(q, k, v, do, causal, tn=128):
    """What csrc/flash_attn_bwd.cu computes, in fp32 on the CPU from
    bf16-valued operands in the Pallas layout (q, do [BH, Sq, hd], k, v
    [BKV, Skv, hd]): P from the row log-sum-exp, rounded to bf16 before
    P^T dO; D = rowsum(dO o O) with O the forward's bf16 output; dS =
    P (dP - D) rounded to bf16 before dS K and dS^T Q; dq summed per
    ``tn``-key tile in fp32, the tile sums added in ascending key-tile
    order (the order the kernel's semaphores enforce), scaled and rounded
    once; dk and dv summed over the group's heads in fp32 and rounded
    once."""
    def bf(t):
        return t.to(torch.bfloat16).float()

    bh, sq, hd = q.shape
    bkv, skv, _ = k.shape
    g, scale = bh // bkv, hd ** -0.5
    kk, vv = k.repeat_interleave(g, 0), v.repeat_interleave(g, 0)
    s = q @ kk.transpose(1, 2) * scale
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool).tril(skv - sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = bf(bf(p) @ vv)
    d = (do * o).sum(-1, keepdim=True)
    ds = bf(p * (do @ vv.transpose(1, 2) - d))
    dq = None
    for k0 in range(0, skv, tn):
        part = ds[:, :, k0:k0 + tn] @ kk[:, k0:k0 + tn]
        dq = part if dq is None else dq + part
    dk = (ds.transpose(1, 2) @ q).reshape(bkv, g, skv, hd).sum(1) * scale
    dv = (bf(p).transpose(1, 2) @ do).reshape(bkv, g, skv, hd).sum(1)
    return bf(dq * scale), bf(dk), bf(dv)


@pytest.mark.parametrize("causal,sq,sk,bh,bkv", [
    (True, 200, 200, 4, 2),     # causal, ragged across two key tiles
    (False, 64, 520, 2, 2),     # one query tile summed over 5 key tiles
    (True, 130, 390, 8, 2)])    # end-aligned Sq < Skv, GQA 4
def test_flash_bwd_kernel_rounding_matches_jax_vjp(causal, sq, sk, bh, bkv):
    """CPU evidence for the backward kernel's decomposition: the emulation
    of its rounding and of its dq sum over 128-key tiles against jax.vjp
    of the reference oracle (fp32) on the same bf16-valued inputs, each
    gradient scaled by its largest magnitude, within the repo's bf16
    tolerance."""
    rng = np.random.RandomState(21)
    hd = 32
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   .to(torch.bfloat16).float() for shape in
                   ((bh, sq, hd), (bkv, sk, hd), (bkv, sk, hd),
                    (bh, sq, hd)))
    got = _flash_bwd_kernel_emulation(q, k, v, do, causal)
    want = _vjp_jax(lambda q, k, v: jax_attention_ref(q, k, v, causal),
                    tuple(t.numpy() for t in (q, k, v)), do.numpy())
    for gt, w in zip(got, want):
        top = float(np.abs(w).max())
        np.testing.assert_allclose(gt.numpy() / top, w / top,
                                   **_tol("bfloat16"))


def test_backward_ops_take_plain_versions_on_cpu():
    """On CPU tensors the backward ops are their plain versions:
    ``flash_attention_backward`` gives ``attention_bwd``'s gradients (it
    reads neither o nor lse) in both layouts, bitwise, and launches
    nothing."""
    rng = np.random.RandomState(14)
    q, k, v, do = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                   for s in ((2, 20, 4, 16), (2, 28, 2, 16), (2, 28, 2, 16),
                             (2, 20, 4, 16)))
    before = flash_attention.bwd_launches
    got = flash_attention_backward(q, k, v, None, None, do, True)
    for g, w in zip(got, attention_bwd(q, k, v, do, True)):
        assert torch.equal(g, w)
    pal = [t.permute(0, 2, 1, 3).flatten(0, 1) for t in (q, k, v, do)]
    got3 = flash_attention_backward(pal[0], pal[1], pal[2], None, None,
                                    pal[3], True)
    for g3, g in zip(got3, got):
        torch.testing.assert_close(
            g3, g.permute(0, 2, 1, 3).flatten(0, 1), rtol=0, atol=0)
    assert flash_attention.bwd_launches == before


@pytest.mark.parametrize("arch", ["granite_8b", "zamba2_1_2b",
                                  "whisper_base"])
@pytest.mark.parametrize("overrides", [
    {}, {"d_model": 96}, {"n_heads": 6}, {"n_kv": 3},
    {"d_model": 80, "n_heads": 4, "n_kv": 2}])
def test_init_attn_overrides_match_reference_shapes(arch, overrides):
    """init_attn's d_model / n_heads / n_kv keywords override the config
    as the reference's do (repro/models/attention.py:24-30): every weight
    has the reference's shape under each override, the head dim stays
    the config's."""
    cfg = get_config(arch, smoke=True)
    want = jax.eval_shape(lambda key: jax_init_attn(
        jax_get_config(arch, smoke=True), key, **overrides),
        jax.random.PRNGKey(0))
    got = init_attn(cfg, torch.Generator().manual_seed(0), **overrides)
    assert set(got) == set(want)
    for name, t in got.items():
        assert tuple(t.shape) == tuple(want[name].shape), name
        assert t.dtype == torch.float32


def test_ops_reject_bad_input():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        fused_mlp(x[None], x, x, x)
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(2, 4, 8), torch.zeros(1, 2, 4, 8),
                        torch.zeros(1, 2, 4, 8))


# ---------------------------------------------------------------------------
# the kernels under autograd (FusedMLP, FlashAttention) and the guard
# ---------------------------------------------------------------------------

def _f64(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.randn(*shape) * scale).requires_grad_()


def test_fused_mlp_function_gradcheck():
    """FusedMLP's explicit backward against finite differences of its
    forward (the plain version on CPU tensors), in float64."""
    rng = np.random.RandomState(0)
    args = (_f64(rng, 6, 8), _f64(rng, 8, 12, scale=0.4),
            _f64(rng, 8, 12, scale=0.4), _f64(rng, 12, 8, scale=0.4))
    assert FusedMLP.apply(*args).grad_fn.name() == "FusedMLPBackward"
    assert torch.autograd.gradcheck(FusedMLP.apply, args)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", ["model", "pallas"])
def test_flash_function_gradcheck(causal, layout):
    """FlashAttention's explicit backward (GQA, end-aligned causal mask,
    Sq < Skv) against finite differences, in float64, in both layouts."""
    rng = np.random.RandomState(1)
    if layout == "model":
        args = (_f64(rng, 2, 5, 4, 8), _f64(rng, 2, 7, 2, 8),
                _f64(rng, 2, 7, 2, 8))
    else:
        args = (_f64(rng, 4, 5, 8), _f64(rng, 2, 7, 8), _f64(rng, 2, 7, 8))

    def fn(q, k, v):
        return FlashAttention.apply(q, k, v, causal)

    assert fn(*args).grad_fn.name() == "FlashAttentionBackward"
    assert torch.autograd.gradcheck(fn, args)


def _vjp_jax(fn, args, cot):
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def test_functions_match_jax_oracle_gradients():
    """In fp32, each Function's gradients against jax.vjp of the
    reference's kernel oracle (repro.kernels.*.ref) on the same inputs,
    within the repo's fp32 tolerance; flash with GQA and causal."""
    rng = np.random.RandomState(2)
    x, w1, w3, w2, dy = (rng.randn(*s).astype(np.float32) * sc for s, sc in
                         (((16, 32), 1.0), ((32, 64), 0.2), ((32, 64), 0.2),
                          ((64, 32), 0.2), ((16, 32), 1.0)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w1, w3, w2)]
    got = torch.autograd.grad(FusedMLP.apply(*ts), ts, torch.from_numpy(dy))
    want = _vjp_jax(jax_fused_mlp_ref, (x, w1, w3, w2), dy)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **_tol("float32"))
    q, k, v, do = (rng.randn(*s).astype(np.float32) for s in
                   ((8, 40, 16), (2, 40, 16), (2, 40, 16), (8, 40, 16)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(FlashAttention.apply(*ts, True), ts,
                              torch.from_numpy(do))
    want = _vjp_jax(lambda q, k, v: jax_attention_ref(q, k, v, causal=True),
                    (q, k, v), do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **_tol("float32"))


def test_functions_match_autograd_of_plain_bf16():
    """In bf16 (the card's dtype, here on the CPU), the explicit
    backwards against autograd through the plain versions, within the
    repo's bf16 tolerance on gradients scaled to a largest magnitude of 1
    (the O(1) scale of the outputs that tolerance was set for; the fused
    MLP's backward rounds g, u, dg and du to bf16, and flash's P and dS,
    where autograd of the fp32 plain version does not, about one bf16
    step: ~3e-3 relative RMS, at most 7e-3 of the largest gradient)."""
    gen = torch.Generator().manual_seed(3)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(
            torch.bfloat16).requires_grad_()

    cases = [(lambda *a: FusedMLP.apply(*a), fused_mlp_ref,
              (rnd(64, 128), rnd(128, 256, scale=128 ** -0.5),
               rnd(128, 256, scale=128 ** -0.5),
               rnd(256, 128, scale=256 ** -0.5))),
             (lambda q, k, v: FlashAttention.apply(q, k, v, True),
              lambda q, k, v: attention_ref(q, k, v, True),
              (rnd(2, 96, 4, 64), rnd(2, 96, 2, 64), rnd(2, 96, 2, 64)))]
    for fn, plain, args in cases:
        dy = torch.randn(fn(*args).shape, generator=gen).to(torch.bfloat16)
        got = torch.autograd.grad(fn(*args), args, dy)
        want = torch.autograd.grad(plain(*args), args, dy)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == torch.bfloat16
            top = w.float().abs().max()
            torch.testing.assert_close(g.float() / top, w.float() / top,
                                       **_tol("bfloat16"))


def test_refuse_grad_guard():
    """The raw wrappers' guard: raises when grad mode is on and an input
    requires grad (a ctypes launch would drop that gradient), and lets
    detached inputs, no_grad and inference_mode through."""
    t = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward.*use X"):
        _build.refuse_grad("op", (t.detach(), t), "use X")
    _build.refuse_grad("op", (t.detach(),), "use X")
    with torch.no_grad():
        _build.refuse_grad("op", (t,), "use X")
    with torch.inference_mode():
        _build.refuse_grad("op", (t,), "use X")


def test_plain_ops_keep_autograd_on_cpu():
    """On CPU tensors the raw ops run their plain versions, so autograd
    flows through them (the guard is for CUDA launches only)."""
    rng = np.random.RandomState(4)
    x = _f64(rng, 1, 16, 2, 64)
    dt = torch.from_numpy(np.log1p(np.exp(rng.randn(1, 16, 2)))
                          ).requires_grad_()
    a = torch.from_numpy(-np.exp(rng.randn(2) * 0.2)).requires_grad_()
    bm, cm = _f64(rng, 1, 16, 1, 8), _f64(rng, 1, 16, 1, 8)
    y, state = ssd_scan(x, dt, a, bm, cm, chunk=8)
    grads = torch.autograd.grad(y.sum() + state.sum(), (x, dt, a, bm, cm))
    assert all(bool(torch.isfinite(g).all()) and g.abs().sum() > 0
               for g in grads)
    q = _f64(rng, 1, 8, 2, 16)
    assert flash_attention(q, q, q).grad_fn is not None
    w = _f64(rng, 16, 16)
    assert fused_mlp(q[0, :, 0], w, w, w).grad_fn is not None


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, bh, s, p, n, dtype):
    """Pallas-layout SSD inputs (tests/test_kernels.py:141-147's
    distributions), drawn with numpy, as (jax, torch) pairs."""
    x = _pair(rng.randn(bh, s, p), dtype)
    dt = _pair(np.log1p(np.exp(rng.randn(bh, s, 1))), dtype)
    a = _pair(-np.exp(rng.randn(bh, 1, 1) * 0.2), dtype)
    bm = _pair(rng.randn(bh, s, n), dtype)
    cm = _pair(rng.randn(bh, s, n), dtype)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,p,n,chunk", [
    (3, 64, 16, 8, 16),
    (2, 128, 32, 16, 32),
    (1, 64, 64, 128, 64),   # mamba2-780m head geometry
])
def test_ssd_scan_matches_pallas(dtype, bh, s, p, n, chunk):
    """Port op (CPU: its plain version) vs the Pallas kernel in interpret
    mode and the JAX oracle; the repo's SSD tolerances
    (tests/test_kernels.py:148-149)."""
    pairs = _ssd_inputs(np.random.RandomState(6), bh, s, p, n, dtype)
    jx, tx = zip(*pairs)
    y, state = ssd_scan(*tx, chunk=chunk)
    assert y.dtype == DTYPES[dtype][2] and y.shape == (bh, s, p)
    assert state.dtype == torch.float32 and state.shape == (bh, n, p)
    tol = dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(y), _np(ssd_scan_op(*jx, chunk=chunk,
                                                       interpret=True)),
                               **tol)
    np.testing.assert_allclose(_np(y), _np(jax_ssd_ref(*jx)), **tol)


def _split_bf16(t):
    """An fp32 operand as the kernel feeds it to two bf16 wgmmas:
    (hi, lo) = (bf16(t), bf16(t - hi)), returned in fp32."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _round_bf16(t):
    """An fp32 operand rounded once to bf16 (one wgmma), for contrast."""
    return (t.to(torch.bfloat16).float(),)


def _ssd_passes(x, dt, a, bm, cm, chunk, split=_split_bf16):
    """The scan as csrc/ssd_scan.cu computes it, in fp32 on the CPU:
    (a) chunk states S_c = B^T (w o x), w_j = exp(cum_L - cum_j) dt_j;
    (b) state passing S <- S exp(cum_L) + S_c, keeping each chunk's
    previous state; (c) the chunk scan exp(cum_i) (C S_prev) + M x with
    M = (C B^T) exp(cum_i - cum_j) dt_j masked to j <= i before exp. Each
    fp32-weighted operand (w o x, S_prev, M) goes through ``split`` into
    the bf16 parts the kernel's wgmmas take. Pallas layout; returns
    (y in x.dtype, final state)."""
    bh, s, p = x.shape
    n, nc = bm.shape[-1], s // chunk
    xf = x.float().reshape(bh, nc, chunk, p)
    bf = bm.float().reshape(bh, nc, chunk, n)
    cf = cm.float().reshape(bh, nc, chunk, n)
    dtf = dt.float().reshape(bh, nc, chunk)
    cum = torch.cumsum(dtf * a.float().reshape(bh, 1, 1), dim=-1)
    cl = cum[..., -1]                                    # [bh, nc]
    wx = (torch.exp(cl[..., None] - cum) * dtf)[..., None] * xf
    sc = sum(torch.einsum("bcjn,bcjp->bcnp", bf, part) for part in split(wx))
    state, prev = torch.zeros(bh, n, p), []
    for c in range(nc):
        prev.append(state)
        state = state * torch.exp(cl[:, c])[:, None, None] + sc[:, c]
    sprev = torch.stack(prev, dim=1)                     # [bh, nc, n, p]
    y = sum(torch.einsum("bcin,bcnp->bcip", cf, part)
            for part in split(sprev)) * torch.exp(cum)[..., None]
    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    seg = torch.where(causal, cum[..., :, None] - cum[..., None, :], 0.0)
    m = torch.where(causal, torch.einsum("bcin,bcjn->bcij", cf, bf)
                    * torch.exp(seg) * dtf[..., None, :], 0.0)
    y = y + sum(torch.einsum("bcij,bcjp->bcip", part, xf)
                for part in split(m))
    return y.reshape(bh, s, p).to(x.dtype), state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,p,n,chunk", [
    (3, 64, 16, 8, 16),
    (2, 128, 32, 16, 32),
    (1, 64, 64, 128, 64),   # mamba2-780m head geometry
])
def test_ssd_kernel_passes_match_pallas(dtype, bh, s, p, n, chunk):
    """The kernel's decomposition and operand rounding (chunk states, state
    passing, chunk scan; hi/lo bf16 operands) vs the Pallas kernel in
    interpret mode and the JAX oracle, final state vs the plain version;
    the tolerances of test_ssd_scan_matches_pallas."""
    pairs = _ssd_inputs(np.random.RandomState(6), bh, s, p, n, dtype)
    jx, tx = zip(*pairs)
    y, state = _ssd_passes(*tx, chunk=chunk)
    tol = dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(y), _np(ssd_scan_op(*jx, chunk=chunk,
                                                       interpret=True)),
                               **tol)
    np.testing.assert_allclose(_np(y), _np(jax_ssd_ref(*jx)), **tol)
    np.testing.assert_allclose(_np(state), _np(ssd_ref(*tx)[1]), **tol)


def _outside(got, want, tol=2e-2):
    """Elements outside chip_smoke.py's SSD_ATOL = SSD_RTOL."""
    got, want = got.float(), want.float()
    return int(((got - want).abs() > tol + tol * want.abs()).sum())


@pytest.mark.parametrize("split,ok", [(_split_bf16, True),
                                      (_round_bf16, False)])
def test_ssd_kernel_rounding_at_mamba2_geometry(split, ok):
    """CPU evidence for the kernel's operand precision at one mamba2_780m
    head geometry (S=512, 2 heads, N=128, P=64, chunk 256) with
    chip_smoke.py's input distribution: hi/lo bf16 operands keep y and the
    final state within the card's unchanged 2e-2 of ssd_ref; plain bf16
    rounding of the same operands puts y elements outside it."""
    rng = np.random.RandomState(11)
    bh, s, p, n = 2, 512, 64, 128
    x = torch.from_numpy(rng.randn(bh, s, p).astype(np.float32)).to(
        torch.bfloat16)
    dt = torch.from_numpy(np.log1p(np.exp(rng.randn(bh, s, 1))).astype(
        np.float32))
    a = torch.from_numpy(-np.exp(rng.randn(bh, 1, 1) * 0.2).astype(
        np.float32))
    bm, cm = (torch.from_numpy(rng.randn(bh, s, n).astype(np.float32)).to(
        torch.bfloat16) for _ in range(2))
    want_y, want_state = ssd_ref(x, dt, a, bm, cm)
    y, state = _ssd_passes(x, dt, a, bm, cm, chunk=256, split=split)
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    if ok:
        assert _outside(y, want_y) == 0
        assert _outside(state, want_state) == 0
        assert float((state - want_state).abs().max()) < 1e-3
    else:
        assert _outside(y, want_y) > 0


@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_chunked_chunk_invariance(chunks, seed):
    """The chunked form must not depend on the chunk size (state handoff
    exact), and matches the sequential plain version, final state
    included (twin of tests/test_kernels.py:154)."""
    rng = np.random.RandomState(seed)
    b, s, h, p, g, n = 2, 64, 2, 8, 1, 8
    x = torch.from_numpy(rng.randn(b, s, h, p).astype(np.float32))
    dt = torch.from_numpy(np.log1p(np.exp(rng.randn(b, s, h))).astype(
        np.float32))
    a = torch.from_numpy(-np.exp(rng.randn(h) * 0.2).astype(np.float32))
    bm = torch.from_numpy(rng.randn(b, s, g, n).astype(np.float32))
    cm = torch.from_numpy(rng.randn(b, s, g, n).astype(np.float32))
    y16, st16 = ssd_chunked(x, dt, a, bm, cm, chunk=16)
    y_var, st_var = ssd_chunked(x, dt, a, bm, cm, chunk=16 * chunks)
    tol = dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y16, y_var, **tol)
    torch.testing.assert_close(st16, st_var, **tol)
    y_ref, st_ref = ssd_scan(x, dt, a, bm, cm, chunk=16 * chunks)
    torch.testing.assert_close(y_var, y_ref, **tol)
    torch.testing.assert_close(st_var, st_ref, **tol)


def test_ssd_scan_matches_model_ssd():
    """Model-layout op with G=2 groups (read at h // (H/G), not expanded)
    vs the port's and JAX's ssd_chunked, final state included (twin of
    tests/test_kernels.py:172)."""
    rng = np.random.RandomState(3)
    b, s, h, p, g, n = 2, 64, 4, 16, 2, 8
    arrs = (rng.randn(b, s, h, p), np.log1p(np.exp(rng.randn(b, s, h))),
            -np.exp(rng.randn(h) * 0.2), rng.randn(b, s, g, n),
            rng.randn(b, s, g, n))
    jx, tx = zip(*(_pair(a, "float32") for a in arrs))
    y, state = ssd_scan(*tx, chunk=16)
    assert y.shape == (b, s, h, p) and state.shape == (b, h, n, p)
    ym, sm = ssd_chunked(*tx, chunk=16)
    yj, sj = jax_ssd_chunked(*jx, chunk=16)
    tol = dict(rtol=2e-4, atol=2e-4)
    for got in ((y, state), (ym, sm)):
        np.testing.assert_allclose(_np(got[0]), _np(yj), **tol)
        np.testing.assert_allclose(_np(got[1]), _np(sj), **tol)


def test_ssd_ref_state_and_layouts_match_jax():
    """The plain version's final state and the layout helpers: model
    layout -> Pallas layout -> ssd_ref -> model layout equals JAX's
    ssd_chunked (y and final state); y equals JAX's ssd_ref."""
    rng = np.random.RandomState(7)
    b, s, h, p, g, n = 2, 24, 4, 8, 2, 4
    arrs = (rng.randn(b, s, h, p), np.log1p(np.exp(rng.randn(b, s, h))),
            -np.exp(rng.randn(h) * 0.2), rng.randn(b, s, g, n),
            rng.randn(b, s, g, n))
    jx, tx = zip(*(_pair(a, "float32") for a in arrs))
    pallas = to_pallas_layout(*tx)
    y3, st3 = ssd_ref(*pallas)
    np.testing.assert_allclose(
        _np(y3), _np(jax_ssd_ref(*(jnp.asarray(t.numpy()) for t in pallas))),
        rtol=1e-5, atol=1e-5)
    y, state = from_pallas_layout(y3, st3, b)
    yj, sj = jax_ssd_chunked(*jx, chunk=8)
    np.testing.assert_allclose(_np(y), _np(yj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(state), _np(sj), rtol=1e-4, atol=1e-4)


def test_ssd_ops_reject_bad_input():
    x = torch.zeros(1, 20, 2, 8)
    dt, a = torch.ones(1, 20, 2), -torch.ones(2)
    bm = torch.zeros(1, 20, 1, 8)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan(x, dt, a, bm, bm, chunk=16)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ssd_chunked(x, dt, a, bm, bm, chunk=16)
    with pytest.raises(ValueError):
        ssd_scan(x[0, 0], dt, a, bm, bm)
