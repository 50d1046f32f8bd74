"""The decode attention op on the CPU: its plain path is the torch decode
path the models ran before the kernel (RoPE through ``rope_freqs`` and
``apply_rope``, the two cache writes, ``gqa_decode_attend``), bitwise;
its RoPE table is ``rope_freqs`` at every position, bitwise; the split
chooser and the admission rules are plain Python. The kernel itself is
checked against the plain path in tests/test_torch_cuda.py.
"""
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels.decode_attn import (decode_attention,  # noqa: E402
                                             decode_attention_ref,
                                             gqa_decode_attend, rope_table,
                                             split_plan)
from repro_torch.kernels.decode_attn import ops as decode_ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.common import apply_rope, rope_freqs  # noqa: E402


def _inputs(b, s, h, kv, hd, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen).to(dtype)

    return (draw(b, 1, h, hd), draw(b, 1, kv, hd), draw(b, 1, kv, hd),
            draw(b, s, kv, hd), draw(b, s, kv, hd))


def _torch_path(cfg, q, k, v, ck, cv, pos, rope):
    """The models' decode path before the kernel, as it was written."""
    if rope:
        cos, sin = rope_freqs(cfg, torch.tensor([pos]))
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    ck[:, pos] = k[:, 0]
    cv[:, pos] = v[:, 0]
    return gqa_decode_attend(q, ck, cv, pos).to(q.dtype)


@pytest.mark.parametrize("b,s,h,kv,hd,pos,rope,dtype", [
    (2, 40, 16, 16, 128, 0, True, torch.bfloat16),
    (2, 40, 8, 4, 64, 17, True, torch.bfloat16),
    (1, 33, 12, 3, 96, 32, True, torch.bfloat16),
    (4, 24, 14, 2, 80, 11, True, torch.bfloat16),
    (3, 20, 4, 4, 16, 19, True, torch.bfloat16),
    (2, 16, 8, 8, 64, 9, False, torch.bfloat16),
    (2, 16, 4, 2, 16, 5, True, torch.float32),
])
def test_decode_op_cpu_path_is_the_torch_path(b, s, h, kv, hd, pos, rope,
                                              dtype):
    """On CPU tensors the op takes the plain path, whose output and cache
    writes at a 0-d int32 position are bitwise the models' former torch
    path at the int, and launches nothing."""
    cfg = get_config("granite_8b").with_(n_heads=h, n_kv_heads=kv,
                                         head_dim=hd)
    assert cfg.hd == hd
    q, k, v, ck, cv = _inputs(b, s, h, kv, hd, dtype)
    want_ck, want_cv = ck.clone(), cv.clone()
    want = _torch_path(cfg, q, k, v, want_ck, want_cv, pos, rope)
    before = dict(decode_attention.launches_by_regime)
    at = torch.tensor(pos, dtype=torch.int32)
    got = decode_attention(q, k, v, ck, cv, at,
                           rope_table(cfg, s, "cpu") if rope else None)
    assert int(at) == pos
    assert decode_attention.launches == 0
    assert decode_attention.launches_by_regime == before
    assert got.shape == (b, 1, h * hd) and got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(ck, want_ck) and torch.equal(cv, want_cv)


def test_model_decode_attention_goes_through_the_op(monkeypatch):
    """``models.attention.decode_attention`` hands one card's cache to the
    op, with the position tensor as it is, the RoPE table of the cache's
    length, no table when ``rope`` is off (whisper's decoder), and no
    scale (the op's 1/sqrt(hd)) for a config without an
    ``attention_multiplier``."""
    cfg = get_config("olmo_1b", smoke=True)
    params = attention.init_attn(cfg, torch.Generator().manual_seed(0),
                                 dtype=torch.bfloat16)
    cache = attention.init_kv_cache(2, 12, cfg.n_kv_heads, cfg.hd)
    x = torch.randn(2, 1, cfg.d_model).to(torch.bfloat16)
    seen = []

    def spy(q, k, v, ck, cv, pos, rope=None, scale=None):
        assert scale is None
        seen.append((pos, rope))
        return decode_attention_ref(q, k, v, ck, cv, pos, rope, scale)

    monkeypatch.setattr(attention.decode_kernel, "decode_attention", spy)
    at = [torch.tensor(p, dtype=torch.int32) for p in (5, 6)]
    attention.decode_attention(cfg, params, x, cache, at[0])
    attention.decode_attention(cfg, params, x, cache, at[1], rope=False)
    (p0, tab), (p1, none) = seen
    assert p0 is at[0] and p1 is at[1] and none is None
    assert (int(p0), int(p1)) == (5, 6)
    assert tab is rope_table(cfg, 12, "cpu")
    assert tab[0].shape == (12, cfg.hd // 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", ["olmo_1b", "granite_8b", "llava_next_34b"])
def test_token_projections_are_qkv_bitwise(arch, dtype):
    """The decode path's one-token projections (one ``torch.mm`` each on
    x as [B, D]) give ``_qkv``'s bits: ``x @ w`` folds to the same
    product."""
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(1)
    params = attention.init_attn(cfg, gen, dtype=torch.float32)
    x = torch.randn((3, 1, cfg.d_model), generator=gen).to(dtype)
    want = attention._qkv(cfg, params, x)
    got = attention._qkv_token(cfg, params, x)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if get_config(a).n_heads])
@pytest.mark.parametrize("smoke", [False, True])
def test_rope_table_is_rope_freqs_at_every_position(arch, smoke):
    """Row p of the table is ``rope_freqs`` at [p], bitwise, for every
    position of a 1024-slot cache at each attention config's head dim;
    the table is built once per (head dim, theta, length, device)."""
    cfg = get_config(arch, smoke=smoke)
    cos, sin = rope_table(cfg, 1024, "cpu")
    assert cos.dtype == sin.dtype == torch.float32
    assert cos.shape == sin.shape == (1024, cfg.hd // 2)
    for p in range(1024):
        c, s = rope_freqs(cfg, torch.tensor([p]))
        assert torch.equal(cos[p], c[0]) and torch.equal(sin[p], s[0]), p
    assert rope_table(cfg, 1024, torch.device("cpu"))[0] is cos
    assert rope_table(cfg, 1023, "cpu")[0] is not cos


@pytest.mark.parametrize("b,kv,keys,sms,want", [
    (32, 16, 512, 132, (1, 512)),    # olmo_1b decode, pos 511: 512 pairs
    (32, 16, 640, 132, (1, 640)),    # olmo_1b decode, pos 639
    (4, 8, 576, 132, (5, 128)),      # granite_8b decode: 32 pairs
    (4, 8, 512, 132, (4, 128)),
    (1, 8, 640, 132, (10, 64)),      # capped by 64 keys a split
    (1, 1, 4096, 132, (16, 256)),    # capped at 16 splits
    (4, 8, 100, 132, (1, 128)),      # too few keys to split
    (2, 8, 1, 132, (1, 32)),         # pos 0
    (8, 16, 640, 132, (2, 320)),     # 128 pairs, just short of 132 SMs
])
def test_decode_split_plan(b, kv, keys, sms, want):
    """The split chooser is a pure function of (B, KV, keys, SMs): splits
    only while B * KV is below the SM count, every split non-empty,
    chunks a whole number of the warps' 32-key rounds."""
    splits, chunk = split_plan(b, kv, keys, sms)
    assert split_plan.__wrapped__(b, kv, keys, sms) == (splits, chunk)
    assert (splits, chunk) == want
    assert chunk % decode_ops.WARP_KEYS == 0
    assert (splits - 1) * chunk < keys <= splits * chunk
    assert splits == 1 or b * kv < sms
    assert decode_ops.regime(splits) == ("split" if splits > 1
                                         else "no split")


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case,match", [
    ("float32", "bfloat16"),
    ("group_9", "whole groups"),
    ("gqa_3_over_2", "whole groups"),
    ("head_dim_136", "head dim"),
    ("head_dim_20", "head dim"),
    ("cache_stride", "strides a multiple of 8"),
    ("misaligned_cache", "aligned"),
    ("kv_shape", "shape mismatch"),
    ("rope_short", "RoPE table"),
    ("rope_float64", "RoPE table"),
])
def test_decode_admission_rejects(case, match):
    """What the kernel cannot take is refused before a launch; its RoPE
    table must cover every slot of the cache."""
    h, kv, hd, s = 4, 2, 64, 16
    if case == "group_9":
        h, kv = 9, 1
    elif case == "gqa_3_over_2":
        h = 3
    elif case.startswith("head_dim"):
        hd = int(case.rsplit("_", 1)[1])
    q, k, v, ck, cv = (_bf16(2, 1, h, hd), _bf16(2, 1, kv, hd),
                       _bf16(2, 1, kv, hd), _bf16(2, s, kv, hd),
                       _bf16(2, s, kv, hd))
    rope = (torch.zeros(s, hd // 2), torch.zeros(s, hd // 2))
    if case == "float32":
        q = q.float()
    elif case == "cache_stride":
        ck = _bf16(2, s, kv, hd + 4)[..., :hd]
    elif case == "misaligned_cache":
        ck = _bf16(2 * s * kv * hd + 1)[1:].view(2, s, kv, hd)
    elif case == "kv_shape":
        v = _bf16(2, 1, kv + 1, hd)
    elif case == "rope_short":
        rope = (rope[0][:s - 1], rope[1][:s - 1])
    elif case == "rope_float64":
        rope = tuple(t.double() for t in rope)
    with pytest.raises(ValueError, match=match):
        decode_ops.admit(q, k, v, ck, cv, rope)
