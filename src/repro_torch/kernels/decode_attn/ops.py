"""Decode attention op: the CUDA kernel ``csrc/decode_attn.cu`` on CUDA
tensors, its plain version (``ref.decode_attention_ref``) on CPU tensors.

One call is one layer's attention for one decode step: RoPE on the new
token's query and key (when a RoPE table is given), the new key and value
written into the KV cache at ``pos`` in place, and attention of the
query over the cache's keys [0, pos], GQA without repeating the KV heads.
On the card that is one launch (two when the keys are split), with
``pos`` a 0-d int32 tensor on the card that the kernel reads there (a
decode step captured in a CUDA graph advances it on the card between
replays): no host-to-device copy, no synchronisation, no fp32 copy of
the cache. The keys are split by ``split_plan`` of the cache's
capacity, whatever the position, and the splits past ``pos`` add
nothing.

The kernel replaces no Pallas kernel: the JAX reference's decode
attention is plain jnp. ``decode_attention.launches`` counts calls that
launched the kernel, and ``decode_attention.launches_by_regime`` splits
them by ``regime``: whether ``split_plan`` cut the keys into splits.
The same launches by regime also go to the span counter ``COUNTER``
(``launch.spans.count``, [no split, split]), which counts only while
spans are live, so a profiled window reads its own launches; a decode
step replayed from a CUDA graph adds to both (``kernels.counters.add``).

Head dims the kernel does not take natively (any multiple of 8 up to
128) run on a tile padded to ``padded_head_dim`` whose lanes past the
head dim load zeros; the cache is read and written in place, never
padded. ``rope_table`` builds the fp32 cos/sin table once per (head dim,
rope_theta, cache length, device).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ...launch import spans
from ...models.common import rope_freqs
from .ref import decode_attention_ref

HEAD_DIMS = (64, 128)    # the kernel's padded tiles
MAX_GROUP = 8            # query heads a KV head (csrc: MAX_G)
WARP_KEYS = 32           # keys of a round of the four warps (WARPS * TILE)
MIN_SPLIT_KEYS = 64      # fewest keys a split is given
MAX_SPLITS = 16
REGIMES = ("no split", "split")
COUNTER = "decode_attention.launches_by_regime"   # span counter, by REGIMES

_TABLES = {}


def padded_head_dim(hd: int) -> int:
    """The tile width the kernel runs for head dim ``hd``: 64 up to 64,
    else 128. Raises ValueError unless ``hd`` is a multiple of 8 up to
    128."""
    if hd % 8 or not 0 < hd <= HEAD_DIMS[-1]:
        raise ValueError(f"head dim {hd} not a multiple of 8 in "
                         f"[8, {HEAD_DIMS[-1]}]")
    return next(d for d in HEAD_DIMS if d >= hd)


@functools.lru_cache(maxsize=4096)
def split_plan(b: int, kv: int, keys: int, sms: int):
    """(splits, chunk) for ``keys`` keys (the cache's length: the kernel
    splits the whole cache, whatever the position) of ``b`` rows of ``kv``
    KV heads on ``sms`` SMs: the keys cut into ``splits`` ranges of
    ``chunk`` keys, each non-empty. The kernel runs a block per (row, KV
    head, split) and each block streams its range at the card's rate
    when enough blocks are in flight, so the keys are split only while
    the (row, head) pairs alone give fewer blocks than SMs: up to a block
    per SM, no split below ``MIN_SPLIT_KEYS`` keys, at most
    ``MAX_SPLITS``. ``chunk`` is a multiple of ``WARP_KEYS``, so every
    warp of a block gets as many tiles."""
    pairs = b * kv
    want = 1 if pairs >= sms else -(-sms // pairs)
    splits = max(1, min(want, MAX_SPLITS, keys // MIN_SPLIT_KEYS))
    chunk = -(-keys // splits)
    chunk = -(-chunk // WARP_KEYS) * WARP_KEYS
    return -(-keys // chunk), chunk


def regime(splits: int) -> str:
    """The key of ``decode_attention.launches_by_regime`` for a call."""
    return REGIMES[splits > 1]


def rope_table(cfg, s_max: int, device):
    """(cos, sin), each fp32 [s_max, hd/2] on ``device``: ``rope_freqs``
    at positions [0, s_max), built at the first call for a (head dim,
    rope_theta, s_max, device) and kept. Row p equals ``rope_freqs`` at
    [p] bitwise: the same elementwise fp32 operations."""
    device = torch.device(device)
    key = (cfg.hd, cfg.rope_theta, s_max, device)
    tab = _TABLES.get(key)
    if tab is None:
        tab = _TABLES[key] = rope_freqs(cfg, torch.arange(s_max,
                                                          device=device))
    return tab


@functools.lru_cache(maxsize=None)
def _scale(hd: int, scale=None) -> float:
    """The softmax scale (``scale``, or 1/sqrt(hd)) rounded to bf16, the
    torch path's bf16 scalar."""
    return float(torch.tensor(1.0 / (hd ** 0.5) if scale is None else scale,
                              dtype=torch.bfloat16))


def _bind(lib):
    if not hasattr(lib, "_decode_fn"):
        fn = lib.decode_attn_bf16
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong),
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib._decode_fn = fn
    return lib._decode_fn


def admit(q, k, v, ck, cv, rope=None):
    """Raise ValueError unless the kernel takes these tensors at any
    position of the cache: bfloat16 q [B,1,H,hd], k/v [B,1,KV,hd], cache
    ck/cv [B,S,KV,hd]; at most ``MAX_GROUP`` query heads a KV head; a
    head dim ``padded_head_dim`` takes; a unit stride on hd; cache
    strides multiples of 8 elements and 16-byte aligned cache data (its
    16-byte loads); a RoPE table of fp32 contiguous [>= S, hd/2] cos and
    sin. (The kernel traps on a position outside [0, S).) Returns the 14
    element strides the kernel takes. Each property is read once: the
    check runs at every layer of a decode step."""
    if not (q.dtype == k.dtype == v.dtype == ck.dtype == cv.dtype
            == torch.bfloat16):
        raise ValueError("decode_attention kernel takes bfloat16 only, got "
                         + "/".join(str(t.dtype) for t in (q, k, v, ck, cv)))
    qsh, ksh, csh = q.shape, k.shape, ck.shape
    if len(qsh) != 4 or len(csh) != 4:
        raise ValueError("q, k, v and the cache must be 4-D")
    b, one, h, hd = qsh
    kv = csh[2]
    if (one != 1 or ksh != (b, 1, kv, hd) or v.shape != ksh
            or csh[0] != b or csh[3] != hd or cv.shape != csh):
        raise ValueError(f"shape mismatch q {tuple(qsh)} k {tuple(ksh)} v "
                         f"{tuple(v.shape)} cache {tuple(csh)} / "
                         f"{tuple(cv.shape)}")
    if h % kv or h // kv > MAX_GROUP:
        raise ValueError(f"{h} query heads over {kv} KV heads: the kernel "
                         f"takes whole groups of at most {MAX_GROUP}")
    padded_head_dim(hd)
    qs, ks, vs, cks, cvs = (q.stride(), k.stride(), v.stride(), ck.stride(),
                            cv.stride())
    if qs[3] != 1 or ks[3] != 1 or vs[3] != 1 or cks[3] != 1 or cvs[3] != 1:
        raise ValueError("q, k, v and the cache need a unit stride on hd")
    if ((cks[0] | cks[1] | cks[2] | cvs[0] | cvs[1] | cvs[2]) % 8
            or (ck.data_ptr() | cv.data_ptr()) % 16):
        raise ValueError("the cache needs strides a multiple of 8 and "
                         "16-byte aligned data")
    if rope is not None:
        cos, sin = rope
        tsh = cos.shape
        if (cos.dtype != torch.float32 or sin.dtype != torch.float32
                or sin.shape != tsh or len(tsh) != 2 or tsh[0] < csh[1]
                or tsh[1] != hd // 2 or not cos.is_contiguous()
                or not sin.is_contiguous()):
            raise ValueError(f"RoPE table {tuple(tsh)} {cos.dtype} / "
                             f"{tuple(sin.shape)} {sin.dtype}: needs "
                             f"contiguous float32 [>= {csh[1]}, {hd // 2}]")
    return (qs[0], qs[2], ks[0], ks[2], vs[0], vs[2], *cks[:3], *cvs[:3],
            h * hd, hd)


@functools.lru_cache(maxsize=256)
def _strides_arg(strides):
    """The kernel's stride array for a strides tuple, made once: the kernel
    copies it at the launch, and decode repeats a few tuples."""
    return (ctypes.c_longlong * len(strides))(*strides)


def decode_attention(q, k, v, ck, cv, pos, rope=None, scale=None):
    """Attention of the new token over the KV cache, with the cache write.

    q [B,1,H,hd], k/v [B,1,KV,hd]: the new token's projections, before
    RoPE; ck/cv [B,S,KV,hd]: the cache, written in place at ``pos``, a
    0-d int32 tensor on q's device, read there (module docstring);
    ``rope``: the (cos, sin) table of ``rope_table``, or None for no
    RoPE; ``scale``: the softmax scale, None for 1/sqrt(hd). Returns the
    attention over keys [0, pos] as [B, 1, H*hd] in q's dtype: the plain
    version on CPU tensors, the kernel on CUDA tensors (or ValueError)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, ck, cv, pos, rope, scale)
    _build.refuse_grad("decode_attention", (q, k, v),
                       "decode under torch.no_grad or inference_mode")
    if getattr(pos, "dtype", None) != torch.int32 or pos.dim():
        raise ValueError("the decode position must be a 0-d int32 tensor "
                         f"on q's device, got {type(pos).__name__} "
                         f"{getattr(pos, 'dtype', '')}")
    tabs = () if rope is None else tuple(rope)
    others = (k, v, ck, cv, *tabs, pos)
    dev = q.get_device()
    if dev < 0 or any(t.get_device() != dev for t in others):
        _build.require_cuda(q, *others)   # raises, naming them
    b, _, h, hd = q.shape
    slots, kv = ck.shape[1], ck.shape[2]
    strides = admit(q, k, v, ck, cv, rope)
    splits, chunk = split_plan(b, kv, slots, _build.sm_count(dev))
    out = torch.empty((b, 1, h * hd), dtype=q.dtype, device=q.device)
    work = (torch.empty(b * kv * splits * (h // kv)
                        * (padded_head_dim(hd) + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    cos, sin = (t.data_ptr() for t in tabs) if tabs else (None, None)
    lib = _build.load("decode_attn")
    with _build.on_device(q):
        rc = _bind(lib)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ck.data_ptr(),
            cv.data_ptr(), cos, sin, out.data_ptr(),
            None if work is None else work.data_ptr(),
            b, h, kv, hd, slots, pos.data_ptr(), splits, chunk,
            _scale(hd, scale),
            _strides_arg(strides), _build.stream_ptr(q))
    _build.check(lib, "decode_attn", rc)
    decode_attention.launches += 1
    decode_attention.launches_by_regime[regime(splits)] += 1
    spans.count(COUNTER, [int(splits == 1), int(splits > 1)])
    return out


decode_attention.launches = 0
decode_attention.launches_by_regime = dict.fromkeys(REGIMES, 0)
