"""GQA attention with RoPE: prefill (flash) path + KV-cache decode path.

PyTorch counterpart of ``repro.models.attention``. GQA is computed on
grouped queries ([B, S, KV, G, hd] against [B, S, KV, hd]); the KV
tensor is never repeated to H heads. On CUDA tensors prefill attention
runs the hand-written flash kernel through its autograd Function
(``kernels.flash_attn.FlashAttention``: the kernel forward, the
backward kernels); on CPU tensors it runs ``flash_attention`` below, the
reference's chunked online softmax, under plain autograd. Decode
attention on one card runs the hand-written decode kernel
(``kernels.decode_attn``: RoPE, the cache write and the attention in one
launch) on CUDA tensors and its plain version (RoPE, the cache writes,
``gqa_decode_attend``) on CPU tensors; a DTensor cache keeps the torch
path (``_decode_sharded``).

The kernel aligns causal queries to the END of the keys (query i sits at
key position Skv - Sq + i); ``flash_attention`` below aligns them to the
start. The two agree when Sq == Skv or the call is non-causal, which is
every call the models make; ``_prefill_attend`` raises on a causal call
with Sq != Skv, so the card and the CPU cannot part silently.

Unlike the reference, whose arrays are immutable, the KV cache here is
updated in place: prefill and decode write their keys and values into
the cache tensors they are given, and return them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.distributed.tensor import Replicate, Shard

from ..kernels import decode_attn as decode_kernel
from ..kernels import flash_attn as flash_kernel
from ..kernels.decode_attn.ref import gqa_decode_attend
from . import parallel
from .common import ModelConfig, apply_rope, dense_init, rope_freqs

KV_CHUNK = 1024


def init_attn(cfg: ModelConfig, gen: torch.Generator,
              d_model: Optional[int] = None, n_heads: Optional[int] = None,
              n_kv: Optional[int] = None, dtype=torch.float32) -> Dict:
    """wq/wk/wv/wo of one attention block; ``d_model``, ``n_heads`` and
    ``n_kv`` override the config's, as the reference's keywords do (the
    head dim stays ``cfg.hd``)."""
    d = d_model or cfg.d_model
    h = n_heads or cfg.n_heads
    kv = n_kv or cfg.n_kv_heads
    hd = cfg.hd
    return {
        "wq": dense_init(gen, d, h * hd, dtype),
        "wk": dense_init(gen, d, kv * hd, dtype),
        "wv": dense_init(gen, d, kv * hd, dtype),
        "wo": dense_init(gen, h * hd, d, dtype),
    }


def flash_attention(q, k, v, causal: bool, q_offset: int = 0,
                    chunk: int = KV_CHUNK, scale: Optional[float] = None):
    """Online-softmax attention with native GQA (the model's own path).

    q [B, Sq, H, hd]; k/v [B, Skv, KV, hd] with H = KV * G; queries
    start-aligned at ``q_offset``; the softmax scale ``scale``, by default
    1/sqrt(hd). Returns [B, Sq, H, hd]."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    chunk = min(chunk, skv)
    while skv % chunk:
        chunk -= 1  # largest divisor of skv below the target chunk
    scale = torch.tensor(1.0 / (hd ** 0.5) if scale is None else scale,
                         dtype=q.dtype)
    qf = (q * scale).reshape(b, sq, kv, g, hd).float()
    q_pos = q_offset + torch.arange(sq, device=q.device)

    acc = torch.zeros((b, sq, kv, g, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, kv, g, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, kv, g, sq), device=q.device)
    for c0 in range(0, skv, chunk):
        # operands stay in model dtype; products accumulate in fp32
        kb = k[:, c0:c0 + chunk].to(q.dtype).float()
        vb = v[:, c0:c0 + chunk].to(q.dtype).float()
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, kb)
        if causal:
            k_pos = c0 + torch.arange(chunk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = s.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckd->bqkgd", p.to(q.dtype).float(), vb)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l.permute(0, 3, 1, 2)[..., None], min=1e-20)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _attend_local(q, k, v, causal: bool, scale: Optional[float] = None):
    """Kernel on CUDA (under autograd), the model's chunked flash on
    CPU; softmax scale ``scale`` (None: 1/sqrt(hd))."""
    if q.is_cuda:
        return flash_kernel.FlashAttention.apply(q, k, v, causal, scale)
    return flash_attention(q, k, v, causal=causal, scale=scale)


def _attend_sharded(q, k, v, causal: bool, scale: Optional[float] = None):
    """``_attend_local`` on each rank's shard of DTensor q, k, v
    [B, S, heads, hd]: the batch as sharded, the heads over "model" when
    both H and KV divide its size. When only H divides and the model
    axis is a multiple of KV, each rank's query heads fall in one KV
    head: k and v are replicated and each rank takes its KV head. Else,
    or when "model" shards the batch (the dp plan), every rank runs all
    heads of its rows."""
    mesh = q.device_mesh
    md = mesh.mesh_dim_names.index("model")
    m = mesh.size(md)
    h, kv = q.shape[2], k.shape[2]
    batch = parallel.batch_placements(q)
    heads = parallel.on_model(batch, 2, mesh)
    split = not isinstance(batch[md], Shard)
    fn = _attend_local
    if split and h % m == 0 and kv % m == 0:
        qp = kvp = heads
    elif split and h % m == 0 and m % kv == 0:
        qp, kvp = heads, batch
        j = mesh.get_local_rank(md) // (m // kv)

        def fn(q, k, v, causal, scale):
            return _attend_local(q, k[:, :, j:j + 1], v[:, :, j:j + 1],
                                 causal, scale)
    else:
        qp = kvp = batch
    return parallel.local_call(fn, qp, (qp, kvp, kvp, None, None), q, k, v,
                               causal, scale)


def _prefill_attend(q, k, v, causal: bool, scale: Optional[float] = None):
    """Prefill attention: ``_attend_local``, or ``_attend_sharded`` on
    DTensors. Raises ValueError on a causal call with Sq != Skv, where the
    kernel and the CPU path align the queries differently (module
    docstring)."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"causal attention with {q.shape[1]} queries and "
                         f"{k.shape[1]} keys: the kernel end-aligns the "
                         "queries, the CPU path start-aligns them")
    if parallel.is_dtensor(q):
        return _attend_sharded(q, k, v, causal, scale)
    return _attend_local(q, k, v, causal, scale)


def _qkv(cfg: ModelConfig, params, x, kv_x=None, n_heads=None, n_kv=None):
    """q from ``x``; k and v from ``kv_x`` (cross-attention) or ``x``."""
    h = n_heads or cfg.n_heads
    kv = n_kv or cfg.n_kv_heads
    hd = cfg.hd
    src = x if kv_x is None else kv_x
    b, s, _ = x.shape
    sk = src.shape[1]
    q = parallel.splittable(x @ params["wq"].to(x.dtype), h)
    k = parallel.splittable(src @ params["wk"].to(x.dtype), kv)
    v = parallel.splittable(src @ params["wv"].to(x.dtype), kv)
    return (q.reshape(b, s, h, hd), k.reshape(b, sk, kv, hd),
            v.reshape(b, sk, kv, hd))


def _qkv_token(cfg: ModelConfig, params, x, n_heads=None, n_kv=None):
    """``_qkv`` of one decode token on one card with fewer dispatched ops,
    each host time in a decode step: x [B, 1, D] as a [B, D] matrix and
    one ``torch.mm`` a weight, the product ``x @ w`` folds to (the same
    bits); a weight already in x's dtype is used as it is."""
    h = n_heads or cfg.n_heads
    kv = n_kv or cfg.n_kv_heads
    hd = cfg.hd
    b = x.shape[0]
    x2 = x.reshape(b, -1)

    def proj(w, n):
        w = w if w.dtype == x.dtype else w.to(x.dtype)
        return torch.mm(x2, w).view(b, 1, n, hd)

    return (proj(params["wq"], h), proj(params["wk"], kv),
            proj(params["wv"], kv))


def _rope_qk(cfg: ModelConfig, q, k, positions=None, kv_positions=None):
    """RoPE on q at ``positions`` and on k at ``kv_positions`` (both
    default to [0, S))."""
    if positions is None:
        positions = torch.arange(q.shape[1], device=q.device)
    cos, sin = rope_freqs(cfg, positions)
    q = apply_rope(q, cos, sin)
    if kv_positions is not None:
        cos, sin = rope_freqs(cfg, kv_positions)
    return q, apply_rope(k, cos, sin)


def attention(cfg: ModelConfig, params: Dict, x, *, causal=True,
              positions=None, kv_x=None, kv_positions=None, n_heads=None,
              n_kv=None):
    """Full (pre)fill attention. ``kv_x`` [B, Skv, D] makes it
    cross-attention: k and v are projected from ``kv_x`` and RoPE is
    skipped. Self-attention applies RoPE (when the config uses it) to q
    at ``positions`` and to k at ``kv_positions`` (default: [0, S))."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, params, x, kv_x, n_heads, n_kv)
    if kv_x is None and cfg.use_rope:
        q, k = _rope_qk(cfg, q, k, positions, kv_positions)
    out = _prefill_attend(q, k, v, causal, cfg.softmax_scale())
    return out.reshape(b, s, -1) @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# KV-cache decode path
# ---------------------------------------------------------------------------

def init_kv_cache(b: int, s_max: int, n_kv: int, hd: int,
                  dtype=torch.bfloat16, device=None):
    return {"k": torch.zeros((b, s_max, n_kv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((b, s_max, n_kv, hd), dtype=dtype,
                             device=device)}


def init_pos(device=None):
    """A cache's decode position: a 0-d int32 zero on ``device``, which
    prefill sets and each decode step advances in place."""
    return torch.zeros((), dtype=torch.int32, device=device)


def prefill_into_cache(cfg: ModelConfig, params, x, cache, *,
                       n_heads=None, n_kv=None):
    """Run prefill attention AND write k/v into the cache at [0, S)."""
    b, s, _ = x.shape
    if s > cache["k"].shape[1]:
        raise ValueError(f"prompt of {s} tokens exceeds the cache's "
                         f"{cache['k'].shape[1]} slots")
    q, k, v = _qkv(cfg, params, x, n_heads=n_heads, n_kv=n_kv)
    if cfg.use_rope:
        q, k = _rope_qk(cfg, q, k)
    parallel.write(cache["k"], k, (slice(None), slice(0, s)))
    parallel.write(cache["v"], v, (slice(None), slice(0, s)))
    out = _prefill_attend(q, k, v, True, cfg.softmax_scale())
    return out.reshape(b, s, -1) @ params["wo"].to(x.dtype), cache


def decode_attention(cfg: ModelConfig, params, x, cache, pos, *,
                     n_heads=None, n_kv=None,
                     rope: Optional[bool] = None):
    """One-token decode: x [B, 1, D]; cache k/v [B, S_max, kv, hd]; ``pos``
    the cache's position, a 0-d int32 on its device (``init_pos``), read
    there and never on the host. RoPE at ``pos`` when ``rope`` (default:
    the config's ``use_rope``). On one card's cache
    ``kernels.decode_attn.decode_attention`` rotates, writes and attends,
    with the RoPE table built once per cache length (``rope_table``). A
    DTensor cache rotates here and goes to ``_decode_sharded``, each rank
    with its local copy of ``pos``."""
    ck, cv = cache["k"], cache["v"]
    use_rope = cfg.use_rope if rope is None else rope
    if parallel.is_dtensor(ck) or parallel.is_dtensor(x):
        pos = pos.to_local()        # replicated by the cache specs
        q, k, v = _qkv(cfg, params, x, n_heads=n_heads, n_kv=n_kv)
        if use_rope:
            q, k = _rope_qk(cfg, q, k, pos.view(1))
        out = _decode_sharded(q, ck, cv, pos, k, v, cfg.softmax_scale())
        return out.to(x.dtype) @ params["wo"].to(x.dtype), cache
    q, k, v = _qkv_token(cfg, params, x, n_heads, n_kv)
    table = (decode_kernel.rope_table(cfg, ck.shape[1], ck.device)
             if use_rope else None)
    out = decode_kernel.decode_attention(q, k, v, ck, cv, pos, table,
                                         cfg.softmax_scale())
    wo = params["wo"]
    wo = wo if wo.dtype == x.dtype else wo.to(x.dtype)
    y = torch.mm(out.view(out.shape[0], -1), wo)    # out is in x's dtype
    return y.view(x.shape[0], 1, -1), cache


def attend_cache(q, ck, cv, pos: int):
    """``gqa_decode_attend`` of q [B,1,H,hd] against the cache at keys
    [0, pos]; on DTensor caches, on each rank's shards
    (``_decode_sharded``, nothing written)."""
    if parallel.is_dtensor(ck):
        return _decode_sharded(q, ck, cv, pos)
    return gqa_decode_attend(q, ck, cv, pos)


def _decode_sharded(q, ck, cv, pos, k=None, v=None, scale=None):
    """Write k/v (when given) at ``pos`` (a plain 0-d integer tensor on
    the rank's device; an int for the cross cache's last frame) into
    DTensor caches [B, S, KV, hd] placed by ``launch.sharding.cache_specs``
    and attend, on each rank's shards: q, k and v take the cache's batch
    and kv-head sharding and are replicated over the mesh dims that shard
    its sequence (split-KV decode), at softmax scale ``scale`` (None:
    1/sqrt(hd)). Every rank writes one slot of its
    shard on the device: the new key where the shard holds ``pos``, else
    the slot's own value back; ``gqa_decode_attend`` reduces over the
    groups that split the sequence (none when it is whole)."""
    mesh = ck.device_mesh
    keep = tuple(p if isinstance(p, Shard) and p.dim in (0, 2)
                 else Replicate() for p in ck.placements)
    seq_dims = parallel.mesh_dims_sharding(ck, 1)
    index = 0
    for d in seq_dims:
        index = index * mesh.size(d) + mesh.get_local_rank(d)
    groups = [mesh.get_group(d) for d in seq_dims]

    def local(q, ck, cv, k, v):
        at = pos - index * ck.shape[1]
        if k is not None:
            slot = at.clamp(0, ck.shape[1] - 1).view(1).long()
            mine = (at >= 0) & (at < ck.shape[1])
            for c, new in ((ck, k), (cv, v)):
                c.index_copy_(1, slot, torch.where(mine, new,
                                                   c.index_select(1, slot)))
        return gqa_decode_attend(q, ck, cv, at, groups, scale)

    kvp = keep if k is not None else None
    return parallel.local_call(local, keep, (keep, ck.placements,
                                             cv.placements, kvp, kvp),
                               q, ck, cv, k, v)
