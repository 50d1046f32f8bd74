"""GQA attention with RoPE: prefill (flash) path + KV-cache decode path.

PyTorch counterpart of ``repro.models.attention``. GQA is computed on
grouped queries ([B, S, KV, G, hd] against [B, S, KV, hd]); the KV
tensor is never repeated to H heads. On CUDA tensors prefill attention
runs the hand-written flash kernel (``kernels.flash_attn``); on CPU
tensors it runs ``flash_attention`` below, the reference's chunked
online softmax. The decode path has no kernel and stays in torch.

Unlike the reference, whose arrays are immutable, the KV cache here is
updated in place: prefill and decode write their keys and values into
the cache tensors they are given, and return them.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..kernels import flash_attn as flash_kernel
from .common import ModelConfig, apply_rope, dense_init, rope_freqs

KV_CHUNK = 1024


def init_attn(cfg: ModelConfig, gen: torch.Generator,
              dtype=torch.float32) -> Dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": dense_init(gen, d, h * hd, dtype),
        "wk": dense_init(gen, d, kv * hd, dtype),
        "wv": dense_init(gen, d, kv * hd, dtype),
        "wo": dense_init(gen, h * hd, d, dtype),
    }


def flash_attention(q, k, v, causal: bool, q_offset: int = 0,
                    chunk: int = KV_CHUNK):
    """Online-softmax attention with native GQA (the model's own path).

    q [B, Sq, H, hd]; k/v [B, Skv, KV, hd] with H = KV * G; queries
    start-aligned at ``q_offset``. Returns [B, Sq, H, hd]."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    chunk = min(chunk, skv)
    while skv % chunk:
        chunk -= 1  # largest divisor of skv below the target chunk
    scale = torch.tensor(1.0 / (hd ** 0.5), dtype=q.dtype)
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


def _prefill_attend(q, k, v, causal: bool):
    """Kernel on CUDA, the model's chunked flash on CPU."""
    if q.is_cuda:
        return flash_kernel.flash_attention(q, k, v, causal=causal)
    return flash_attention(q, k, v, causal=causal)


def _qkv(cfg: ModelConfig, params, x):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, h, hd)
    k = (x @ params["wk"].to(x.dtype)).reshape(b, s, kv, hd)
    v = (x @ params["wv"].to(x.dtype)).reshape(b, s, kv, hd)
    return q, k, v


def _prefill_qkv(cfg: ModelConfig, params, x):
    """q, k, v for positions [0, S), RoPE applied."""
    q, k, v = _qkv(cfg, params, x)
    if cfg.use_rope:
        pos = torch.arange(x.shape[1], device=x.device)
        cos, sin = rope_freqs(cfg, pos)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def attention(cfg: ModelConfig, params: Dict, x, *, causal=True):
    """Full (pre)fill self-attention with RoPE."""
    b, s, _ = x.shape
    q, k, v = _prefill_qkv(cfg, params, x)
    out = _prefill_attend(q, k, v, causal)
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


def prefill_into_cache(cfg: ModelConfig, params, x, cache):
    """Run prefill attention AND write k/v into the cache at [0, S)."""
    b, s, _ = x.shape
    if s > cache["k"].shape[1]:
        raise ValueError(f"prompt of {s} tokens exceeds the cache's "
                         f"{cache['k'].shape[1]} slots")
    q, k, v = _prefill_qkv(cfg, params, x)
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    out = _prefill_attend(q, k, v, True)
    return out.reshape(b, s, -1) @ params["wo"].to(x.dtype), cache


def gqa_decode_attend(q, ck, cv, pos: int):
    """q [B,1,H,hd] against cache [B,S,KV,hd] without repeating KV.

    Operands are rounded to the query dtype, products accumulate in
    fp32; keys past ``pos`` are masked."""
    b, _, h, hd = q.shape
    s_max, kv = ck.shape[1], ck.shape[2]
    g = h // kv
    scale = torch.tensor(1.0 / (hd ** 0.5), dtype=q.dtype)
    qg = (q * scale).reshape(b, kv, g, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, ck.to(q.dtype).float())
    mask = torch.arange(s_max, device=q.device) <= pos
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(q.dtype).float(),
                       cv.to(q.dtype).float())
    return out.reshape(b, 1, h * hd)


def decode_attention(cfg: ModelConfig, params, x, cache, pos: int):
    """One-token decode: x [B, 1, D]; cache k/v [B, S_max, kv, hd]."""
    if not 0 <= pos < cache["k"].shape[1]:
        raise ValueError(f"decode position {pos} outside the cache's "
                         f"{cache['k'].shape[1]} slots")
    q, k, v = _qkv(cfg, params, x)
    if cfg.use_rope:
        cos, sin = rope_freqs(cfg, torch.tensor([pos], device=x.device))
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    cache["k"][:, pos] = k[:, 0]
    cache["v"][:, pos] = v[:, 0]
    out = gqa_decode_attend(q, cache["k"], cache["v"], pos)
    y = out.to(x.dtype) @ params["wo"].to(x.dtype)
    return y, cache
