"""Flash attention op: the CUDA kernel ``csrc/flash_attn.cu`` on CUDA
tensors, its plain version (``ref.attention_ref``) on CPU tensors.

Replaces ``repro/kernels/flash_attn/flash_attn.py:flash_attention``.
``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import attention_ref

HEAD_DIMS = (64, 80, 96, 128)


def _bind(lib):
    fn = lib.flash_attn_fwd_bf16
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong),
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _to_bshd(t):
    """[BH, S, hd] (Pallas layout) as a [1, S, BH, hd] view, no copy."""
    return t.permute(1, 0, 2).unsqueeze(0)


def _check(q, k, v):
    _build.require_cuda(q, k, v)
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash_attention kernel takes bfloat16 only, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads not a multiple of "
                         f"{k.shape[2]} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    for t in (q, k, v):
        if (t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError("q/k/v need a unit stride on hd, other strides "
                             "a multiple of 8 and 16-byte aligned data")


def flash_attention(q, k, v, causal: bool = True):
    """softmax(q k^T / sqrt(hd)) v with native GQA; causal queries are
    end-aligned (they sit at the last Sq of the Skv keys).

    Pallas layout: q [BH, Sq, hd], k/v [BKV, Skv, hd] -> [BH, Sq, hd].
    Model layout: q [B, Sq, H, hd], k/v [B, Skv, KV, hd] -> [B, Sq, H, hd].
    """
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError("q, k, v must all be 3-D or all 4-D")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal)
    pallas_layout = q.dim() == 3
    if pallas_layout:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        q4, k4, v4, o4 = (_to_bshd(t) for t in (q, k, v, out))
    else:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        q4, k4, v4, o4 = q, k, v, out
    _check(q4, k4, v4)
    b, sq, h, hd = q4.shape
    skv, kv = k4.shape[1], k4.shape[2]
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q4, k4, v4, o4) for s in t.stride()[:3]))
    lib = _build.load("flash_attn")
    with torch.cuda.device(q.device):
        rc = _bind(lib)(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                        o4.data_ptr(), b, h, kv, sq, skv, hd, int(causal),
                        1.0 / (hd ** 0.5), strides, _build.stream_ptr(q))
    _build.check(lib, "flash_attn", rc)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
