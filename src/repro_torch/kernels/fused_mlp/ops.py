"""Fused SwiGLU MLP op: the CUDA kernel ``csrc/fused_mlp.cu`` on CUDA
tensors, its plain version (``ref.fused_mlp_ref``) on CPU tensors.

Replaces ``repro/kernels/fused_mlp/fused_mlp.py:fused_mlp``.
``fused_mlp.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import fused_mlp_ref

TILE = 128  # K and F must be multiples of the kernel's tiles


def _bind(lib):
    fn = lib.fused_mlp_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, w1, w3, w2):
    _build.require_cuda(x, w1, w3, w2)
    if any(t.dtype != torch.bfloat16 for t in (x, w1, w3, w2)):
        raise ValueError("fused_mlp kernel takes bfloat16 only, got "
                         f"{[str(t.dtype) for t in (x, w1, w3, w2)]}")
    m, k = x.shape
    f = w1.shape[1]
    if w1.shape != (k, f) or w3.shape != (k, f) or w2.shape != (f, k):
        raise ValueError(f"shape mismatch x {tuple(x.shape)} w1 "
                         f"{tuple(w1.shape)} w3 {tuple(w3.shape)} w2 "
                         f"{tuple(w2.shape)}")
    if k % TILE or f % TILE:
        raise ValueError(f"K={k} and F={f} must be multiples of {TILE}")
    for t in (x, w1, w3, w2):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_mlp needs contiguous, 16-byte aligned "
                             "operands")


def fused_mlp(x, w1, w3, w2):
    """x [M, K]; w1/w3 [K, F]; w2 [F, K] -> [M, K]:
    silu(x W1) * (x W3) formed in fp32, rounded to x.dtype, times W2."""
    if x.dim() != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_mlp_ref(x, w1, w3, w2)
    _check(x, w1, w3, w2)
    m, k = x.shape
    f = w1.shape[1]
    ws = torch.zeros((m, k), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    lib = _build.load("fused_mlp")
    with torch.cuda.device(x.device):
        rc = _bind(lib)(x.data_ptr(), w1.data_ptr(), w3.data_ptr(),
                        w2.data_ptr(), ws.data_ptr(), y.data_ptr(), m, k, f,
                        _build.stream_ptr(x))
    _build.check(lib, "fused_mlp", rc)
    fused_mlp.launches += 1
    return y


fused_mlp.launches = 0
