"""The Mamba-2 chain's ops: the CUDA kernels ``csrc/ssm_chain.cu`` on CUDA
tensors, their plain versions (``ref.py``) on CPU tensors.

``conv_silu`` is the chain before the SSD scan (the causal depthwise conv
and SiLU of the x, B and C projections, softplus(dt + dt_bias) and A =
-exp(A_log)), ``gated_rmsnorm`` the chain after it (the D skip, the SiLU
gate and the gated RMSNorm). On the card each is one launch, which reads
its inputs once and writes its outputs once, sums in fp32 and rounds
once; ``conv_silu.launches`` and ``gated_rmsnorm.launches`` count the
calls that launched them, and while spans are live (a profiler records)
the span counter ``ssm_chain.launches_by_kind`` counts the same
launches as [conv_silu, gated_rmsnorm].

The kernels are forward-only: each op refuses inputs that autograd would
record (``_build.refuse_grad``), on any device. ``models.ssm._block``
calls them only for plain CUDA tensors with no gradient recorded (every
serving prefill) and runs the plain chain everywhere else: under
autograd, on DTensors, on the CPU. The kernels replace no Pallas kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ...launch import spans
from .. import _build
from .ref import conv_silu_ref, gated_rmsnorm_ref

CONV_K = 4          # the conv width the kernel takes, every config's (csrc: K)
MAX_WIDTH = 8192    # widest row the norm keeps in registers (csrc: MAX_VPT)
COUNTER = "ssm_chain.launches_by_kind"   # [conv_silu, gated_rmsnorm]
EPS = 1e-6          # common.rmsnorm's


def _bind(lib):
    """(conv entry, norm entry) of the loaded library, typed once."""
    if not hasattr(lib, "_chain_fns"):
        conv = lib.ssm_chain_conv_silu_bf16
        conv.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        conv.restype = ctypes.c_int
        norm = lib.ssm_chain_gated_rmsnorm_bf16
        norm.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        norm.restype = ctypes.c_int
        lib._chain_fns = conv, norm
    return lib._chain_fns


def _admit(name, bf16, fp32, vectors):
    """Raise ValueError unless ``bf16`` are bfloat16 and ``fp32`` float32,
    every tensor is contiguous and a CUDA tensor on one device, and
    ``vectors`` (those the kernel reads 16 bytes at a time) are 16-byte
    aligned."""
    if any(t.dtype != torch.bfloat16 for t in bf16) or any(
            t.dtype != torch.float32 for t in fp32):
        raise ValueError(
            f"{name} kernel takes " + "/".join(str(t.dtype) for t in bf16)
            + " as bfloat16 and " + "/".join(str(t.dtype) for t in fp32)
            + " as float32")
    if not all(t.is_contiguous() for t in (*bf16, *fp32)):
        raise ValueError(f"{name} kernel takes contiguous tensors only")
    _build.require_cuda(*bf16, *fp32)
    if any(t.data_ptr() % 16 for t in vectors):
        raise ValueError(f"{name} kernel needs 16-byte aligned data")


def admit_conv_silu(xin, bm, cm, wx, wb, wc, dt, dt_bias, a_log):
    """Raise ValueError unless the conv kernel takes these tensors: CUDA,
    contiguous, bfloat16 xin [B,S,W], bm/cm [B,S,GN], wx [K,W], wb/wc
    [K,GN], dt [B,S,H] and float32 dt_bias/a_log [H], with W and GN
    multiples of 8 and K = ``CONV_K``."""
    if xin.dim() != 3 or wx.dim() != 2:
        raise ValueError(f"conv_silu takes xin [B,S,W] and weights [K,W], "
                         f"got {tuple(xin.shape)} and {tuple(wx.shape)}")
    b, s, w = xin.shape
    k, gn = wx.shape[0], bm.shape[-1]
    h = dt.shape[-1]
    if (bm.shape != (b, s, gn) or cm.shape != bm.shape or wx.shape != (k, w)
            or wb.shape != (k, gn) or wc.shape != wb.shape
            or dt.shape != (b, s, h) or dt_bias.shape != (h,)
            or a_log.shape != (h,)):
        raise ValueError("conv_silu shape mismatch: " + ", ".join(
            str(tuple(t.shape)) for t in (xin, bm, cm, wx, wb, wc, dt,
                                          dt_bias, a_log)))
    if w % 8 or gn % 8 or k != CONV_K:
        raise ValueError(f"conv_silu kernel takes widths that are multiples "
                         f"of 8 and a conv of width {CONV_K}, got W={w} "
                         f"GN={gn} K={k}")
    _admit("conv_silu", (xin, bm, cm, wx, wb, wc, dt), (dt_bias, a_log),
           (xin, bm, cm, wx, wb, wc))


def conv_silu(xin, bm, cm, wx, wb, wc, dt, dt_bias, a_log):
    """The chain before the SSD scan. xin [B,S,W], bm/cm [B,S,GN], dt
    [B,S,H]: the prefill's projections, each sequence's first row its
    first token; wx [K,W], wb/wc [K,GN]: the depthwise conv weights;
    dt_bias, a_log [H]. Returns (xc, Bc, Cc) = SiLU of the causal conv of
    each, in their dtype and shapes, dt = softplus(dt + dt_bias) fp32
    [B,S,H] and A = -exp(a_log) fp32 [H]: the plain version on CPU
    tensors, the kernel on CUDA tensors (or ValueError)."""
    ins = (xin, bm, cm, wx, wb, wc, dt, dt_bias, a_log)
    _build.refuse_grad("conv_silu", ins,
                       "run ssm_chain.conv_silu_ref under autograd")
    if all(t.device.type == "cpu" for t in ins):
        return conv_silu_ref(*ins)
    admit_conv_silu(*ins)
    b, s, w = xin.shape
    k, gn, h = wx.shape[0], bm.shape[-1], dt.shape[-1]
    xc, bc, cc = (torch.empty_like(t) for t in (xin, bm, cm))
    dt_out = torch.empty((b, s, h), dtype=torch.float32, device=xin.device)
    a = torch.empty((h,), dtype=torch.float32, device=xin.device)
    lib = _build.load("ssm_chain")
    with _build.on_device(xin):
        rc = _bind(lib)[0](
            *(t.data_ptr() for t in (*ins, xc, bc, cc, dt_out, a)),
            b, s, w, gn, h, k, _build.stream_ptr(xin))
    _build.check(lib, "ssm_chain", rc)
    conv_silu.launches += 1
    spans.count(COUNTER, [1, 0])
    return xc, bc, cc, dt_out, a


def admit_gated_rmsnorm(y, xc, z, d, gn_scale):
    """Raise ValueError unless the norm kernel takes these tensors: CUDA,
    contiguous, bfloat16 y [B,S,H,P], xc and z [B,S,H*P], float32 d [H]
    and gn_scale [H*P], with P a multiple of 8 and H*P at most
    ``MAX_WIDTH``."""
    if y.dim() != 4:
        raise ValueError(f"gated_rmsnorm takes y [B,S,H,P], got "
                         f"{tuple(y.shape)}")
    b, s, h, p = y.shape
    if (xc.shape != (b, s, h * p) or z.shape != xc.shape or d.shape != (h,)
            or gn_scale.shape != (h * p,)):
        raise ValueError("gated_rmsnorm shape mismatch: " + ", ".join(
            str(tuple(t.shape)) for t in (y, xc, z, d, gn_scale)))
    if p % 8 or h * p > MAX_WIDTH:
        raise ValueError(f"gated_rmsnorm kernel takes a head dim that is a "
                         f"multiple of 8 and rows of at most {MAX_WIDTH}, "
                         f"got P={p} W={h * p}")
    _admit("gated_rmsnorm", (y, xc, z), (d, gn_scale), (y, xc, z, gn_scale))


def gated_rmsnorm(y, xc, z, d, gn_scale):
    """The chain after the SSD scan: rmsnorm((y + d xc) silu(z)) *
    gn_scale of the scan's y [B,S,H,P] with xc and z [B,S,H*P], d [H] and
    gn_scale [H*P], as [B,S,H*P] in y's dtype: the plain version on CPU
    tensors, the kernel on CUDA tensors (or ValueError). The kernel holds
    every value in fp32 until the one rounding of its output; eps is
    ``EPS``, as the plain version's."""
    ins = (y, xc, z, d, gn_scale)
    _build.refuse_grad("gated_rmsnorm", ins,
                       "run ssm_chain.gated_rmsnorm_ref under autograd")
    if all(t.device.type == "cpu" for t in ins):
        return gated_rmsnorm_ref(*ins)
    admit_gated_rmsnorm(*ins)
    b, s, h, p = y.shape
    out = torch.empty_like(xc)
    lib = _build.load("ssm_chain")
    with _build.on_device(y):
        rc = _bind(lib)[1](*(t.data_ptr() for t in (*ins, out)), b * s,
                           h * p, p, EPS, _build.stream_ptr(y))
    _build.check(lib, "ssm_chain", rc)
    gated_rmsnorm.launches += 1
    spans.count(COUNTER, [0, 1])
    return out


conv_silu.launches = 0
gated_rmsnorm.launches = 0
