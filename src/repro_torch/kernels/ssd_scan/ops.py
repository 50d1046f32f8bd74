"""SSD chunk-scan op: the CUDA kernels ``csrc/ssd_scan.cu`` on CUDA
tensors, its plain version (``ref.ssd_ref``) on CPU tensors.

Replaces ``repro/kernels/ssd_scan/ssd_scan.py:ssd_scan``; like
``models.ssm.ssd_chunked`` it also returns the final state. One call of
the op is one call of the C entry, which issues three kernel launches
(chunk states, state passing, chunk scan) into a workspace this wrapper
allocates; ``ssd_scan.launches`` counts calls of the op. The kernels
have no backward yet: on CUDA tensors the op raises when autograd would
record it (``_build.refuse_grad``) rather than drop the gradient.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import from_pallas_layout, ssd_ref, to_pallas_layout

HEAD_DIM = 64     # P the kernel takes
MAX_STATE = 128   # largest N the kernel takes (a multiple of 8)


def _bind(lib):
    """(entry, workspace-size function) of the loaded library, typed once."""
    if not hasattr(lib, "_ssd_fns"):
        fn = lib.ssd_scan_fwd_bf16
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        ws = lib.ssd_scan_workspace_bytes
        ws.argtypes = [ctypes.c_int] * 5
        ws.restype = ctypes.c_longlong
        lib._ssd_fns = (fn, ws)
    return lib._ssd_fns


def _check(x, dt, a, bm, cm):
    _build.require_cuda(x, dt, a, bm, cm)
    if not (x.dtype == bm.dtype == cm.dtype == torch.bfloat16
            and dt.dtype == a.dtype == torch.float32):
        raise ValueError(f"ssd_scan kernel takes bfloat16 x/B/C and float32 "
                         f"dt/A, got {x.dtype}/{bm.dtype}/{cm.dtype} and "
                         f"{dt.dtype}/{a.dtype}")
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    if (dt.shape != (b, s, h) or a.shape != (h,) or cm.shape != bm.shape
            or bm.shape[:2] != (b, s) or h % g):
        raise ValueError(f"shape mismatch x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} A {tuple(a.shape)} B "
                         f"{tuple(bm.shape)} C {tuple(cm.shape)}")
    if p != HEAD_DIM or n % 8 or n > MAX_STATE:
        raise ValueError(f"ssd_scan kernel takes head dim {HEAD_DIM} and a "
                         f"state of at most {MAX_STATE} (a multiple of 8), "
                         f"got P={p} N={n}")
    for t in (x, bm, cm):
        if (t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError("x/B/C need a unit stride on the last dim, "
                             "other strides a multiple of 8 and 16-byte "
                             "aligned data")


def ssd_scan(x, dt, a, bm, cm, chunk: int = 128):
    """Mamba-2 SSD scan, fp32 inside; returns (y in x.dtype, final state
    fp32). ``chunk`` is clipped to S and must divide S (the reference's
    rule); it changes only the rounding.

    Pallas layout: x [BH,S,P], dt [BH,S,1], a [BH,1,1], bm/cm [BH,S,N]
    -> (y [BH,S,P], state [BH,N,P]).
    Model layout: x [B,S,H,P], dt [B,S,H], a [H], bm/cm [B,S,G,N]
    -> (y [B,S,H,P], state [B,H,N,P]); head h reads group h // (H/G).
    """
    if x.dim() not in (3, 4):
        raise ValueError(f"x must be [BH,S,P] or [B,S,H,P], got "
                         f"{tuple(x.shape)}")
    pallas_layout = x.dim() == 3
    s = x.shape[1]
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    if x.device.type == "cpu":
        if pallas_layout:
            return ssd_ref(x, dt, a, bm, cm)
        y, state = ssd_ref(*to_pallas_layout(x, dt, a, bm, cm))
        return from_pallas_layout(y, state, x.shape[0])
    _build.refuse_grad(
        "ssd_scan", (x, dt, a, bm, cm),
        "training the ssm and hybrid families on the card waits for "
        "ROADMAP Queue 1's 'SSM and hybrid training' item (ssd_scan's "
        "gradient); on CPU tensors the plain version keeps autograd")
    if pallas_layout:  # as B = 1, H = G = BH: permuted views, no copy
        bh, _, p = x.shape
        y = torch.empty((bh, s, p), dtype=x.dtype, device=x.device)
        state = torch.empty((bh, bm.shape[2], p), dtype=torch.float32,
                            device=x.device)
        x4, b4, c4, y4 = (t.permute(1, 0, 2).unsqueeze(0)
                          for t in (x, bm, cm, y))
        dt4 = dt[..., 0].permute(1, 0).unsqueeze(0)
        a1 = a.reshape(bh)
    else:
        b, _, h, p = x.shape
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        state = torch.empty((b, h, bm.shape[3], p), dtype=torch.float32,
                            device=x.device)
        x4, dt4, a1, b4, c4, y4 = x, dt, a, bm, cm, y
    _check(x4, dt4, a1, b4, c4)
    b, s, h, p = x4.shape
    g, n = b4.shape[2], b4.shape[3]
    strides = (ctypes.c_longlong * 16)(
        *x4.stride()[:3], *dt4.stride(), a1.stride(0), *b4.stride()[:3],
        *c4.stride()[:3], *y4.stride()[:3])
    lib = _build.load("ssd_scan")
    fn, ws_bytes = _bind(lib)
    # (cum, dt) pairs, chunk states and previous states: ~104 MB at
    # mamba2_780m's prefill, from PyTorch's caching allocator
    work = torch.empty(ws_bytes(b, s, h, n, chunk), dtype=torch.uint8,
                       device=x.device)
    with _build.on_device(x):
        rc = fn(x4.data_ptr(), dt4.data_ptr(), a1.data_ptr(), b4.data_ptr(),
                c4.data_ptr(), y4.data_ptr(), state.data_ptr(),
                work.data_ptr(), b, s, h, g, n, p, chunk, strides,
                _build.stream_ptr(x))
    _build.check(lib, "ssd_scan", rc)
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
