"""SSD chunk-scan op: the CUDA kernels ``csrc/ssd_scan.cu`` on CUDA
tensors, its plain version (``ref.ssd_ref``) on CPU tensors; and its
backward: the CUDA kernels ``csrc/ssd_scan_bwd.cu`` on CUDA tensors, the
plain ``ssd_scan_bwd`` on CPU tensors.

Replaces ``repro/kernels/ssd_scan/ssd_scan.py:ssd_scan``; like
``models.ssm.ssd_chunked`` it also returns the final state. One call of
the op is one call of the C entry, which issues three kernel launches
(chunk states, state passing, chunk scan) into a workspace this wrapper
allocates; ``ssd_scan.launches`` counts calls of the forward op. One call
of ``ssd_scan_backward`` on the card is one call of its C entry (six
launches, reading the chunk states the forward kept under autograd);
``ssd_scan.bwd_launches`` counts those calls.

Head dims below the kernel's 64 (any multiple of 8, e.g. the smoke
configs' 16) are zero-padded on P inside the op (``padded_head_dim``):
the channels along P are independent, so y and the final state are the
real channels' values, sliced. The full configs have P = 64 and never
pad.

``SSDScan`` puts the op under autograd: its forward is the op (the
kernel on the card, in every forward, the recompute under remat
included), its backward is ``ssd_scan_backward`` (the backward kernels
on the card; on the CPU ``ssd_scan_bwd``, the chain rule of the chunked
form ``models.ssm.ssd_chunked``). The raw op refuses to launch when
autograd would record it (``_build.refuse_grad``). ``SSDScan``'s forward
and backward run in the spans ``kernel.ssd_scan.fwd`` and
``kernel.ssd_scan.bwd`` (``launch.spans``).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...launch.spans import span
from .. import _build
from .ref import from_pallas_layout, ssd_ref, to_pallas_layout

HEAD_DIM = 64     # P the kernel takes
MAX_STATE = 128   # largest N the kernel takes (a multiple of 8)


def padded_head_dim(p: int) -> int:
    """The head dim the kernel runs for a real head dim ``p``: always
    ``HEAD_DIM``. Raises ValueError unless ``p`` is a multiple of 8 up to
    ``HEAD_DIM``."""
    if p % 8 or not 0 < p <= HEAD_DIM:
        raise ValueError(f"ssd_scan kernel takes a head dim that is a "
                         f"multiple of 8 up to {HEAD_DIM}, got P={p}")
    return HEAD_DIM


def _bind(lib):
    """(entry, workspace-size function, kept-size function) of the loaded
    library, typed once."""
    if not hasattr(lib, "_ssd_fns"):
        fn = lib.ssd_scan_fwd_bf16
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        ws = lib.ssd_scan_workspace_bytes
        ws.argtypes = [ctypes.c_int] * 5
        ws.restype = ctypes.c_longlong
        keep = lib.ssd_scan_keep_bytes
        keep.argtypes = [ctypes.c_int] * 5
        keep.restype = ctypes.c_longlong
        lib._ssd_fns = (fn, ws, keep)
    return lib._ssd_fns


def _bind_bwd(lib):
    """(entry, workspace-size function) of the backward's library."""
    if not hasattr(lib, "_ssd_bwd_fns"):
        fn = lib.ssd_scan_bwd_bf16
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        ws = lib.ssd_scan_bwd_workspace_bytes
        ws.argtypes = [ctypes.c_int] * 7
        ws.restype = ctypes.c_longlong
        lib._ssd_bwd_fns = (fn, ws)
    return lib._ssd_bwd_fns


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


def _clip_chunk(s: int, chunk: int) -> int:
    """``chunk`` clipped to the sequence length ``s``; raises ValueError
    unless it divides ``s`` (the reference's rule)."""
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    return chunk


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
    if x.device.type == "cpu":
        chunk = _clip_chunk(x.shape[1], chunk)
        if x.dim() == 3:
            return ssd_ref(x, dt, a, bm, cm)
        y, state = ssd_ref(*to_pallas_layout(x, dt, a, bm, cm))
        return from_pallas_layout(y, state, x.shape[0])
    _build.refuse_grad("ssd_scan", (x, dt, a, bm, cm),
                       "call SSDScan.apply, which has a backward")
    return _scan(x, dt, a, bm, cm, chunk, keep=False)[:2]


def _forward(x, dt, a, bm, cm, chunk: int, keep: bool):
    """SSDScan's forward -> (y, final state, kept): on CUDA tensors the
    kernels, keeping the chunk states for the backward kernels when
    ``keep`` (``_scan``); on CPU tensors the plain version, whose backward
    recomputes everything (kept None)."""
    if x.device.type == "cpu":
        return (*ssd_scan(x, dt, a, bm, cm, chunk=chunk), None)
    return _scan(x, dt, a, bm, cm, chunk, keep)


def _scan(x, dt, a, bm, cm, chunk: int, keep: bool):
    """The forward kernels on CUDA tensors -> (y, final state, kept): with
    ``keep`` (model layout only) ``kept`` is the uint8 buffer that holds
    the chunks' (cum, dt) pairs and previous states for the backward
    kernels (``ssd_scan_keep_bytes``: ~54 MB at mamba2_780m's train
    shape), else None."""
    pallas_layout = x.dim() == 3
    if keep and pallas_layout:
        raise ValueError("the forward keeps its chunk states in the model "
                         "layout only")
    s = x.shape[1]
    chunk = _clip_chunk(s, chunk)
    p0 = x.shape[-1]
    pad = padded_head_dim(p0) - p0
    if pad:
        x = F.pad(x, (0, pad))
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
    fn, ws_bytes, keep_bytes = _bind(lib)
    # (cum, dt) pairs, chunk states and previous states: ~104 MB at
    # mamba2_780m's prefill, from PyTorch's caching allocator
    work = torch.empty(ws_bytes(b, s, h, n, chunk), dtype=torch.uint8,
                       device=x.device)
    kept = (torch.empty(keep_bytes(b, s, h, n, chunk), dtype=torch.uint8,
                        device=x.device) if keep else None)
    with _build.on_device(x):
        rc = fn(x4.data_ptr(), dt4.data_ptr(), a1.data_ptr(), b4.data_ptr(),
                c4.data_ptr(), y4.data_ptr(), state.data_ptr(),
                work.data_ptr(), None if kept is None else kept.data_ptr(),
                b, s, h, g, n, p, chunk, strides, _build.stream_ptr(x))
    _build.check(lib, "ssd_scan", rc)
    ssd_scan.launches += 1
    if pad:
        return y[..., :p0].contiguous(), state[..., :p0].contiguous(), kept
    return y, state, kept


ssd_scan.launches = 0
ssd_scan.bwd_launches = 0


BWD_BYTES = 1 << 30  # bound of one [rows, S/L, H, L, L] tensor of the backward


def ssd_scan_bwd(x, dt, a, bm, cm, dy, dstate, chunk: int):
    """Gradients (dx, ddt, dA, dB, dC) of the SSD scan in the model layout
    (x [B,S,H,P], dt [B,S,H], a [H], bm/cm [B,S,G,N]) for the output's
    gradient dy [B,S,H,P] and the final state's dstate [B,H,N,P] (None
    when the state is unused, as in training).

    Explicit torch: the chain rule of the chunked form
    (``models.ssm.ssd_chunked``), recomputed from the inputs in ``acc``
    (fp32; float64 for float64 inputs), as the reference's fp32 einsums.
    Per chunk of L steps, with cum = cumsum(dt A), e = exp(cum):
    y = [(C B^T) * exp(cum_i - cum_j) * dt_j]_(i>=j) x + e * (C S_prev),
    S_next = S_prev * exp(cum_L) + B^T (w * x), w = exp(cum_L - cum) dt.
    The backward runs y's inter-chunk term, the state recurrence in
    reverse (g, the gradient of the state after a chunk: dS_c = g,
    d exp(cum_L) = <g, S_prev>, g <- g exp(cum_L) + dS_prev), the chunk
    states, then the intra-chunk term, and the reverse cumsum of d cum,
    which is d(dt A). The decay is masked to -inf above the diagonal
    before its exp, so no inf meets a zero gradient (the reference's
    ``where(causal, exp(seg), 0)`` gives NaN there once a chunk's span of
    dt |A| passes ~88.7 in fp32). The intra-chunk term's gradients come
    from four [L, L] tensors: decay, SD = (C B^T) * decay, dM = dy x^T
    and dscores = dM * decay * dt_j; dM * SD, whose column sums are
    d dt_j and whose products with dt give d seg's row and column sums,
    reuses dM's memory. dx comes back in x.dtype, ddt [B,S,H] and dA [H]
    in ``acc``, dB and dC in B's dtype, summed over the H/G heads of each
    group. Batch rows go in groups whose [rows, S/L, H, L, L] tensors
    stay within ``BWD_BYTES`` (mamba2_780m's train batch of 4 is one
    group of 403 MB tensors in fp32)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    rep = h // g
    chunk = min(chunk, s)
    nc = s // chunk
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    A = a.to(acc)[:, None]                                # [H, 1]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ddt = torch.empty((b, s, h), dtype=acc, device=x.device)
    db = torch.empty(bm.shape, dtype=bm.dtype, device=x.device)
    dc = torch.empty(cm.shape, dtype=cm.dtype, device=x.device)
    da = torch.zeros((h,), dtype=acc, device=x.device)
    row_bytes = nc * h * chunk * chunk * (torch.finfo(acc).bits // 8)
    rows = max(1, BWD_BYTES // row_bytes)

    def chunked(t, k):  # [r, S, K, *] -> [r, nc, K, L, *] view
        return t.reshape(t.shape[0], nc, chunk, k, -1).transpose(2, 3)

    def heads(t):  # [r, S, H, P] -> [r, nc, H, L, P] in acc, contiguous
        return chunked(t, h).to(acc, memory_format=torch.contiguous_format)

    def groups(t):  # [r, S, G, N] -> [r, nc, H, L, N], group per head
        t = chunked(t, g).to(acc, memory_format=torch.contiguous_format)
        return t.repeat_interleave(rep, dim=2) if rep > 1 else t

    def group_sum(t):  # [r, nc, H, L, N] -> [r, nc, G, L, N]
        return t.reshape(t.shape[0], nc, g, rep, chunk, n).sum(3)

    for i0 in range(0, b, rows):
        rs = slice(i0, i0 + rows)
        xi, dyi = heads(x[rs]), heads(dy[rs])             # [r,nc,H,L,P]
        bi, ci = groups(bm[rs]), groups(cm[rs])           # [r,nc,H,L,N]
        dti = chunked(dt[rs], h)[..., 0].to(acc)          # [r,nc,H,L]
        cum = torch.cumsum(dti * A, dim=-1)
        cum_l = cum[..., -1:]
        w = torch.exp(cum_l - cum) * dti
        s_c = bi.transpose(-1, -2) @ (w[..., None] * xi)  # [r,nc,H,N,P]
        d_c = torch.exp(cum_l[..., 0])                    # [r,nc,H]
        prev = torch.empty_like(s_c)                      # state before c
        state = torch.zeros_like(s_c[:, 0])
        for c in range(nc):
            prev[:, c] = state
            state = torch.addcmul(s_c[:, c], state, d_c[:, c, :, None, None])
        del s_c, state

        # y_off = e * (C S_prev)
        e = torch.exp(cum)
        dcum = (dyi * (ci @ prev)).sum(-1).mul_(e)
        dye = dyi * e[..., None]
        dci = dye @ prev.transpose(-1, -2)
        dprev = ci.transpose(-1, -2) @ dye
        del e, dye
        # the state recurrence in reverse
        gst = (torch.zeros_like(prev[:, 0]) if dstate is None
               else dstate[rs].to(acc))
        ds = torch.empty_like(prev)
        dd = torch.empty_like(d_c)
        for c in reversed(range(nc)):
            ds[:, c] = gst
            dd[:, c] = (gst * prev[:, c]).sum((-1, -2))
            gst = torch.addcmul(dprev[:, c], gst, d_c[:, c, :, None, None])
        del prev, dprev, gst
        # S_c = B^T (w * x), w = exp(cum_L - cum) dt
        bds = bi @ ds                                     # [r,nc,H,L,P]
        dxi = w[..., None] * bds
        dbi = (xi @ ds.transpose(-1, -2)).mul_(w[..., None])
        dw = (bds * xi).sum(-1)
        del bds, ds
        ddti = dw * torch.exp(cum_l - cum)
        dw.mul_(w)
        dcum -= dw
        dcum[..., -1] += dw.sum(-1) + dd * d_c            # d cum_L
        del dw, w
        # y_diag = M x, M = (C B^T) * decay * dt_j
        decay = ((cum[..., :, None] - cum[..., None, :])
                 .masked_fill_(~causal, float("-inf")).exp_())
        sd = (ci @ bi.transpose(-1, -2)).mul_(decay)      # scores * decay
        dxi += dti[..., None] * (sd.transpose(-1, -2) @ dyi)  # M^T dy
        dscores = dyi @ xi.transpose(-1, -2)              # dM
        dsu = dscores * sd                                # dM * scores * decay
        del sd
        dscores.mul_(decay.mul_(dti[..., None, :]))       # dM * decay * dt_j
        del decay
        col = dsu.sum(-2)                                 # d dt_j
        ddti += col
        dcum += (dsu @ dti[..., None])[..., 0] - dti * col  # d seg's sums
        del dsu, col
        dci += dscores @ bi
        dbi += dscores.transpose(-1, -2) @ ci
        del dscores
        # cum = cumsum(dt A): d(dt A) is the reverse cumsum of d cum
        dda = dcum.flip(-1).cumsum(-1).flip(-1)
        ddti += dda * A
        da += (dda * dti).sum((0, 1, 3))

        chunked(dx[rs], h).copy_(dxi)
        chunked(ddt[rs], h)[..., 0].copy_(ddti)
        chunked(db[rs], g).copy_(group_sum(dbi))
        chunked(dc[rs], g).copy_(group_sum(dci))
    return dx, ddt, da, db, dc


def bwd_work(b: int, s: int, h: int, g: int, n: int, p: int, chunk: int):
    """(FLOPs, bytes) that the SSD scan's backward needs at least, which
    its bound divides by the card's rates. Per (batch, chunk) of L rows,
    over the lower triangle of the L x L scores (the causal mask zeroes the
    rest): C B^T and the intra-chunk dB and dC products once per group (dS
    is summed over a group's heads before them), dM = dy x^T and M^T dy once
    per head; per head the four L x N x P products of the state terms (y's
    gradient of the previous state C^T (e dy), dx's B g, dB's x g^T, dC's
    dy S_prev^T). The chunk states are not counted: the forward keeps them.
    Bytes: x, dy and dx in bf16, dt and ddt in fp32, A and dA, and B, C, dB
    and dC in bf16, each once."""
    flops = 0.0
    for start in range(0, s, chunk):
        rows = min(chunk, s - start)
        tri = rows * (rows + 1) / 2
        flops += 2.0 * b * (tri * (3 * g * n + 2 * h * p)
                            + 4 * h * rows * n * p)
    nbytes = (3 * 2 * b * s * h * p + 2 * 4 * b * s * h + 2 * 4 * h
              + 4 * 2 * b * s * g * n)
    return flops, nbytes


def ssd_scan_backward(x, dt, a, bm, cm, dy, dstate, chunk: int,
                      kept=None):
    """Gradients (dx, ddt, dA, dB, dC) of the SSD scan in the model layout
    for y's gradient ``dy`` and the final state's ``dstate`` (None when
    the state is unused, as in training): on CUDA tensors the backward
    kernels (``csrc/ssd_scan_bwd.cu``), which read the chunk states the
    forward kept (``kept``, from ``_scan(..., keep=True)``, as
    ``SSDScan.forward`` keeps them under grad; required there), on CPU
    tensors the plain ``ssd_scan_bwd``, which recomputes them. dx comes back in x's dtype, ddt and dA in fp32, dB
    and dC in B's dtype summed over each group's heads. Head dims below
    the kernel's 64 are zero-padded as the forward pads them (x, dy and
    dstate; dx sliced)."""
    if x.device.type == "cpu":
        return ssd_scan_bwd(x, dt, a, bm, cm, dy, dstate, chunk)
    b, s, h, p0 = x.shape
    chunk = _clip_chunk(s, chunk)
    if kept is None:
        raise ValueError("the backward kernels read the chunk states the "
                         "forward kept: pass _scan(..., keep=True)[2]")
    pad = padded_head_dim(p0) - p0
    if pad:
        x, dy = F.pad(x, (0, pad)), F.pad(dy, (0, pad))
        if dstate is not None:
            dstate = F.pad(dstate, (0, pad))
    dy = dy.contiguous()
    _check(x, dt, a, bm, cm)
    g, n = bm.shape[2], bm.shape[3]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if dstate is not None:
        dstate = dstate.to(torch.float32).contiguous()
        if dstate.shape != (b, h, n, HEAD_DIM) or dstate.device != x.device:
            raise ValueError(f"dstate {tuple(dstate.shape)} must be "
                             f"{(b, h, n, p0)}")
    keep_bytes = _bind(_build.load("ssd_scan"))[2](b, s, h, n, chunk)
    if (kept.dtype != torch.uint8 or kept.numel() != keep_bytes
            or kept.device != x.device or not kept.is_contiguous()):
        raise ValueError(f"kept must be the forward's {keep_bytes} bytes "
                         f"for these inputs, got {kept.numel()} "
                         f"{kept.dtype} on {kept.device}")
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ddt = torch.empty((b, s, h), dtype=torch.float32, device=x.device)
    da = torch.empty((h,), dtype=torch.float32, device=x.device)
    db = torch.empty(bm.shape, dtype=bm.dtype, device=x.device)
    dc = torch.empty(cm.shape, dtype=cm.dtype, device=x.device)
    strides = (ctypes.c_longlong * 22)(
        *x.stride()[:3], *dt.stride(), a.stride(0), *bm.stride()[:3],
        *cm.stride()[:3], *dy.stride()[:3], *dx.stride()[:3],
        *ddt.stride())
    lib = _build.load("ssd_scan_bwd")
    fn, ws_bytes = _bind_bwd(lib)
    sms = _build.sm_count(x.device.index)
    # y's gradient of each chunk's state and the gradient of the state
    # after it, the tile pairs' dS summed over head slices, the rows' sums
    # and dx's carry between query tiles: ~0.13 GB at mamba2_780m's train
    # shape
    work = torch.empty(ws_bytes(b, s, h, g, n, chunk, sms),
                       dtype=torch.uint8, device=x.device)
    with _build.on_device(x):
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                cm.data_ptr(), dy.data_ptr(),
                None if dstate is None else dstate.data_ptr(),
                kept.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                da.data_ptr(), db.data_ptr(), dc.data_ptr(),
                work.data_ptr(), b, s, h, g, n, HEAD_DIM, chunk, sms,
                strides, _build.stream_ptr(x))
    _build.check(lib, "ssd_scan_bwd", rc)
    ssd_scan.bwd_launches += 1
    return (dx[..., :p0].contiguous() if pad else dx), ddt, da, db, dc


class SSDScan(torch.autograd.Function):
    """``ssd_scan`` under autograd, in the model layout (x [B,S,H,P], dt
    [B,S,H], a [H], bm/cm [B,S,G,N]); returns (y, final state), as the op
    does.

    Forward is the op as it is: the hand-written kernels on CUDA tensors
    (so the kernel runs in every forward, including the recompute under
    remat), the plain version on CPU tensors; on the card, when an input
    needs a gradient, it also keeps the chunks' (cum, dt) pairs and
    previous states (``_scan(..., keep=True)``, ~54 MB at mamba2_780m's
    train shape), as FlashAttention keeps the LSE and FusedMLP g and u.
    Backward is ``ssd_scan_backward``: the hand-written backward kernels
    on CUDA tensors, from the saved inputs and those states; the plain
    ``ssd_scan_bwd`` on CPU tensors, recomputed from the saved inputs.
    The TPU kernel is forward-only and the reference's gradients come
    from XLA's autodiff of its chunked einsums outside any Pallas kernel;
    the backward kernels compute that gradient. An unused output's
    gradient arrives as None (the final state, in training)."""

    @staticmethod
    def forward(ctx, x, dt, a, bm, cm, chunk=128):
        if x.dim() != 4:
            raise ValueError(f"SSDScan takes the model layout x [B,S,H,P], "
                             f"got {tuple(x.shape)}")
        with span("kernel.ssd_scan.fwd"):
            y, state, kept = _forward(x, dt, a, bm, cm, chunk,
                                      keep=any(ctx.needs_input_grad[:5]))
        ctx.save_for_backward(x, dt, a, bm, cm, kept)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, bm, cm, kept = ctx.saved_tensors   # unpacked once (remat)
        with span("kernel.ssd_scan.bwd"):
            if dy is None:
                dy = torch.zeros_like(x)
            return (*ssd_scan_backward(x, dt, a, bm, cm, dy, dstate,
                                       ctx.chunk, kept), None)
