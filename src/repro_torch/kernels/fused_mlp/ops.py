"""Fused SwiGLU MLP op: the CUDA kernels ``csrc/fused_mlp.cu`` on CUDA
tensors, its plain version (``ref.fused_mlp_ref``) on CPU tensors.

Replaces ``repro/kernels/fused_mlp/fused_mlp.py:fused_mlp``.
``fused_mlp.launches`` counts calls that ran the forward kernels (one per
MLP; each is a gate/up and a down launch per row chunk);
``fused_mlp.bwd_launches`` counts calls of the backward kernels
(``csrc/fused_mlp_bwd.cu``, four launches a call).

The backward's four launches split their work as ``bwd_plan`` chooses
from M, K, F and the SM count: whole output tiles a block, or, where the
last wave of tiles would run nearly empty (llava_next_34b's M = 640),
whole tiles for the full waves and stream-K ranges over the rest, whose
partial tiles are summed in a fixed order.

``FusedMLP`` puts the op under autograd: its forward is the op (the
kernels on the card, in every forward, the recompute under remat
included; under grad they also keep g = x W1 and u = x W3 in bf16), its
backward is ``fused_mlp_backward``: the backward kernels on CUDA
tensors, the explicit torch ``fused_mlp_bwd`` on CPU tensors. The raw op
refuses to launch when autograd would record it (``_build.refuse_grad``).
``FusedMLP``'s forward and backward run in the spans
``kernel.fused_mlp.fwd`` and ``kernel.fused_mlp.bwd`` (``launch.spans``).

K and F that are multiples of 64 but not of the kernels' 128-wide tiles
(the smoke configs' K = 64) are zero-padded inside the op
(``padded_dims``): zero columns of x and W1/W3 rows and W2 columns for
K, zero W1/W3 columns and W2 rows for F. silu(0) * 0 = 0, so h gains
exact zeros and y's real columns do not change; the padded columns are
sliced off. The full configs' K and F are multiples of 128, so their
path never pads.

Two regimes, chosen by M here: ``decode`` (M <= 64) runs the swap-AB
cluster kernels, whose reduction is split over ``decode_split`` blocks;
``prefill`` runs the persistent wgmma kernels over ``row_chunks``, which
bound the bf16 h scratch. A forward that keeps g and u runs the prefill
kernels at every M (only their epilogue stores them).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...launch.spans import span
from .. import _build
from .ref import fused_mlp_ref

TILE = 128          # K and F the kernels take are multiples of their tiles
PAD_UNIT = 64       # K and F the op takes (padded to TILE) are multiples
DECODE_MAX_M = 64   # M at or below which the decode kernels run
SPLITS = (1, 2, 4, 8)  # cluster sizes of the decode kernels


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def padded_dims(k: int, f: int):
    """(K, F) the kernels run for the real ``k`` and ``f``: each rounded
    up to a multiple of ``TILE``. Raises ValueError unless both are
    positive multiples of ``PAD_UNIT``."""
    if k % PAD_UNIT or f % PAD_UNIT or k < 1 or f < 1:
        raise ValueError(f"K={k} and F={f} must be multiples of {PAD_UNIT}")
    return _cdiv(k, TILE) * TILE, _cdiv(f, TILE) * TILE


def regime(m: int) -> str:
    """``"decode"`` for M <= 64 (the weight stream bounds it), else
    ``"prefill"`` (the tensor cores bound it)."""
    return "decode" if m <= DECODE_MAX_M else "prefill"


def row_chunks(m: int, k: int, f: int):
    """[(start, rows)] row chunks of x for the prefill kernels. The bf16 h
    of one chunk ([rows, F]) takes no more bytes than the fp32 [M, K]
    workspace of the earlier design (M*K*4), but a chunk is never smaller
    than one 128-row tile; chunks are equal in whole tiles, so the last is
    no sliver. Decode is one chunk: its h is at most [64, F]."""
    if regime(m) == "decode":
        return [(0, m)]
    cap = max(TILE, (2 * m * k // f) // TILE * TILE)
    n = _cdiv(m, cap)
    while _cdiv(_cdiv(m, n), TILE) * TILE > cap:
        n += 1
    rows = _cdiv(_cdiv(m, n), TILE) * TILE
    return [(s, min(rows, m - s)) for s in range(0, m, rows)]


def decode_split(outputs: int, reduction: int, sms: int) -> int:
    """Cluster size of a decode kernel with ``outputs`` output rows (64
    per block group) and a ``reduction``-long sum: the smallest size in
    ``SPLITS`` that gives at least one block per SM, no larger than the
    reduction's 64-wide blocks. Each block keeps ~100 KB of loads in
    flight, so one block per SM streams the weights; more blocks only
    add cluster reductions."""
    tiles, kblocks = outputs // 64, reduction // 64
    best = 1
    for cs in SPLITS:
        if cs > kblocks:
            break
        best = cs
        if tiles * cs >= sms:
            break
    return best


@functools.lru_cache(maxsize=256)
def _plan(m: int, k: int, f: int, sms: int, keep: bool = False):
    """(row chunks, rows of h, decode flag, split_up, split_down) for one
    shape: computed once, since decode calls this 36 times a step. With
    ``keep`` (g and u stored for the backward) the prefill kernels run at
    every M, a decode-sized M as one chunk."""
    chunks = tuple(row_chunks(m, k, f))
    decode = regime(m) == "decode" and not keep
    return (chunks, max(r for _, r in chunks), int(decode),
            decode_split(f, k, sms) if decode else 1,
            decode_split(k, f, sms) if decode else 1)


WAVE_FILL = 0.85   # whole tiles unless their last wave is emptier
SK_MIN = 8         # least k-blocks of a stream-K range (csrc: SK_MIN)


class BwdLaunch(NamedTuple):
    """One launch of the backward kernels: its output ``tiles`` (128 rows
    by ``width`` columns), the 64-deep ``kblocks`` of its reduction,
    whether it runs ``stream_k`` (module docstring) and the ``fill`` that
    split gives its last wave (work units over waves x SMs)."""
    name: str
    tiles: int
    kblocks: int
    stream_k: bool
    fill: float


def _fill(tiles: int, kblocks: int, sms: int, stream_k: bool) -> float:
    """Work over (SMs x the busiest block's work): whole tiles, or the
    full waves of whole tiles and the leftover k-blocks in equal ranges
    of at least ``SK_MIN`` (the grid is at most ``tiles x kblocks``)."""
    if not stream_k:
        return tiles / (_cdiv(tiles, sms) * sms)
    grid = min(sms, tiles * kblocks)
    whole = tiles // grid * grid
    left = (tiles - whole) * kblocks
    ranges = max(1, min(grid, left // SK_MIN))
    busiest = whole // grid * kblocks + _cdiv(left, ranges)
    return tiles * kblocks / (busiest * sms)


@functools.lru_cache(maxsize=256)
def bwd_plan(m: int, k: int, f: int, sms: int):
    """The work split of the backward kernels' four launches (dh, dW2, dx,
    dW1/dW3, in the C entry's order) at M and the kernels' K and F on
    ``sms`` SMs. A launch gives each block whole tiles unless their last
    wave would be less than ``WAVE_FILL`` full; then it runs stream-K for
    that wave: the full waves of whole tiles, then the k-blocks of the
    tiles left over cut into equal ranges a block, whose partial tiles
    are summed in a fixed order (``csrc/fused_mlp_bwd.cu``), if that fills
    the waves better. At
    llava_next_34b's train step (M = 640, K = 7168, F = 20480) dx's 140
    and dh's 400 tiles would leave 6% and 3% of their last wave's SMs
    busy, so both split; at olmo_1b's M = 8192 every launch keeps whole
    tiles."""
    shapes = (("dh", m, f, 2 * TILE, k // 64),
              ("dw2", f, k, 2 * TILE, _cdiv(m, 64)),
              ("dx", m, k, 2 * TILE, 2 * f // 64),
              ("dw13", k, f, TILE, _cdiv(m, 64)))
    plan = []
    for name, rows, cols, width, kblocks in shapes:
        tiles = _cdiv(rows, TILE) * _cdiv(cols, width)
        whole = _fill(tiles, kblocks, sms, False)
        split = _fill(tiles, kblocks, sms, True)
        stream_k = whole < WAVE_FILL and split > whole
        plan.append(BwdLaunch(name, tiles, kblocks, stream_k,
                              split if stream_k else whole))
    return tuple(plan)


def split_mask(plan) -> int:
    """``bwd_plan``'s choice as the C entry's bit mask (bit i: launch i
    runs stream-K)."""
    return sum(1 << i for i, launch in enumerate(plan) if launch.stream_k)


@functools.lru_cache(maxsize=None)
def _bound():
    fn = _build.load("fused_mlp").fused_mlp_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bound_bwd():
    """(entry, partial-size function) of the backward's library."""
    lib = _build.load("fused_mlp_bwd")
    fn = lib.fused_mlp_bwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    floats = lib.fused_mlp_bwd_partial_floats
    floats.argtypes = [ctypes.c_int]
    floats.restype = ctypes.c_longlong
    return fn, floats


def _check(x, w1, w3, w2):
    """Raise ValueError unless the op takes these operands; returns the
    (K, F) the kernels run (``padded_dims``)."""
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
    for t in (x, w1, w3, w2):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_mlp needs contiguous, 16-byte aligned "
                             "operands")
    return padded_dims(k, f)


def _pad(x, w1, w3, w2, kp: int, fp: int):
    """The operands zero-padded to the kernels' (K, F) = (kp, fp)
    (module docstring); unchanged where they already are."""
    k0, f0 = x.shape[1], w1.shape[1]
    if (kp, fp) == (k0, f0):
        return x, w1, w3, w2
    return (F.pad(x, (0, kp - k0)),
            *(F.pad(w, (0, fp - f0, 0, kp - k0)) for w in (w1, w3)),
            F.pad(w2, (0, kp - k0, 0, fp - f0)))


def fused_mlp(x, w1, w3, w2):
    """x [M, K]; w1/w3 [K, F]; w2 [F, K] -> [M, K]:
    silu(x W1) * (x W3) formed in fp32, rounded to x.dtype, times W2."""
    if x.dim() != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_mlp_ref(x, w1, w3, w2)
    _build.refuse_grad("fused_mlp", (x, w1, w3, w2),
                       "call FusedMLP.apply, which has a backward")
    return _forward(x, w1, w3, w2, keep=False)[0]


def _forward(x, w1, w3, w2, keep: bool):
    """The forward kernels on CUDA tensors -> (y, g, u): with ``keep``, g =
    x W1 and u = x W3 in bf16 at the padded [M, F] (the backward's
    inputs), else None, None."""
    kp, fp = _check(x, w1, w3, w2)
    k0 = x.shape[1]
    x, w1, w3, w2 = _pad(x, w1, w3, w2, kp, fp)
    m, k = x.shape
    f = w1.shape[1]
    sms = _build.sm_count(x.device.index)
    chunks, h_rows, decode, split_up, split_down = _plan(m, k, f, sms, keep)
    y = torch.empty_like(x)
    h = torch.empty((h_rows, f), dtype=x.dtype, device=x.device)
    g, u = ((torch.empty((m, f), dtype=x.dtype, device=x.device)
             for _ in range(2)) if keep else (None, None))
    fn = _bound()
    row_bytes = k * x.element_size()
    gu_bytes = f * x.element_size()
    with _build.on_device(x):
        stream = _build.stream_ptr(x)
        for start, rows in chunks:
            rc = fn(x.data_ptr() + start * row_bytes, w1.data_ptr(),
                    w3.data_ptr(), w2.data_ptr(), h.data_ptr(),
                    y.data_ptr() + start * row_bytes,
                    *((t.data_ptr() + start * gu_bytes for t in (g, u))
                      if keep else (None, None)),
                    rows, k, f, decode, split_up, split_down, sms, stream)
            if rc:
                _build.check(_build.load("fused_mlp"), "fused_mlp", rc)
    fused_mlp.launches += 1
    return (y[:, :k0].contiguous() if k != k0 else y), g, u


def fused_mlp_backward(x, w1, w3, w2, dy, g=None, u=None):
    """Gradients (dx, dW1, dW3, dW2) of ``fused_mlp`` for its output's
    gradient ``dy``: on CUDA tensors the backward kernels
    (``csrc/fused_mlp_bwd.cu``, four launches), which read g = x W1 and
    u = x W3 as the forward kept them (``_forward(..., keep=True)``: bf16,
    at the padded [M, F]); on CPU tensors the plain ``fused_mlp_bwd``
    (which recomputes g and u when they are None). K and F the kernels do
    not take natively are zero-padded as the forward pads them (dy too),
    and the gradients sliced."""
    if x.device.type == "cpu":
        return fused_mlp_bwd(x, w1, w3, w2, dy, g, u)
    kp, fp = _check(x, w1, w3, w2)
    m, k0 = x.shape
    f0 = w1.shape[1]
    dy = dy.contiguous()
    for name, t, shape in (("dy", dy, (m, k0)), ("g", g, (m, fp)),
                           ("u", u, (m, fp))):
        if t is None:
            raise ValueError(f"the backward kernels need the forward's {name}")
        _build.require_cuda(x, t)
        if (t.dtype != x.dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{x.dtype} {shape}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    x, w1, w3, w2 = _pad(x, w1, w3, w2, kp, fp)
    if kp != k0:
        dy = F.pad(dy, (0, kp - k0))
    h, dg, du = (torch.empty((m, fp), dtype=x.dtype, device=x.device)
                 for _ in range(3))
    dx = torch.empty_like(x)
    dw1, dw3 = (torch.empty_like(w1) for _ in range(2))
    dw2 = torch.empty_like(w2)
    sms = _build.sm_count(x.device.index)
    split = split_mask(bwd_plan(m, kp, fp, sms))
    fn, floats = _bound_bwd()
    # a stream-K launch's partial tiles (128 KB a range), the ranges'
    # ready flags and the ticket counter that hands the ranges out
    part, flags = ((torch.empty(floats(sms), dtype=torch.float32,
                                device=x.device),
                    torch.empty(sms + 1, dtype=torch.int32, device=x.device))
                   if split else (None, None))
    with _build.on_device(x):
        rc = fn(*(t.data_ptr() for t in (
            x, w1, w3, w2, dy, g, u, h, dg, du, dx, dw1, dw3, dw2)),
            *((t.data_ptr() for t in (part, flags)) if split
              else (None, None)),
            m, kp, fp, split, sms, _build.stream_ptr(x))
    _build.check(_build.load("fused_mlp_bwd"), "fused_mlp_bwd", rc)
    fused_mlp.bwd_launches += 1
    if (kp, fp) == (k0, f0):
        return dx, dw1, dw3, dw2
    return (dx[:, :k0].contiguous(), dw1[:k0, :f0].contiguous(),
            dw3[:k0, :f0].contiguous(), dw2[:f0, :k0].contiguous())


fused_mlp.launches = 0
fused_mlp.bwd_launches = 0


def fused_mlp_bwd(x, w1, w3, w2, dy, g=None, u=None):
    """Gradients (dx, dW1, dW3, dW2) of the fused MLP in explicit torch:
    g = xW1, u = xW3 (the given ones, as the forward kept them, else
    recomputed), h = silu(g)*u; dW2 = h^T dy; dh = dy W2^T;
    dg = dh*u*silu'(g); du = dh*silu(g); dx = dg W1^T + du W3^T;
    dW1 = x^T dg; dW3 = x^T du. Products run in x.dtype with fp32
    accumulation (cuBLAS on the card, as the reference's XLA backward
    does in bf16), the elementwise part in fp32 (float64 for float64
    inputs); g and u are x.dtype products, and h, dg and du are rounded
    to x.dtype before their products, as h is in the forward."""
    acc = torch.promote_types(x.dtype, torch.float32)
    g = (x @ w1 if g is None else g).to(acc)
    u = (x @ w3 if u is None else u).to(acc)
    sig = torch.sigmoid(g)
    sg = g * sig                                   # silu(g)
    dw2 = (sg * u).to(x.dtype).T @ dy
    dh = (dy @ w2.T).to(acc)
    dg = (dh * u * sig * (1 + g * (1 - sig))).to(x.dtype)
    du = (dh * sg).to(x.dtype)
    del g, u, sig, sg, dh
    dx = torch.addmm(dg @ w1.T, du, w3.T)
    return dx, x.T @ dg, x.T @ du, dw2


class FusedMLP(torch.autograd.Function):
    """``fused_mlp`` under autograd: x [M, K]; w1/w3 [K, F]; w2 [F, K].

    Forward is the op as it is: the hand-written kernels on CUDA tensors
    (so the kernel runs in every forward, including the recompute under
    remat), the plain version on CPU tensors; on the card, when an input
    needs a gradient, it also keeps g = x W1 and u = x W3 in bf16.
    Backward is ``fused_mlp_backward``: the hand-written backward kernels
    (``csrc/fused_mlp_bwd.cu``) on CUDA tensors, from the saved g and u;
    the explicit torch ``fused_mlp_bwd`` on CPU tensors, recomputed from
    the saved inputs. The TPU kernel is forward-only and the reference's
    gradients come from XLA's autodiff of einsums outside any Pallas
    kernel; the backward kernels compute that gradient."""

    @staticmethod
    def forward(ctx, x, w1, w3, w2):
        with span("kernel.fused_mlp.fwd"):
            if x.device.type == "cpu":
                y, g, u = fused_mlp(x, w1, w3, w2), None, None
            else:
                y, g, u = _forward(x, w1, w3, w2,
                                   keep=any(ctx.needs_input_grad))
        ctx.save_for_backward(x, w1, w3, w2, g, u)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w1, w3, w2, g, u = ctx.saved_tensors   # unpacked once (remat)
        with span("kernel.fused_mlp.bwd"):
            return fused_mlp_backward(x, w1, w3, w2, dy, g, u)
