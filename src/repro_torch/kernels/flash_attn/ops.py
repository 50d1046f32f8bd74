"""Flash attention op: the CUDA kernel ``csrc/flash_attn.cu`` on CUDA
tensors, its plain version (``ref.attention_ref``) on CPU tensors; and
its backward: the CUDA kernels ``csrc/flash_attn_bwd.cu`` on CUDA
tensors, the plain ``attention_bwd`` on CPU tensors.

Replaces ``repro/kernels/flash_attn/flash_attn.py:flash_attention``.
``flash_attention.launches`` counts forward kernel launches, and
``flash_attention.launches_by_regime`` splits the same launches by
``regime``: causal, non-causal with Sq == Skv (an encoder's
self-attention), non-causal with Sq != Skv (cross-attention).
``flash_attention.bwd_launches`` counts calls of the backward op
(``flash_attention_backward``) that launched its kernels.

Head dims the kernel does not take natively (any multiple of 8 up to 128,
e.g. the smoke configs' 16) are zero-padded inside the op to the next
size in ``HEAD_DIMS`` (``padded_head_dim``), with the softmax scale of
the real head dim; the padded lanes add exact zeros to q k^T and give
zero output columns, which are sliced off. The full configs' head dims
are native, so their path never pads.

``FlashAttention`` puts the op under autograd: its forward is the op
(the kernel on the card, in every forward, the recompute under remat
included; under grad it also keeps each row's log-sum-exp), its
backward is ``flash_attention_backward`` (the backward kernels on the card).
The raw op refuses to launch when autograd would record it
(``_build.refuse_grad``). ``FlashAttention``'s forward and backward run
in the spans ``kernel.flash_attn.fwd`` and ``kernel.flash_attn.bwd``
(``launch.spans``).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...launch.spans import span
from .. import _build
from .ref import attention_ref

HEAD_DIMS = (64, 80, 96, 128)


def softmax_scale(hd: int, scale=None) -> float:
    """The softmax scale of a call: ``scale``, or 1/sqrt(hd) of the real
    head dim."""
    return 1.0 / (hd ** 0.5) if scale is None else float(scale)


def padded_head_dim(hd: int) -> int:
    """The head dim the kernel runs for a real head dim ``hd``: ``hd``
    itself when native, else the smallest of ``HEAD_DIMS`` above it.
    Raises ValueError unless ``hd`` is a multiple of 8 up to 128."""
    if hd % 8 or not 0 < hd <= HEAD_DIMS[-1]:
        raise ValueError(f"head dim {hd} not a multiple of 8 in "
                         f"[8, {HEAD_DIMS[-1]}]")
    return next(d for d in HEAD_DIMS if d >= hd)


def _bind(lib):
    fn = lib.flash_attn_fwd_bf16
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong),
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _bind_bwd(lib):
    """(entry, workspace-size function) of the backward's library, typed
    once."""
    if not hasattr(lib, "_flash_bwd_fns"):
        fn = lib.flash_attn_bwd_bf16
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong),
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        ws = lib.flash_attn_bwd_workspace_bytes
        ws.argtypes = [ctypes.c_int] * 7
        ws.restype = ctypes.c_longlong
        lib._flash_bwd_fns = (fn, ws)
    return lib._flash_bwd_fns


def _to_bshd(t):
    """[BH, S, hd] (Pallas layout) as a [1, S, BH, hd] view, no copy."""
    return t.permute(1, 0, 2).unsqueeze(0)


def admit(q, k, v):
    """Raise ValueError unless the kernel takes these model-layout
    [B, S, H, hd] tensors: bfloat16, matching shapes, whole GQA groups, a
    head dim in HEAD_DIMS, and what its TMA descriptors need: a unit
    stride on hd, other strides multiples of 8 elements (16 bytes) and
    16-byte aligned data."""
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


def _check(q, k, v):
    _build.require_cuda(q, k, v)
    admit(q, k, v)


REGIMES = ("causal", "non-causal Sq=Skv", "non-causal Sq!=Skv")


def regime(causal: bool, sq: int, skv: int) -> str:
    """The key of ``flash_attention.launches_by_regime`` for a call."""
    if causal:
        return REGIMES[0]
    return REGIMES[1] if sq == skv else REGIMES[2]


def flash_attention(q, k, v, causal: bool = True, scale=None):
    """softmax(q k^T * scale) v with native GQA, ``scale`` by default
    1/sqrt(hd); causal queries are end-aligned (they sit at the last Sq of
    the Skv keys).

    Pallas layout: q [BH, Sq, hd], k/v [BKV, Skv, hd] -> [BH, Sq, hd].
    Model layout: q [B, Sq, H, hd], k/v [B, Skv, KV, hd] -> [B, Sq, H, hd].
    """
    return _attend(q, k, v, causal, with_lse=False, scale=scale)[0]


def _attend(q, k, v, causal: bool, with_lse: bool, scale=None):
    """``flash_attention``'s (out, lse): the plain version on CPU tensors
    (lse None), else the forward kernel, and with ``with_lse`` each row's
    fp32 log-sum-exp of the scaled, masked scores in log2 units, [B, H,
    Sq] (Pallas layout: [1, BH, Sq]), which the backward kernels read."""
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError("q, k, v must all be 3-D or all 4-D")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal, scale), None
    _build.refuse_grad("flash_attention", (q, k, v),
                       "call FlashAttention.apply, which has a backward")
    hd = q.shape[-1]
    pad = padded_head_dim(hd) - hd
    if pad:
        q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
    pallas_layout = q.dim() == 3
    if pallas_layout:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        q4, k4, v4, o4 = (_to_bshd(t) for t in (q, k, v, out))
    else:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        q4, k4, v4, o4 = q, k, v, out
    _check(q4, k4, v4)
    b, sq, h, hdp = q4.shape
    skv, kv = k4.shape[1], k4.shape[2]
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q4, k4, v4, o4) for s in t.stride()[:3]))
    lib = _build.load("flash_attn")
    with _build.on_device(q):
        rc = _bind(lib)(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                        o4.data_ptr(), None if lse is None else lse.data_ptr(),
                        b, h, kv, sq, skv, hdp, int(causal),
                        softmax_scale(hd, scale), strides,
                        _build.stream_ptr(q))
    _build.check(lib, "flash_attn", rc)
    flash_attention.launches += 1
    flash_attention.launches_by_regime[regime(causal, sq, skv)] += 1
    return (out[..., :hd].contiguous() if pad else out), lse


def flash_attention_backward(q, k, v, o, lse, do, causal: bool = True,
                             scale=None):
    """Gradients (dq, dk, dv) of ``flash_attention`` for its output's
    gradient ``do``, in either layout of the op: on CUDA tensors the
    backward kernels (``csrc/flash_attn_bwd.cu``: D = rowsum(do o o),
    then one kernel for the five products, P recomputed from ``lse``, the
    forward's log-sum-exp from ``_attend(..., with_lse=True)``, dq summed
    over key tiles in a fixed order in an fp32 scratch, then dq from it;
    three launches); on CPU tensors the plain
    ``attention_bwd``, which recomputes everything from q, k, v and reads
    neither ``o`` nor ``lse``. Head dims the kernels do not take natively
    are zero-padded as the forward pads them (o and do too), with the
    scale of the real head dim, and the gradients sliced. ``scale`` is the
    forward's softmax scale (None: 1/sqrt(hd)). A causal call needs
    Sq <= Skv on the card (every causal call the models make)."""
    if q.device.type == "cpu":
        if q.dim() == 3:  # Pallas layout as [1, S, BH, hd] views
            grads = attention_bwd(*(_to_bshd(t) for t in (q, k, v, do)),
                                  causal, scale)
            return tuple(t[0].permute(1, 0, 2) for t in grads)
        return attention_bwd(q, k, v, do, causal, scale)
    hd = q.shape[-1]
    pad = padded_head_dim(hd) - hd
    if pad:
        q, k, v, o, do = (F.pad(t, (0, pad)) for t in (q, k, v, o, do))
    o, do = o.contiguous(), do.contiguous()
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    ts = (q, k, v, o, do, dq, dk, dv)
    if q.dim() == 3:
        ts = tuple(_to_bshd(t) for t in ts)
    q4, k4, v4, o4, do4 = ts[:5]
    _check(q4, k4, v4)
    _build.require_cuda(q4, o4, do4, lse)
    b, sq, h, hdp = q4.shape
    skv, kv = k4.shape[1], k4.shape[2]
    if o4.shape != q4.shape or do4.shape != q4.shape or o4.dtype != q.dtype \
            or do4.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if (lse.dtype != torch.float32 or lse.shape != (b, h, sq)
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 {(b, h, sq)}, "
                         f"got {tuple(lse.shape)} {lse.dtype}")
    if causal and sq > skv:
        raise ValueError(f"the causal backward kernel needs Sq <= Skv, got "
                         f"Sq={sq} Skv={skv}")
    strides = (ctypes.c_longlong * 24)(
        *(s for t in ts for s in t.stride()[:3]))
    lib = _build.load("flash_attn_bwd")
    fn, ws = _bind_bwd(lib)
    sms = _build.sm_count(q.device.index)
    # dq_acc (the fp32 dQ sums), the padded lse and D, the semaphores and,
    # for GQA with few work items, per-head dK and dV
    work = torch.empty(ws(b, h, kv, sq, skv, hdp, sms), dtype=torch.uint8,
                       device=q.device)
    with _build.on_device(q):
        rc = fn(*(t.data_ptr() for t in (q4, k4, v4, o4, do4)),
                lse.data_ptr(), *(t.data_ptr() for t in ts[5:]),
                work.data_ptr(), b, h, kv, sq, skv, hdp, int(causal),
                softmax_scale(hd, scale), strides, sms, _build.stream_ptr(q))
    _build.check(lib, "flash_attn_bwd", rc)
    flash_attention.bwd_launches += 1
    if pad:
        return tuple(t[..., :hd].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


flash_attention.launches = 0
flash_attention.launches_by_regime = dict.fromkeys(REGIMES, 0)
flash_attention.bwd_launches = 0


def _bmm_acc(a, b, acc):
    """Batched a @ b on a's dtype with the result in ``acc`` (fp32 or
    float64): on the card, bf16/fp16 operands on the tensor cores with
    fp32 accumulation and an fp32 result (cuBLAS, ``out_dtype``); on the
    CPU, which has no ``out_dtype`` kernel, the operands widened first,
    the same exact products summed in ``acc``."""
    if a.is_cuda and a.dtype != acc:
        return torch.bmm(a, b, out_dtype=acc)
    return torch.bmm(a.to(acc), b.to(acc))


def attention_bwd(q, k, v, do, causal: bool = True, scale=None):
    """Gradients (dq, dk, dv) of ``attention_ref`` (at softmax scale
    ``scale``, None: 1/sqrt(hd)) for model-layout
    q [B, Sq, H, hd], k/v [B, Skv, KV, hd] and the output's gradient do,
    in explicit torch, with native GQA (head h reads KV head h // (H/KV);
    dk and dv sum over the group) and the causal mask end-aligned as in
    the forward.

    The five products (S = QK^T, dV = P^T dO, dP = dO V^T, dQ = dS K,
    dK = dS^T Q) take operands in q.dtype and accumulate in fp32 (float64
    for float64 inputs), as the reference's bf16 einsums do; the softmax,
    its row sums D = rowsum(dO * O) and dS = P (dP - D) stay fp32. P and
    dS are rounded to q.dtype before their products, as the forward
    kernel rounds P; O is recomputed as P V from that rounded P. One batch
    row at a time, so the materialised [KV, G*Sq, Skv] scores and their
    gradients stay one row in size (268 MB each in fp32 at olmo_1b's
    train shape S=2048, 16 heads)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = softmax_scale(hd, scale)
    mask = (torch.ones((sq, skv), dtype=torch.bool, device=q.device)
            .tril(diagonal=skv - sq) if causal else None)
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
                  for t in (q, k, v))

    def heads(t):  # [Sq, H, hd] -> [KV, G*Sq, hd]
        return (t.reshape(sq, kv, g, hd).permute(1, 2, 0, 3)
                .reshape(kv, g * sq, hd))

    for i in range(b):
        qi, doi = heads(q[i]), heads(do[i])
        ki, vi = k[i].transpose(0, 1), v[i].transpose(0, 1)  # [KV, Skv, hd]
        s = _bmm_acc(qi, ki.transpose(1, 2), acc).mul_(scale)
        if causal:
            s.view(kv, g, sq, skv).masked_fill_(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        del s
        p_lo = p.to(q.dtype)
        dv[i] = _bmm_acc(p_lo.transpose(1, 2), doi, acc).transpose(0, 1)
        d = (_bmm_acc(p_lo, vi, acc) * doi).sum(dim=-1, keepdim=True)
        del p_lo
        ds = _bmm_acc(doi, vi.transpose(1, 2), acc).sub_(d).mul_(p)
        del p
        ds = ds.to(q.dtype)
        dqi = _bmm_acc(ds, ki, acc).mul_(scale)
        dq[i] = (dqi.reshape(kv, g, sq, hd).permute(2, 0, 1, 3)
                 .reshape(sq, h, hd))
        dk[i] = _bmm_acc(ds.transpose(1, 2), qi, acc).mul_(scale
                                                            ).transpose(0, 1)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` under autograd, in either layout of the op.

    Forward is the op as it is: the hand-written kernel on CUDA tensors
    (so the kernel runs in every forward, including the recompute under
    remat), the plain version on CPU tensors; on the card it also writes
    each row's log-sum-exp when an input needs a gradient. Backward is
    ``flash_attention_backward``: the hand-written backward kernels on CUDA
    tensors, recomputing P from the saved log-sum-exp; the plain
    ``attention_bwd`` on CPU tensors. The TPU kernel is forward-only and
    the reference's gradients come from XLA's autodiff of einsums
    outside any Pallas kernel; the backward kernels compute that
    gradient. It saves q, k, v, the output and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, scale=None):
        with span("kernel.flash_attn.fwd"):
            out, lse = _attend(q, k, v, causal,
                               with_lse=any(ctx.needs_input_grad[:3]),
                               scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        with span("kernel.flash_attn.bwd"):
            return (*flash_attention_backward(q, k, v, o, lse, do,
                                              ctx.causal, ctx.scale),
                    None, None)
