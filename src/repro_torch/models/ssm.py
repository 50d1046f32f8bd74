"""Mamba-2 (SSD -- state-space duality, arXiv:2405.21060) block.

PyTorch counterpart of ``repro.models.ssm``. Prefill and training run
the chunked SSD scan: on CUDA tensors the hand-written kernel through
its autograd Function (``kernels.ssd_scan.SSDScan``: the kernel forward,
the backward kernels), on CPU tensors ``ssd_chunked`` below, the
reference's chunked dual form (intra-chunk quadratic term plus the
inter-chunk state recurrence) under plain autograd. Both return the
final state, so prefill fills the decode cache from the same scan that
gives its output.

The chain around the scan (conv, SiLU, softplus before it; D skip, gate
and gated RMSNorm after it) runs as two forward-only kernels
(``kernels.ssm_chain``) on plain CUDA tensors when no gradient is
recorded, i.e. in every serving prefill, and as the torch chain
(``ssm_chain.ref``) everywhere else: under autograd (training and its
remat recompute), on DTensors (the norm would need the heads' shards)
and on the CPU.

Decode is the O(1)-per-token recurrence on the [H, N, P] state, in torch
(no Pallas kernel stands behind it). Like the KV cache, the SSM cache is
updated in place: prefill and decode write the state and the conv
buffers into the cache tensors they are given, and return them.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from ..kernels import ssd_scan as ssd_kernel
from ..kernels import ssm_chain
from . import parallel
from .common import ModelConfig, dense_init, rmsnorm


def init_mamba2(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.float32) -> Dict:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    gn = cfg.ssm_groups * cfg.ssm_state
    kw = cfg.ssm_conv
    dev = gen.device

    def conv(width):
        w = torch.randn((kw, width), generator=gen, dtype=torch.float32,
                        device=dev)
        return (w * (1.0 / kw)).to(dtype)

    def fp32(fill, width):
        return torch.full((width,), fill, dtype=torch.float32, device=dev)

    return {
        "wz": dense_init(gen, d, di, dtype),
        "wx": dense_init(gen, d, di, dtype),
        "wB": dense_init(gen, d, gn, dtype),
        "wC": dense_init(gen, d, gn, dtype),
        "wdt": dense_init(gen, d, h, dtype),
        "dt_bias": fp32(0.0, h),
        "conv_x": conv(di),
        "conv_B": conv(gn),
        "conv_C": conv(gn),
        "A_log": fp32(0.0, h),        # A = -exp(A_log) = -1
        "D": fp32(1.0, h),
        "gn_scale": fp32(1.0, di),
        "wo": dense_init(gen, di, d, dtype),
    }


def _causal_decay(seg, causal):
    """exp(seg) where ``causal``, else 0, with seg masked to -inf before
    the exp. The reference's ``where(causal, exp(seg), 0)``
    (repro/models/ssm.py:80) gives the same values, but above the
    diagonal seg = cum_i - cum_j > 0 overflows to inf once a chunk's span
    of dt |A| passes ~88.7 in fp32, and its gradient, 0 * inf, is NaN."""
    return torch.exp(seg.masked_fill(~causal, float("-inf")))


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD scan. x [B,S,H,P]; dt [B,S,H] (>0); A [H] (<0);
    B,C [B,S,G,N]. Returns (y [B,S,H,P], final state [B,H,N,P]), summed
    in fp32 (float64 for float64 inputs)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"SSD chunk {chunk}")
    nc = s // chunk

    xc = x.reshape(b, nc, chunk, h, p).to(acc)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3).to(acc)
    Cc = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3).to(acc)

    dA = dtc * A                                      # [b,nc,L,h] (<0)
    cum = torch.cumsum(dA, dim=2)                     # inclusive cumsum
    # intra-chunk: M[i,j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j, i>=j
    scores = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    cum_h = cum.permute(0, 1, 3, 2)                   # [b,nc,h,L]
    seg = cum_h[..., :, None] - cum_h[..., None, :]   # [b,nc,h,i,j]
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    decay = _causal_decay(seg, causal)
    M = scores * decay * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bchij,bcjhp->bcihp", M, xc)

    # chunk summary states: S_c = sum_j exp(cum_L - cum_j) dt_j B_j x_j^T
    dec_state = torch.exp(cum[:, :, -1:, :] - cum)    # [b,nc,L,h]
    Sc = torch.einsum("bcjhn,bcjh,bcjhp->bchnp", Bc, dec_state * dtc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])         # [b,nc,h]

    state = torch.zeros((b, h, n, p), dtype=acc, device=x.device)
    prev = []                                         # state BEFORE chunk
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + Sc[:, c]
    prev_states = torch.stack(prev, dim=1)            # [b,nc,h,n,p]

    y_off = torch.einsum("bcihn,bcih,bchnp->bcihp", Cc, torch.exp(cum),
                         prev_states)
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), state


def _ssd_local(x, dt, A, B, C, chunk: int):
    """Kernel on CUDA (under autograd), ``ssd_chunked`` on CPU; (y, final
    state)."""
    if x.is_cuda:
        return ssd_kernel.SSDScan.apply(x, dt, A, B, C, chunk)
    return ssd_chunked(x, dt, A, B, C, chunk)


def _ssd_sharded(x, dt, A, B, C, chunk: int):
    """``_ssd_local`` on each rank's shard of DTensors x [B,S,H,P], dt
    [B,S,H], A [H], B/C [B,S,G,N]: the batch as sharded, the heads over
    "model" when H divides its size, with the state groups too when G
    does; when the axis is a multiple of G each rank's heads fall in one
    group, B and C are replicated and each rank takes its group. Else,
    or when "model" shards the batch (the dp plan), every rank runs all
    heads of its rows."""
    mesh = x.device_mesh
    md = mesh.mesh_dim_names.index("model")
    m = mesh.size(md)
    h, g = x.shape[2], B.shape[2]
    batch = parallel.batch_placements(x)
    repl = (Replicate(),) * len(batch)
    fn = _ssd_local
    split = not isinstance(batch[md], Shard)
    if split and h % m == 0 and (g % m == 0 or m % g == 0):
        xp, ap, sp = (parallel.on_model(pl, d, mesh)
                      for pl, d in ((batch, 2), (repl, 0), (batch, 1)))
        bp = xp if g % m == 0 else batch
        if g % m:
            j = mesh.get_local_rank(md) // (m // g)

            def fn(x, dt, A, B, C, chunk):
                return _ssd_local(x, dt, A, B[:, :, j:j + 1],
                                  C[:, :, j:j + 1], chunk)
    else:
        xp, ap, bp, sp = batch, repl, batch, batch
    return parallel.local_call(fn, (xp, sp), (xp, xp, ap, bp, bp, None),
                               x, dt, A, B, C, chunk)


def _ssd(x, dt, A, B, C, chunk: int):
    """(y, final state): ``_ssd_local``, or ``_ssd_sharded`` on
    DTensors."""
    if parallel.is_dtensor(x):
        return _ssd_sharded(x, dt, A, B, C, chunk)
    return _ssd_local(x, dt, A, B, C, chunk)


def _chain_kernels(x, params: Dict) -> bool:
    """Whether ``_block`` runs the chain around the scan as the
    ``ssm_chain`` kernels: plain CUDA tensors (no DTensor) and no
    gradient recorded (grad mode off, or no input requiring grad). The
    kernels have no backward, so a recorded gradient keeps the torch
    chain."""
    if not x.is_cuda or parallel.is_dtensor(x):
        return False
    return not (torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for t in params.values())))


def _block(cfg: ModelConfig, params: Dict, x):
    """(out [B,S,D], final state, pre-conv (xin, B, C) projections)."""
    b, s, _ = x.shape
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    chunk = min(cfg.ssm_chunk, s)
    if s % chunk:
        raise ValueError(
            f"{cfg.arch_id}: {s} tokens is not a multiple of the SSD chunk "
            f"{chunk} (min(ssm_chunk, S)); the reference asserts the same "
            f"(repro/models/ssm.py:65) and the port does not pad")

    def w(key):
        return params[key].to(x.dtype)

    z = x @ w("wz")
    xin = x @ w("wx")
    Bv = x @ w("wB")
    Cv = x @ w("wC")
    dt = x @ w("wdt")
    pre = (xin, Bv, Cv, w("conv_x"), w("conv_B"), w("conv_C"), dt,
           params["dt_bias"], params["A_log"])

    if _chain_kernels(x, params):
        xc, Bc, Cc, dt, A = ssm_chain.conv_silu(*pre)
        y, final = _ssd_local(xc.view(b, s, h, p), dt, A,
                              Bc.view(b, s, g, n), Cc.view(b, s, g, n), chunk)
        y = ssm_chain.gated_rmsnorm(y, xc, z, params["D"],
                                    params["gn_scale"])
        return y @ w("wo"), final, (xin, Bv, Cv)

    xc, Bc, Cc, dt, A = ssm_chain.conv_silu_ref(*pre)
    xc = parallel.splittable(xc, h)
    Bc, Cc = (parallel.splittable(t, g) for t in (Bc, Cc))
    y, final = _ssd(xc.reshape(b, s, h, p), dt, A, Bc.reshape(b, s, g, n),
                    Cc.reshape(b, s, g, n), chunk)
    y = ssm_chain.gated_rmsnorm_ref(y, xc, z, params["D"], params["gn_scale"])
    return y @ w("wo"), final, (xin, Bv, Cv)


def mamba2_block(cfg: ModelConfig, params: Dict, x):
    """Training/prefill path. x [B,S,D] -> [B,S,D]."""
    return _block(cfg, params, x)[0]


def mamba2_prefill(cfg: ModelConfig, params: Dict, x, cache: Dict):
    """``mamba2_block`` that also writes the decode cache in place: the
    scan's final state, and the last ``ssm_conv - 1`` pre-conv,
    pre-SiLU projections (left-padded with zeros for a shorter prompt),
    as the reference's ``lm._ssm_cache_from_prefill``. Returns (y,
    cache)."""
    y, final, pre = _block(cfg, params, x)
    parallel.write(cache["state"], final)
    s, kw1 = x.shape[1], cfg.ssm_conv - 1
    keep = min(s, kw1)
    for key, v in zip(("conv_x", "conv_B", "conv_C"), pre):
        parallel.write(cache[key], 0, (slice(None), slice(0, kw1 - keep)))
        parallel.write(cache[key], v[:, s - keep:],
                       (slice(None), slice(kw1 - keep, None)))
    return y, cache


# ---------------------------------------------------------------------------
# Decode path: O(1) state update per token.
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg: ModelConfig, b: int, dtype=torch.float32,
                   device=None) -> Dict:
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    gn = cfg.ssm_groups * cfg.ssm_state
    kw = cfg.ssm_conv

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return {"state": zeros(b, h, n, p, dt=torch.float32),
            "conv_x": zeros(b, kw - 1, cfg.d_inner),
            "conv_B": zeros(b, kw - 1, gn),
            "conv_C": zeros(b, kw - 1, gn)}


def _conv_step(buf, xt, w):
    """buf [B,K-1,W]; xt [B,W]; w [K,W] -> y [B,W]; buf shifted in
    place."""
    full = torch.cat([buf, xt[:, None, :]], dim=1)   # [B,K,W]
    y = torch.einsum("bkw,kw->bw", full, w)
    buf.copy_(full[:, 1:, :])
    return y


def mamba2_decode(cfg: ModelConfig, params: Dict, x, cache: Dict):
    """x [B,1,D] -> (y [B,1,D], cache updated in place)."""
    xt = x[:, 0, :]

    def w(key):
        return params[key].to(x.dtype)

    z = xt @ w("wz")
    xin = _conv_step(cache["conv_x"], xt @ w("wx"), w("conv_x"))
    Bv = _conv_step(cache["conv_B"], xt @ w("wB"), w("conv_B"))
    Cv = _conv_step(cache["conv_C"], xt @ w("wC"), w("conv_C"))
    dt = xt @ w("wdt")
    xin, Bv, Cv = F.silu(xin), F.silu(Bv), F.silu(Cv)

    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A)                                   # [B,H]
    y = _recurrence(cfg, cache["state"], xin, Bv, Cv, dt, dA, params["D"])
    y = rmsnorm(y.to(x.dtype) * F.silu(z), params["gn_scale"])
    return (y @ w("wo"))[:, None, :], cache


def _recurrence(cfg: ModelConfig, state, xin, Bv, Cv, dt, dA, D):
    """One step of the SSD recurrence: state [B,H,N,P] updated in place
    from xin [B,H*P], Bv, Cv [B,G*N] and dt, dA [B,H]; returns y [B,H*P]
    (fp32; D stays fp32). On a mesh, on each rank's shards of the state
    (its batch rows and, when "model" shards the heads, its heads): xin,
    dt and dA take the state's placements, Bv and Cv are whole over
    "model" and each rank takes its heads' groups."""
    h, g, n = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state

    def local(state, xin, Bv, Cv, dt, dA, D, h0=0):
        b, hl = state.shape[:2]
        xh = xin.reshape(b, hl, -1).float()
        Bh = Bv.reshape(b, g, n).repeat_interleave(h // g, dim=1)
        Ch = Cv.reshape(b, g, n).repeat_interleave(h // g, dim=1)
        Bh, Ch = Bh[:, h0:h0 + hl], Ch[:, h0:h0 + hl]
        state.mul_(dA[..., None, None]).add_(
            torch.einsum("bhn,bh,bhp->bhnp", Bh.float(), dt, xh))
        y = torch.einsum("bhn,bhnp->bhp", Ch.float(), state)
        return (y + D[:, None] * xh).reshape(b, -1)

    if not parallel.is_dtensor(state):
        return local(state, xin, Bv, Cv, dt, dA, D)
    mesh = state.device_mesh
    rows = parallel.batch_placements(state)
    head_dims = parallel.mesh_dims_sharding(state, 1)
    heads = tuple(Shard(1) if d in head_dims else p
                  for d, p in enumerate(rows))
    dp = tuple(Shard(0) if d in head_dims else Replicate()
               for d in range(mesh.ndim))
    h0 = 0
    for d in head_dims:
        h0 = h0 * mesh.size(d) + mesh.get_local_rank(d)
    h0 *= state.to_local().shape[1]
    return parallel.local_call(functools.partial(local, h0=h0), heads, (
        state.placements, heads, rows, rows, heads, heads, dp),
        state, xin, Bv, Cv, dt, dA, D)
