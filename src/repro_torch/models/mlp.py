"""Dense FFN (SwiGLU / GELU) and MoE (top-k routing, capacity-bounded
dispatch).

PyTorch counterpart of ``repro.models.mlp``. On CUDA tensors SwiGLU runs
the hand-written fused MLP kernels through their autograd Function
(``kernels.fused_mlp.FusedMLP``: the forward kernels, which form h in
fp32 and round it once and under grad keep g = x W1 and u = x W3 in
bf16; the backward kernels ``csrc/fused_mlp_bwd.cu``, which start from
that g and u); on CPU tensors it runs the reference's formula, which
rounds each product to x.dtype, under plain autograd. In bf16 the two
round differently.

MoE: the router and the routed experts have no Pallas kernel in the
reference (jnp einsums), so here they are torch ops: an fp32 router
product and softmax, ``torch.topk``, and batched expert products. The
shared expert (deepseek) goes through ``mlp``, so on the card it runs
the fused MLP kernel. Routing keeps the reference's static shapes (a
capacity-padded slot table, no ``nonzero``), so it never waits on the
device. The port's own "dropless" dispatch (``_moe_dropless``, one
device) drops no choice instead: it computes the choices that fall on
the ``experts_held`` experts the device holds, each expert's rows one
segment through the fused MLP kernel, after one read of the segments'
sizes.

On a mesh (x a DTensor) each MoE layer is three ``parallel.local_call``s
(``_moe_sharded``): routing and the dispatch gather on each data shard's
tokens, the experts on each rank's experts, and the combine. Routing is
shard-local when the ``moe_shards`` routing shards fall within the data
shards (``moe_shards`` a multiple of them), as the reference's
``moe_data_axes`` hint places them; else the batch is gathered first and
every rank routes all tokens (GSPMD's gather at ``moe_shards`` = 1). The
expert weights stay where their specs put them: each rank runs the
experts it holds ("model", the reference's ``moe_expert_axis``) on its
slice of the slot table, and only the expert outputs are all-gathered
over that axis, back to the data shards (the reference's ``yef``
constraint). The aux loss's means over all tokens are partial sums over
the data shards, reduced before the product.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from ..kernels import fused_mlp as fused_kernel
from ..launch import spans
from ..launch.spans import span
from . import parallel
from .common import ModelConfig, dense_init


def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_model=None,
             d_ff=None, dtype=torch.float32) -> Dict:
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.mlp == "swiglu":
        return {"w1": dense_init(gen, d, f, dtype),
                "w3": dense_init(gen, d, f, dtype),
                "w2": dense_init(gen, f, d, dtype)}
    return {"w1": dense_init(gen, d, f, dtype),
            "w2": dense_init(gen, f, d, dtype)}


def _swiglu_local(x, w1, w3, w2):
    """The fused MLP kernel on CUDA (under autograd), the reference's
    formula on CPU."""
    if x.is_cuda:
        y = fused_kernel.FusedMLP.apply(x.reshape(-1, x.shape[-1]), w1, w3,
                                        w2)
        return y.reshape(x.shape)
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def _swiglu_sharded(x, w1, w3, w2):
    """``_swiglu_local`` on each rank's shard of DTensors: x with its
    batch sharding, replicated over "model"; w1/w3 [K, F] and w2 [F, K]
    gathered over the data axes. When the spec shards F over "model"
    (w2's dim 0), each rank computes its F slice and the output is a
    partial sum over "model"; else every rank computes all of it."""
    mesh = x.device_mesh
    md = mesh.mesh_dim_names.index("model")
    xp = parallel.batch_placements(x)
    wp = w2p = (Replicate(),) * mesh.ndim
    out = xp
    if isinstance(w2.placements[md], Shard):
        wp, w2p = (parallel.on_model(wp, 1, mesh),
                   parallel.on_model(wp, 0, mesh))
        out = tuple(Partial() if d == md else p for d, p in enumerate(xp))
    return parallel.local_call(_swiglu_local, out, (xp, wp, wp, w2p),
                               x, w1, w3, w2)


def mlp(cfg: ModelConfig, params: Dict, x):
    if "w3" not in params:
        h = F.gelu(x @ params["w1"].to(x.dtype), approximate="tanh")
        return h @ params["w2"].to(x.dtype)
    w1, w3, w2 = (params[k].to(x.dtype) for k in ("w1", "w3", "w2"))
    if parallel.is_dtensor(x):
        return _swiglu_sharded(x, w1, w3, w2)
    return _swiglu_local(x, w1, w3, w2)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def init_moe(cfg: ModelConfig, gen: torch.Generator,
             dtype=torch.float32) -> Dict:
    """router [D, E] (fp32 whatever ``dtype`` is), w1/w3 [Eh, D, F], w2
    [Eh, F, D] for the ``Eh = cfg.held_experts`` experts this device
    holds, and with ``n_shared_experts`` a SwiGLU ``shared`` expert of
    width ``n_shared_experts * d_ff``; drawn in fp32 on the generator's
    device, then cast."""
    e, d, f = cfg.held_experts, cfg.d_model, cfg.d_ff

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=gen.device)

    p = {"router": dense_init(gen, d, cfg.n_experts, torch.float32),
         "w1": (normal(e, d, f) / math.sqrt(d)).to(dtype),
         "w3": (normal(e, d, f) / math.sqrt(d)).to(dtype),
         "w2": (normal(e, f, d) / math.sqrt(f)).to(dtype)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(cfg, gen, d_model=d,
                               d_ff=cfg.n_shared_experts * f, dtype=dtype)
    return p


def _shards(cfg: ModelConfig, t: int) -> int:
    """Routing shards: ``moe_shards`` when it divides the ``t`` tokens,
    else 1 (the reference's fallback)."""
    return cfg.moe_shards if t % cfg.moe_shards == 0 else 1


def capacity(cfg: ModelConfig, tl: int) -> int:
    """Slots per expert for ``tl`` shard-local tokens: int(tl*k/E*cf),
    at least min(k, tl)."""
    k = cfg.top_k
    cap = int(tl * k / cfg.n_experts * cfg.capacity_factor)
    return max(cap, min(k, tl))


def _gating(cfg: ModelConfig, params: Dict, xt):
    """xt [..., D] -> (probs [..., E] fp32: the softmax of the fp32 router
    product, gates [..., k] fp32: the top k of them, renormalised to sum
    to 1 unless ``moe_norm_topk`` is off, their experts [..., k])."""
    probs = torch.softmax(xt.float() @ params["router"].float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.moe_norm_topk:
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                            min=1e-9)
    return probs, gate_vals, gate_idx


def _route(cfg: ModelConfig, params: Dict, xt):
    """Shared router (``repro/models/mlp.py::_route``): xt [ns, tl, D] ->
    (probs [ns, tl, E] fp32, gates [ns, tl, k] fp32 (``_gating``'s, 0 where
    dropped), gate_idx [ns, tl, k], pos [ns, tl, k], keep [ns, tl, k],
    cap, counts [ns, E] (choices per expert)). ``pos`` is a choice's place
    in its expert's queue: the exclusive cumsum of the one-hot over the
    token-major flattening of (token, choice); ``keep`` is pos < cap."""
    ns, tl, _ = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    probs, gate_vals, gate_idx = _gating(cfg, params, xt)
    cap = capacity(cfg, tl)
    # the one-hot expert-major, [ns*E, tl*k], scanned as one flat sequence:
    # a 1-D scan runs in parallel on the card, where a scan down the
    # tl*k-long dim of [ns, tl*k, E] runs E columns one element at a time
    # (14.6 ms a call at granite_moe_1b_a400m's 8192 tokens on an H100).
    # Each row's running count less the rows before it is the cumsum.
    idx = gate_idx.reshape(ns, 1, tl * k)
    onehot = (idx == torch.arange(e, device=xt.device)[:, None]).to(
        torch.int32).view(ns * e, tl * k)
    run = onehot.view(-1).cumsum(0, dtype=torch.int32).view(ns * e, tl * k)
    total = run[:, -1]
    counts = torch.diff(total, prepend=total.new_zeros(1))  # per expert
    before = run - (total - counts)[:, None] - onehot
    pos = before.view(ns, e, tl * k).gather(1, idx).view(ns, tl, k).long()
    keep = pos < cap
    return (probs, gate_vals * keep, gate_idx, pos, keep, cap,
            counts.view(ns, e))


def _aux_means(probs, counts, parts: int = 1):
    """The aux loss's two means over the tokens of probs [ns, tl, E]:
    mean(probs_e) and mean(choices_e), each divided by ``parts``, the
    number of data shards whose sums make the whole (1 alone)."""
    ns, tl, _ = probs.shape
    return (probs.mean(dim=(0, 1)) / parts,
            counts.float().sum(0) / (ns * tl) / parts)


def _aux_of(cfg: ModelConfig, me, ce):
    """GShard load balance: sum_e me_e * ce_e * E * router_aux_coef."""
    return (me * ce).sum() * cfg.n_experts * cfg.router_aux_coef


def _aux_loss(cfg: ModelConfig, probs, counts, gate_idx, b: int):
    """The aux loss of ``b`` sequences, whose tokens (token-major) are
    those of probs [.., E], gate_idx [.., k] and counts [.., E] (choices
    per expert of each routing shard): GShard's, the means over every
    token of every routing shard, or with ``router_aux`` "seq"
    DeepSeekMoE's sequence-level loss, coef x mean_b sum_e f_be P_be with
    f_be = (choices of e in b) E / (k S) and P_be = mean_t probs_bte. The
    choice counts are exact in fp32; counts None counts gate_idx as one
    routing shard. A coefficient of 0 launches nothing."""
    if not cfg.router_aux_coef:
        return probs.new_zeros(())
    e, k = cfg.n_experts, cfg.top_k
    if cfg.router_aux == "gshard":
        if counts is None:
            idx = gate_idx.reshape(1, -1)
            counts = torch.zeros((1, e), dtype=torch.float32,
                                 device=idx.device).scatter_add_(
                1, idx, torch.ones_like(idx, dtype=torch.float32))
        return _aux_of(cfg, *_aux_means(probs, counts))
    idx = gate_idx.reshape(b, -1)
    s_len = idx.shape[1] // k
    f = torch.zeros((b, e), dtype=torch.float32, device=idx.device)
    f.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))
    p = probs.reshape(b, s_len, e).mean(dim=1)
    return ((f * e / (k * s_len)) * p).sum(-1).mean() * cfg.router_aux_coef


def _experts(params: Dict, xe, dtype):
    """xe [ns, E, cap, D] -> [ns, E, cap, D] through each expert's
    SwiGLU (batched products, one per weight)."""
    h = F.silu(torch.einsum("secd,edf->secf", xe, params["w1"].to(dtype)))
    h = h * torch.einsum("secd,edf->secf", xe, params["w3"].to(dtype))
    return torch.einsum("secf,efd->secd", h, params["w2"].to(dtype))


def _take_rows(src, idx):
    """out[s, i] = src[s, idx[s, i]], or zeros where idx[s, i] equals
    src.shape[1] (the sentinel); src [ns, n, D], idx [ns, m]."""
    ns, n, d = src.shape
    pad = F.pad(src, (0, 0, 0, 1)).reshape(ns * (n + 1), d)
    base = torch.arange(ns, device=idx.device)[:, None] * (n + 1)
    return pad.index_select(0, (idx + base).reshape(-1)).view(
        ns, idx.shape[1], d)


class _RowGather(torch.autograd.Function):
    """``_take_rows(src, idx)`` whose backward is a gather too:
    dsrc[s, r] is the sum over j of dout[s, inv[s, r, j]] (zeros at the
    sentinel dout.shape[1]), in a fixed order. ``inv`` lists, for each
    row of src, the outputs that read it. autograd of the forward gather
    would scatter-add, with atomics in no fixed order on CUDA."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return _take_rows(src, idx)

    @staticmethod
    def backward(ctx, dout):
        inv, = ctx.saved_tensors
        ns, n, j = inv.shape
        g = _take_rows(dout, inv.reshape(ns, n * j)).view(ns, n, j, -1)
        return g.sum(dim=2), None, None


def _add_shared(cfg: ModelConfig, params: Dict, x, y):
    """The routed output ``y`` [ns, tl, D] as [B, S, D], plus the shared
    expert's ``mlp`` of x [B, S, D] (row-wise, so the reference's [ns, tl,
    D] view gives the same rows). Taking x itself, not its [ns, tl, D]
    view, sums x's gradient as lm's "mlp" remat policy does, where the
    routed half is a checkpoint of its own: bitwise the same."""
    y = y.reshape(x.shape)
    if "shared" in params:
        y = y + parallel.like(mlp(cfg, params["shared"], x), y)
    return y


def _dispatch_gather(cfg: ModelConfig, params: Dict, xt):
    """Gather dispatch of xt [ns, tl, D]: each kept (token, choice) is
    copied into its expert slot -> (xe [ns, E, cap, D], the combine's
    context (gates, the slot each choice reads, the choice each slot
    holds), probs, counts, gate_idx)."""
    ns, tl, _ = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    probs, gates, gate_idx, pos, keep, cap, counts = _route(cfg, params, xt)
    flat_slot = (gate_idx * cap + pos).reshape(ns, tl * k)
    kept = keep.reshape(ns, tl * k)
    slot_or_drop = torch.where(kept, flat_slot, e * cap)
    # slot -> (token, choice) index, tl*k for an empty slot; dropped
    # choices go to an extra column that is sliced off (an out-of-range
    # scatter index is a device-side assert on CUDA)
    filled = torch.full((ns, e * cap + 1), tl * k, dtype=torch.long,
                        device=xt.device)
    filled.scatter_(1, slot_or_drop,
                    torch.arange(tl * k, device=xt.device).expand(ns, -1))
    filled = filled[:, :e * cap]
    # dispatch: slot <- its token (tl: the zero sentinel row); each token
    # gets back the sum of its kept slots' gradients
    xe = _RowGather.apply(xt, torch.div(filled, k, rounding_mode="floor"),
                          slot_or_drop.view(ns, tl, k))
    ctx = (gates, torch.where(kept, flat_slot, 0), filled)
    return xe.view(ns, e, cap, -1), ctx, probs, counts, gate_idx


def _combine_gather(ye, ctx, dtype):
    """ye [ns, E, cap, D] -> y [ns, tl, D]: each (token, choice) reads its
    slot (slot 0 where dropped, gate 0), combined with fp32 gates. A
    slot's gradient comes from the choice that filled it (a dropped
    choice's is dy * 0 = 0)."""
    gates, back_idx, filled = ctx
    ns, tl, k = gates.shape
    back = _RowGather.apply(ye.reshape(ns, -1, ye.shape[-1]), back_idx,
                            filled[..., None]).view(ns, tl, k, -1)
    return (back.float() * gates[..., None]).sum(dim=2).to(dtype)


def _dispatch_einsum(cfg: ModelConfig, params: Dict, xt):
    """GShard one-hot dispatch of xt [ns, tl, D] -> (xe [ns, E, cap, D],
    (the combine tensor [ns, tl, E, cap],), probs, counts, gate_idx)."""
    e = cfg.n_experts
    probs, gates, gate_idx, pos, keep, cap, counts = _route(cfg, params, xt)
    onehot = F.one_hot(gate_idx, e)                          # [ns,tl,k,E]
    pos_oh = F.one_hot(torch.where(keep, pos, cap), cap + 1)[..., :cap]
    disp = torch.einsum("stke,stkc->stec", onehot.to(xt.dtype),
                        pos_oh.to(xt.dtype))
    comb = torch.einsum("stke,stkc,stk->stec", onehot.float(),
                        pos_oh.float(), gates).to(xt.dtype)
    xe = torch.einsum("stec,std->secd", disp, xt)
    return xe, (comb,), probs, counts, gate_idx


def _combine_einsum(ye, ctx, dtype):
    comb, = ctx
    return torch.einsum("stec,secd->std", comb, ye)


# impl: (dispatch, combine, the number of context tensors between them)
_IMPLS = {"gather": (_dispatch_gather, _combine_gather, 3),
          "einsum": (_dispatch_einsum, _combine_einsum, 1)}


def _moe_local(cfg: ModelConfig, params: Dict, x, impl: str):
    """x [B, S, D] on one device -> (y [B, S, D], aux)."""
    dispatch, combine, _ = _IMPLS[impl]
    b, s_len, d = x.shape
    t = b * s_len
    ns = _shards(cfg, t)
    xe, ctx, probs, counts, gate_idx = dispatch(
        cfg, params, x.reshape(ns, t // ns, d))
    y = combine(_experts(params, xe, x.dtype), ctx, x.dtype)
    return (_add_shared(cfg, params, x, y),
            _aux_loss(cfg, probs, counts, gate_idx, b))


def _expert_dims(w, taken) -> list:
    """The mesh dims over which expert weight ``w`` [E, ...] is sharded on
    its expert dim, less those in ``taken`` (the slot table's data
    dims, where the experts are gathered)."""
    return [i for i, p in enumerate(w.placements)
            if p == Shard(0) and i not in taken]


def _moe_sharded(cfg: ModelConfig, params: Dict, x, impl: str):
    """``_moe_local`` on DTensor x [B, S, D] (module docstring): (1) each
    data shard routes its tokens (or, when a routing shard spans data
    shards, every rank routes the gathered batch) and fills its slot
    table xe [ns, E, cap, D], sharded as the routing shards; (2) each
    rank runs its experts on its slice of xe's expert dim; (3) the
    expert outputs are gathered over the experts' mesh dims and each
    data shard combines its tokens. The aux loss's means leave (1) as
    partial sums over the data dims."""
    dispatch, combine, n_ctx = _IMPLS[impl]
    mesh = x.device_mesh
    b, s_len, d = x.shape
    t = b * s_len
    ns = _shards(cfg, t)
    rep = (Replicate(),) * mesh.ndim
    rows = parallel.batch_placements(x)
    data = [i for i, p in enumerate(rows) if isinstance(p, Shard)]
    parts = math.prod(mesh.size(i) for i in data)
    if ns % parts or b % parts:
        rows, data, parts = rep, [], 1
    ns_l = ns // parts
    part = tuple(Partial() if i in data else p for i, p in enumerate(rep))

    def route(xl, router):
        xe, ctx, probs, counts, _ = dispatch(cfg, {"router": router},
                                             xl.reshape(ns_l, -1, d))
        return (xe, *ctx, *_aux_means(probs, counts, parts))

    w = {n: params[n].to(x.dtype) for n in ("w1", "w3", "w2")}
    out = parallel.local_call(route, (rows,) * (1 + n_ctx) + (part, part),
                              (rows, rep), x, params["router"])
    xe, ctx, (me, ce) = out[0], out[1:-2], out[-2:]
    # (2) the experts where their weights are: xe's expert dim split as
    # the weights' (a local slice of the replicated slot table)
    edims = _expert_dims(w["w1"], data)
    wp = tuple(Shard(0) if i in edims else Replicate()
               for i in range(mesh.ndim))
    xp = tuple(Shard(1) if i in edims else p for i, p in enumerate(rows))
    ye = parallel.local_call(
        lambda xe, w1, w3, w2: _experts({"w1": w1, "w3": w3, "w2": w2}, xe,
                                        x.dtype),
        xp, (xp, wp, wp, wp), xe, w["w1"], w["w3"], w["w2"])
    # (3) the outputs gathered back to the routing shards, then combined
    y = parallel.local_call(
        lambda ye, *ctx: combine(ye, ctx, x.dtype).reshape(-1, s_len, d),
        rows, (rows,) * (1 + len(ctx)), ye, *ctx)
    if y.placements != parallel.batch_placements(x):
        y = y.redistribute(mesh, parallel.batch_placements(x))
    aux = parallel.local_call(functools.partial(_aux_of, cfg), rep,
                              (rep, rep), me, ce)
    return _add_shared(cfg, params, x, y), aux


def moe_gather(cfg: ModelConfig, params: Dict, x) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """Gather dispatch (``repro/models/mlp.py::moe_gather``): each kept
    (token, choice) is copied into its expert slot, the experts run on
    [ns, E, cap, D], and each (token, choice) reads its slot back (a
    dropped one reads slot 0 with gate 0), combined with fp32 gates.
    x [B, S, D] -> (y [B, S, D], aux). Both gathers' backwards are
    gathers (``_RowGather``), so the step is deterministic on the card."""
    return _moe(cfg, params, x, "gather")


def moe_einsum(cfg: ModelConfig, params: Dict, x) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """GShard one-hot dispatch (``repro/models/mlp.py::moe_einsum``), the
    reference formulation: dispatch and combine tensors [ns, tl, E, cap].
    At train shapes those are gigabytes (granite_moe_1b_a400m's combine
    at 8192 tokens: [1, 8192, 32, 2560] fp32), so the card runs
    ``moe_gather``."""
    return _moe(cfg, params, x, "einsum")


# ---------------------------------------------------------------------------
# Dropless MoE over the held experts
# ---------------------------------------------------------------------------

class _Combine(torch.autograd.Function):
    """out[t] = the sum over c of rows[slot[t, c]] in choice order (zeros
    where slot[t, c] is the sentinel rows.shape[0]); rows [n, D], slot
    [T, k]. Each row belongs to one token, ``tok``, so the backward is one
    [n, D] gather (``_RowGather``'s would copy [T * k, D])."""

    @staticmethod
    def forward(ctx, rows, slot, tok):
        ctx.save_for_backward(tok)
        t, k = slot.shape
        return _take_rows(rows[None], slot.view(1, t * k)).view(
            t, k, -1).sum(dim=1)

    @staticmethod
    def backward(ctx, dy):
        tok, = ctx.saved_tensors
        return dy.index_select(0, tok), None, None


def _moe_dropless(cfg: ModelConfig, params: Dict, x):
    """x [B, S, D] on one device -> (y [B, S, D], aux): every (token,
    choice) whose expert this device holds is computed, none dropped.

    Route over all ``n_experts`` (``_gating``); sort the pairs on held
    experts into one contiguous segment per expert (a stable sort keeps
    each segment token-major); read the segments' sizes to the host once
    (the call's one wait for the card; on the card the shared expert is
    queued behind the sizes' copy, so the card works while the host
    waits); gather each pair's token row and run each held expert's
    segment through the SwiGLU (the fused MLP kernel on the card);
    weight each row by its gate in fp32 and sum each token's rows in
    choice order. Dispatch and combine are gathers both ways, so the
    step is bitwise deterministic."""
    b, s_len, d = x.shape
    t, k = b * s_len, cfg.top_k
    held = cfg.held_experts
    xt = x.reshape(t, d)
    with span("moe.route"):
        probs, gates, gate_idx = _gating(cfg, params, xt)
        key = gate_idx.reshape(-1).clamp(max=held)
        sorted_key, order = torch.sort(key, stable=True)
        # each segment's end in the sorted keys; a bincount would wait
        # on the card to size its output
        ends = torch.searchsorted(sorted_key, torch.arange(
            1, held + 1, device=x.device))
        sizes = torch.diff(ends, prepend=ends.new_zeros(1))
        rank = torch.empty_like(order).scatter_(
            0, order, torch.arange(t * k, device=x.device))
        ready = None
        if x.is_cuda:
            sizes = torch.empty(held, dtype=sizes.dtype,
                                pin_memory=True).copy_(sizes,
                                                       non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
    shared = mlp(cfg, params["shared"], x) if "shared" in params else None
    with span("moe.readback"):
        if ready is not None:
            ready.synchronize()
        sizes = sizes.tolist()
    n = sum(sizes)
    spans.count("moe.readbacks", 1)
    spans.count("moe.routed_rows", n)
    spans.count("moe.rows_by_expert", sizes)
    rows = order[:n]
    tok = torch.div(rows, k, rounding_mode="floor")
    slot = torch.where(key < held, rank, n).view(t, k)
    with span("moe.experts"):
        xs = _RowGather.apply(xt[None], tok[None], slot[None])[0]
        ws = [params[w].to(x.dtype).unbind(0) for w in ("w1", "w3", "w2")]
        ys = [_swiglu_local(seg, *(w[e] for w in ws))
              for e, seg in enumerate(xs.split(sizes)) if sizes[e]]
        ys = torch.cat(ys) if ys else xs
    with span("moe.combine"):
        yw = ys.float() * gates.reshape(-1)[rows][:, None]
        y = _Combine.apply(yw, slot, tok).to(x.dtype)
    aux = _aux_loss(cfg, probs[None], None, gate_idx, b)
    y = y.view(b, s_len, d)
    return (y if shared is None else y + shared), aux


def _moe(cfg: ModelConfig, params: Dict, x, impl: str):
    if parallel.is_dtensor(x):
        if impl == "dropless" or cfg.held_experts != cfg.n_experts:
            raise ValueError(f"{cfg.arch_id}: the dropless MoE and a share "
                             "of the experts run on one device, not a mesh")
        return _moe_sharded(cfg, params, x, impl)
    if impl == "dropless":
        return _moe_dropless(cfg, params, x)
    if cfg.held_experts != cfg.n_experts:
        raise ValueError(f"{cfg.arch_id}: {cfg.held_experts} of "
                         f"{cfg.n_experts} experts held needs moe_impl "
                         f"'dropless', not {impl!r}")
    return _moe_local(cfg, params, x, impl)


def moe(cfg: ModelConfig, params: Dict, x) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Dispatch by ``cfg.moe_impl``: "gather" (the default), "einsum" or
    "dropless" (``_moe_dropless``; one device); "gather" and "einsum" on
    one device or, for DTensor x, on its mesh."""
    return _moe(cfg, params, x, cfg.moe_impl)
