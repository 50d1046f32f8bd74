"""The DeepSeekMoE family (DeepSeekMoE 16B, arXiv:2401.06066): L x
[x + attn(rms(x)); x + ffn(rms(x))], causal attention with rotary
positions; the first ``first_dense_layers`` ffns a SwiGLU of width
``dense_d_ff``, the others the MoE. Its layers for the reference
(``bench.reference.model``) and its work counts (``bench.work``).

The MoE on one chip's share of an expert-parallel layer: the router
scores all ``n_experts`` (softmax in float32), the top ``top_k`` are
kept, renormalised only if ``moe_norm_topk``; the choices that fall on
the ``experts_held`` experts held here (the router's first columns) are
computed, none dropped, each SwiGLU output weighted by its gate;
the shared expert (width ``n_shared_experts * d_ff``) runs on every
token. What the other experts would add is left out.

Weights: attention and both norms stacked over every layer under
``layers/``; the dense ffns under ``dense_layers/mlp``; the MoE layers'
router, held experts [.., held, ..] and shared expert under
``moe_layers/moe``.
"""
from __future__ import annotations

import torch

from bench import work
from bench.reference import model as ref


def _swiglu(prefix: str, stack: tuple, d: int, f: int) -> list:
    return [(f"{prefix}/{name}", stack + shape, ref.dense(*shape))
            for name, shape in (("w1", (d, f)), ("w3", (d, f)),
                                ("w2", (f, d)))]


def layout(cfg: dict) -> list:
    L, d, nd = cfg["n_layers"], cfg["d_model"], cfg["first_dense_layers"]
    nm, e, f = L - nd, cfg["n_experts"], cfg["d_ff"]
    return ([("layers/attn_norm", (L, d), ("ones",))]
            + ref.attn_layout(cfg, "layers/attn", (L,))
            + [("layers/ffn_norm", (L, d), ("ones",))]
            + _swiglu("dense_layers/mlp", (nd,), d, cfg["dense_d_ff"])
            + [("moe_layers/moe/router", (nm, d, e), ref.dense(d, e))]
            + _swiglu("moe_layers/moe", (nm, cfg["experts_held"]), d, f)
            + _swiglu("moe_layers/moe/shared", (nm,), d,
                      cfg["n_shared_experts"] * f))


def moe(cfg: dict, dots, w, x):
    """The MoE ffn (module docstring) of one sequence's normed x [S, D];
    ``w`` the layer's router, w1/w3/w2 [held, ...] and shared/*."""
    probs = torch.softmax(dots.mm(x, w["router"]), dim=-1)
    gates, idx = torch.topk(probs, cfg["top_k"], dim=-1)
    if cfg["moe_norm_topk"]:
        gates = gates / gates.sum(-1, keepdim=True)
    y = ref.mlp(dots, {k: w[f"shared/{k}"] for k in ("w1", "w3", "w2")}, x)
    for j in range(cfg["experts_held"]):
        hit = idx == j
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel():
            g = (gates * hit).sum(-1)[rows]
            out = ref.mlp(dots, {k: w[k][j] for k in ("w1", "w3", "w2")},
                          x[rows])
            y = y.index_add(0, rows, g[:, None] * out)
    return y


def sublayers(cfg: dict, dots, w, i: int) -> list:
    nd = cfg["first_dense_layers"]
    if i < nd:
        def ffn(h):
            return ref.mlp(dots, ref.block(w, "dense_layers/mlp", i), h)
    else:
        def ffn(h):
            return moe(cfg, dots, ref.block(w, "moe_layers/moe", i - nd), h)
    return [ref.residual(cfg, w["layers/attn_norm"][i],
                         lambda h: ref.attention(
                             cfg, dots, ref.block(w, "layers/attn", i), h)),
            ref.residual(cfg, w["layers/ffn_norm"][i], ffn)]


def matmul_params(cfg: dict) -> float:
    """Weights a token meets in a matrix product, a routed expert counted
    at the share of tokens it expects, top_k / n_experts of them: the
    attention projections of every layer, the dense ffns, and each MoE
    layer's router, shared expert and held experts."""
    d, hd, f = cfg["d_model"], ref.head_dim(cfg), cfg["d_ff"]
    L, nd = cfg["n_layers"], cfg["first_dense_layers"]
    attn = d * hd * (2 * cfg["n_heads"] + 2 * cfg["n_kv_heads"])
    routed = (3 * d * f * cfg["experts_held"] * cfg["top_k"]
              / cfg["n_experts"])
    moe_layer = (d * cfg["n_experts"] + 3 * d * cfg["n_shared_experts"] * f
                 + routed)
    return L * attn + nd * 3 * d * cfg["dense_d_ff"] + (L - nd) * moe_layer


def mix_flops(cfg: dict, b: int, queries: int, before: int) -> float:
    return cfg["n_layers"] * work.attention_flops(
        b, cfg["n_heads"], ref.head_dim(cfg), queries, before)


def kernel_calls(cfg: dict, traffic: dict) -> dict:
    """Flash attention only: the experts' rows, and so their fused MLP
    calls, depend on the routing."""
    L, b = cfg["n_layers"], traffic["batch"]
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], ref.head_dim(cfg)
    if traffic["kind"] == "train":
        s = traffic["seq"]
        return {"flash_fwd": [(2 * L, work.flash_fwd(b, s, h, kv, hd))],
                "flash_bwd": [(L, work.flash_bwd(b, s, h, kv, hd))]}
    return {"flash_fwd": [(L, work.flash_fwd(b, traffic["prompt"], h, kv,
                                             hd))]}
