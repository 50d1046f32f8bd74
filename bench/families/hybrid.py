"""The Granite 4.0-H family (IBM Granite 4.0-H Small; the hybrid
family's typed layout): L x [x + m mixer(rms(x)); x + m moe(rms(x))],
layer i's mixer a Mamba-2 layer or causal attention as
``layer_types[i]`` says, m the ``residual_multiplier``; the embedding
times ``embedding_multiplier`` first. Its layers for the reference
(``bench.reference.model``) and its work counts (``bench.work``).

Attention has no position encoding (NoPE) and scores q k^T times
``attention_multiplier`` (1/128 published, not 1/sqrt(hd)), GQA over
``n_kv_heads``. The MoE after every mixer is ``bench.families.moe.moe``:
the router over all ``n_experts``, the top ``top_k`` renormalised (a
softmax over the top k), the choices that fall on the ``experts_held``
experts held here, and the shared expert of ``n_shared_experts * d_ff``
on every token. The configuration's ``logits_scaling`` is 1: the
reference's logits (``bench.reference.model.logits``) are not divided.

Weights: each layer's ``mixer_norm``, ``ffn_norm`` and ``moe`` stacked
over every layer under ``layers/``; the Mamba-2 layers' mixers under
``mamba_layers/ssm``, the attention layers' under ``attn_layers/attn``,
each in layer order. Zamba-2's shared-block layout (``attn_every``) has
no cell and is refused.
"""
from __future__ import annotations

import torch

from bench import work
from bench.families import moe as moe_family
from bench.families.ssm import _dims as _ssm_dims
from bench.reference import model as ref


def layer_types(cfg: dict) -> list:
    if cfg.get("attn_every"):
        raise ValueError(f"{cfg['name']}: the shared-block hybrid "
                         "(attn_every) has no cell; only typed layers")
    return list(cfg["layer_types"])


def _counts(cfg: dict):
    """(Mamba-2 layers, attention layers)."""
    types = layer_types(cfg)
    return types.count("mamba"), types.count("attention")


def layout(cfg: dict) -> list:
    L, d, e, f = (cfg["n_layers"], cfg["d_model"], cfg["n_experts"],
                  cfg["d_ff"])
    nm, na = _counts(cfg)
    return ([("layers/mixer_norm", (L, d), ("ones",)),
             ("layers/ffn_norm", (L, d), ("ones",)),
             ("layers/moe/router", (L, d, e), ref.dense(d, e))]
            + moe_family._swiglu("layers/moe", (L, cfg["experts_held"]), d,
                                 f)
            + moe_family._swiglu("layers/moe/shared", (L,), d,
                                 cfg["n_shared_experts"] * f)
            + ref.mamba2_layout(cfg, "mamba_layers/ssm", (nm,))
            + ref.attn_layout(cfg, "attn_layers/attn", (na,)))


def attention(cfg: dict, dots, w, x):
    """Causal NoPE self-attention of one sequence x [S, D] at the softmax
    scale ``attention_multiplier``; ``w`` the block's wq, wk, wv, wo."""
    s = x.shape[0]
    h, kv = cfg["n_heads"], cfg["n_kv_heads"]
    hd = ref.head_dim(cfg)
    q = dots.mm(x, w["wq"]).view(s, h, hd)
    k = dots.mm(x, w["wk"]).view(s, kv, hd).repeat_interleave(h // kv, 1)
    v = dots.mm(x, w["wv"]).view(s, kv, hd).repeat_interleave(h // kv, 1)
    scores = (dots.mm(q.transpose(0, 1), k.permute(1, 2, 0))
              * cfg["attention_multiplier"])
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = dots.mm(p, v.transpose(0, 1)).transpose(0, 1).reshape(s, h * hd)
    return dots.mm(o, w["wo"])


def sublayers(cfg: dict, dots, w, i: int) -> list:
    types = layer_types(cfg)
    j = types[:i].count(types[i])
    m = cfg["residual_multiplier"]
    if types[i] == "mamba":
        def mix(h):
            return ref.mamba2(cfg, dots, ref.block(w, "mamba_layers/ssm", j),
                              h)
    else:
        def mix(h):
            return attention(cfg, dots, ref.block(w, "attn_layers/attn", j),
                             h)

    def ffn(h):
        return moe_family.moe(cfg, dots, ref.block(w, "layers/moe", i), h)

    subs = [ref.residual(cfg, w["layers/mixer_norm"][i],
                         lambda h: m * mix(h)),
            ref.residual(cfg, w["layers/ffn_norm"][i], lambda h: m * ffn(h))]
    if i == 0:
        subs.insert(0, lambda x: x * cfg["embedding_multiplier"])
    return subs


def matmul_params(cfg: dict) -> float:
    """Weights a token meets in a matrix product, a routed expert counted
    at the share of tokens it expects, top_k / n_experts of them: each
    Mamba-2 layer's in projections (z, x, B, C, dt) and out projection,
    each attention layer's projections, and every layer's router, shared
    expert and held experts."""
    d, hd, f = cfg["d_model"], ref.head_dim(cfg), cfg["d_ff"]
    nm, na = _counts(cfg)
    di, h, gn = _ssm_dims(cfg)
    mamba = d * (2 * di + 2 * gn + h) + di * d
    attn = d * hd * (2 * cfg["n_heads"] + 2 * cfg["n_kv_heads"])
    routed = (3 * d * f * cfg["experts_held"] * cfg["top_k"]
              / cfg["n_experts"])
    ffn = d * cfg["n_experts"] + 3 * d * cfg["n_shared_experts"] * f + routed
    return nm * mamba + na * attn + cfg["n_layers"] * ffn


def mix_flops(cfg: dict, b: int, queries: int, before: int) -> float:
    """The attention layers' score and value products over the kept
    pairs, and the Mamba-2 layers' recurrence, 2 x 2 N P a head a
    token."""
    nm, na = _counts(cfg)
    _, h, _ = _ssm_dims(cfg)
    return (na * work.attention_flops(b, cfg["n_heads"], ref.head_dim(cfg),
                                      queries, before)
            + 4.0 * h * cfg["ssm_state"] * cfg["ssm_head_dim"] * nm * b
            * queries)


def kernel_calls(cfg: dict, traffic: dict) -> dict:
    """The SSD scan a Mamba-2 layer, flash an attention layer; the
    experts' rows, and so the fused MLP's calls, depend on the
    routing."""
    nm, na = _counts(cfg)
    _, h, _ = _ssm_dims(cfg)
    b = traffic["batch"]
    kv, hd = cfg["n_kv_heads"], ref.head_dim(cfg)
    s = traffic["seq"] if traffic["kind"] == "train" else traffic["prompt"]
    ssd = work.ssd_fwd(b, s, h, cfg["ssm_groups"], cfg["ssm_state"],
                       cfg["ssm_head_dim"], min(cfg["ssm_chunk"], s))
    flash = work.flash_fwd(b, s, cfg["n_heads"], kv, hd)
    if traffic["kind"] == "train":
        return {"ssd_fwd": [(2 * nm, ssd)],
                "ssd_bwd": [(nm, work.ssd_bwd(
                    b, s, h, cfg["ssm_groups"], cfg["ssm_state"],
                    cfg["ssm_head_dim"], min(cfg["ssm_chunk"], s)))],
                "flash_fwd": [(2 * na, flash)],
                "flash_bwd": [(na, work.flash_bwd(b, s, cfg["n_heads"], kv,
                                                  hd))]}
    return {"ssd_fwd": [(nm, ssd)], "flash_fwd": [(na, flash)]}
