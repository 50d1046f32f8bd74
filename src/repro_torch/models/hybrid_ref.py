"""Plain float32 reference of Granite 4.0-H (IBM Granite 4.0-H Small;
``config.json`` on the Hugging Face hub, ibm-granite/granite-4.0-h-small,
``model_type`` granitemoehybrid), for the port's CPU tests.

Written from the published config in plain PyTorch: no kernel of the
port, no cache, no dispatch tables, nothing of JAX. Every matrix product
is float32 with TF32 off (``strict_fp32``). It reads the port's parameter
tree in its typed layout (``models/lm.py``): ``layers`` (each layer's
``mixer_norm``, ``ffn_norm`` and ``moe``, stacked over every layer),
``mamba_layers`` (``ssm``) and ``attn_layers`` (``attn``).

x = embed(tokens) * embedding_multiplier; layer i is
x + m mixer(rms(x)), then x + m moe(rms(x)), m the residual_multiplier,
the mixer as ``layer_types[i]`` says:

* "attention": causal GQA with no position encoding (NoPE), the scores
  q k^T times ``attention_multiplier`` (1/128 published, not
  1/sqrt(hd)), the KV heads repeated over their query heads;
* "mamba": Mamba-2. z, x, B, C, dt projections; a depthwise causal conv
  of width ``ssm_conv`` on x, B and C, each then SiLU; dt =
  softplus(dt + dt_bias); A = -exp(A_log); the recurrence
  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t + D x_t, run
  one step at a time (not the chunked dual form the port computes);
  then rms(y silu(z)) gn_scale over the whole inner width (one group)
  and the out projection;
* the MoE: the router's logits x W_r over all ``n_experts``, the top
  ``top_k`` of them and a softmax over those (the published form; the
  port's softmax over all experts renormalised over the top k is the
  same number); the chosen experts among the ``held`` this device holds
  (the router's first columns) each add gate x SwiGLU_i(x); the shared
  SwiGLU of width ``n_shared_experts * d_ff`` runs on every token.

Then rms(x) against the unembedding, or, ``tied``, against the
embedding's transpose, divided by ``logits_scaling``. What the absent
experts would add is left out, as on a device that holds a share of an
expert-parallel layer.

Departures from the published model, which the port shares: the conv
has no bias (published: ``mamba_conv_bias`` true); RMSNorm's epsilon is
the port's 1e-6 (published 1e-5); the embedding and the output matrix
are separate leaves of the tree (published: tied; ``tied`` reads the
embedding alone, so a tree whose ``unembed`` is ``embed``'s transpose
is the tied model).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

# the port's RMSNorm epsilon 1e-6 (published rms_norm_eps 1e-5), the
# SwiGLU and the float32 settings of the DeepSeekMoE reference
from .moe_ref import _f32, _rms, strict_fp32, swiglu


def _at(tree: Dict, i: int) -> Dict:
    """Layer ``i`` of a layer-stacked tree."""
    return {k: _at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def attention(cfg, p: Dict, x):
    """Causal NoPE self-attention of x [B, S, D] (wq, wk, wv, wo) at the
    softmax scale ``attention_multiplier`` (1/sqrt(hd) where it is 0)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).view(b, s, h, hd)
    k = (x @ p["wk"]).view(b, s, kv, hd).repeat_interleave(h // kv, dim=2)
    v = (x @ p["wv"]).view(b, s, kv, hd).repeat_interleave(h // kv, dim=2)
    scale = cfg.attention_multiplier or hd ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    prob = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", prob, v).reshape(b, s, h * hd)
    return o @ p["wo"]


def _conv_silu(x, taps):
    """SiLU of the depthwise causal conv of x [B, S, W] with taps [K, W]:
    y_t = sum_i taps[i] x_{t - (K-1) + i}."""
    k, s = taps.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return F.silu(sum(xp[:, i:i + s] * taps[i] for i in range(k)))


def mamba2(cfg, p: Dict, x):
    """The Mamba-2 mixer of x [B, S, D] (module docstring), its recurrence
    one step at a time."""
    b, s, _ = x.shape
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    z = x @ p["wz"]
    xs = _conv_silu(x @ p["wx"], p["conv_x"]).view(b, s, h, pd)
    bm = _conv_silu(x @ p["wB"], p["conv_B"]).view(b, s, g, n)
    cm = _conv_silu(x @ p["wC"], p["conv_C"]).view(b, s, g, n)
    bm = bm.repeat_interleave(h // g, dim=2)
    cm = cm.repeat_interleave(h // g, dim=2)
    dt = F.softplus(x @ p["wdt"] + p["dt_bias"])              # [B, S, H]
    a = -torch.exp(p["A_log"])
    state = torch.zeros((b, h, n, pd), device=x.device)
    ys = []
    for t in range(s):
        state = (state * torch.exp(dt[:, t] * a)[..., None, None]
                 + torch.einsum("bh,bhn,bhp->bhnp", dt[:, t], bm[:, t],
                                xs[:, t]))
        ys.append(torch.einsum("bhn,bhnp->bhp", cm[:, t], state)
                  + p["D"][:, None] * xs[:, t])
    y = torch.stack(ys, dim=1).reshape(b, s, h * pd)
    return _rms(y * F.silu(z), p["gn_scale"]) @ p["wo"]


def moe(cfg, p: Dict, x, held: Optional[int] = None, shared: bool = True):
    """The MoE of x [B, S, D] (module docstring): the routed part of the
    first ``held`` experts (default all that ``p`` holds), plus the shared
    expert if ``shared``."""
    held = p["w1"].shape[0] if held is None else held
    top, idx = torch.topk(x @ p["router"], cfg.top_k, dim=-1)
    gates = torch.softmax(top, dim=-1)
    y = torch.zeros_like(x)
    for j in range(held):
        g = (gates * (idx == j)).sum(-1)        # 0 where not chosen
        y = y + g[..., None] * swiglu(
            {n: p[n][j] for n in ("w1", "w3", "w2")}, x)
    if shared and "shared" in p:
        y = y + swiglu(p["shared"], x)
    return y


def forward(cfg, params: Dict, tokens, held: Optional[int] = None,
            tied: bool = False):
    """tokens [B, S] -> logits [B, S, vocab] in float32 (module
    docstring); ``held`` experts a layer (default all the tree holds);
    ``tied``: the output matrix is the embedding's transpose."""
    strict_fp32()
    w = _f32(params)
    m = cfg.residual_multiplier
    x = w["embed"][tokens.long()] * cfg.embedding_multiplier
    seen = {"mamba": 0, "attention": 0}
    for i, kind in enumerate(cfg.layer_types):
        lp = _at(w["layers"], i)
        j = seen[kind]
        seen[kind] += 1
        h = _rms(x, lp["mixer_norm"])
        if kind == "mamba":
            x = x + m * mamba2(cfg, _at(w["mamba_layers"]["ssm"], j), h)
        else:
            x = x + m * attention(cfg, _at(w["attn_layers"]["attn"], j), h)
        x = x + m * moe(cfg, lp["moe"], _rms(x, lp["ffn_norm"]), held)
    out = w["embed"].T if tied else w["unembed"]
    logits = _rms(x, w["final_norm"]) @ out / cfg.logits_scaling
    return logits[..., :cfg.vocab]
