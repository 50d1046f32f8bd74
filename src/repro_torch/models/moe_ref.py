"""Plain float32 reference of DeepSeekMoE (arXiv:2401.06066; the 16B
model's ``config.json`` on the Hugging Face hub,
deepseek-ai/deepseek-moe-16b-base), for the port's CPU tests.

Written from the paper and the published config in plain PyTorch: no
kernel of the port, no cache, no dispatch tables, nothing of JAX. Every
matrix product is float32 with TF32 off (``strict_fp32``). It reads the
port's parameter tree in its leading-dense layout (``models/lm.py``):
``layers`` (attention and norms, stacked over every layer),
``dense_layers`` (``mlp``) and ``moe_layers`` (``moe``).

A layer is x + attn(rms(x)), then x + ffn(rms(x)): causal multi-head
attention with rotary positions on the two halves of each head; the
first ``first_dense_layers`` ffns a SwiGLU of width ``dense_d_ff``, the
others the MoE:

* gates s = softmax(x W_r) over all ``n_experts``;
* the top ``top_k`` of them, renormalised only if ``moe_norm_topk``
  (DeepSeekMoE: not);
* y = sum over the chosen experts i that this device holds of
  s_i SwiGLU_i(x), plus the shared expert SwiGLU(x) of width
  ``n_shared_experts * d_ff``; no capacity, so no choice is dropped;
* the sequence-level balance loss coef x mean_b sum_e f_be P_be, with
  f_be = (choices of e in sequence b) E / (k S) and
  P_be = mean_t s_bte, summed over the MoE layers.

The held experts are the router's first ``held`` (the argument; the
weights [held, ...] are those experts'; another device's share is a
permutation of the router's columns): what the absent ones would add is
left out, as on a device that holds a share of an expert-parallel
layer. The loss is the mean next-token cross entropy over the real
vocabulary plus the balance loss.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-6          # RMSNorm epsilon (config.json: rms_norm_eps)


def strict_fp32():
    """Float32 products stay float32 on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def _rms(x, scale):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * scale


def _rope(x, theta: float):
    """x [B, S, H, hd]: rotate the two halves of each head by position x
    theta^(-2i/hd)."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32) / hd)
    ang = torch.arange(s, dtype=torch.float32)[:, None] * inv
    c, sn = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1)


def attention(cfg, p: Dict, x):
    """Causal self-attention of x [B, S, D] (wq, wk, wv, wo)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _rope((x @ p["wq"]).view(b, s, h, hd), cfg.rope_theta)
    k = _rope((x @ p["wk"]).view(b, s, kv, hd), cfg.rope_theta)
    v = (x @ p["wv"]).view(b, s, kv, hd)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    mask = torch.ones((s, s), dtype=torch.bool).tril()
    prob = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", prob, v).reshape(b, s, h * hd)
    return o @ p["wo"]


def swiglu(p: Dict, x):
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]


def moe_layer(cfg, p: Dict, x, held: Optional[int] = None,
              shared: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE ffn of x [B, S, D] (module docstring) -> (y, balance
    loss): the routed part of the first ``held`` experts (default all
    that ``p`` holds), plus the shared expert if ``shared``."""
    e, k = cfg.n_experts, cfg.top_k
    held = p["w1"].shape[0] if held is None else held
    b, s, _ = x.shape
    probs = torch.softmax(x @ p["router"], dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    if cfg.moe_norm_topk:
        gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for j in range(held):
        g = (gates * (idx == j)).sum(-1)        # 0 where not chosen
        y = y + g[..., None] * swiglu(
            {n: p[n][j] for n in ("w1", "w3", "w2")}, x)
    if shared and "shared" in p:
        y = y + swiglu(p["shared"], x)
    f = F.one_hot(idx, e).sum(dim=(1, 2)).float() * e / (k * s)
    aux = (f * probs.mean(dim=1)).sum(-1).mean() * cfg.router_aux_coef
    return y, aux


def forward(cfg, params: Dict, tokens, held: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, vocab], the balance loss summed
    over the MoE layers), in float32."""
    strict_fp32()
    w = _f32(params)
    nd = cfg.first_dense_layers
    x = w["embed"][tokens.long()]
    aux = torch.zeros(())
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in w["layers"].items() if k != "attn"}
        attn = {k: v[i] for k, v in w["layers"]["attn"].items()}
        x = x + attention(cfg, attn, _rms(x, lp["attn_norm"]))
        h = _rms(x, lp["ffn_norm"])
        if i < nd:
            x = x + swiglu({k: v[i] for k, v in
                            w["dense_layers"]["mlp"].items()}, h)
        else:
            mp = w["moe_layers"]["moe"]
            pi = {k: (v[i - nd] if k != "shared" else
                      {n: t[i - nd] for n, t in v.items()})
                  for k, v in mp.items()}
            y, a = moe_layer(cfg, pi, h, held)
            x, aux = x + y, aux + a
    logits = _rms(x, w["final_norm"]) @ w["unembed"]
    return logits[..., :cfg.vocab], aux


def loss(cfg, params: Dict, batch: Dict, held: Optional[int] = None):
    """(cross entropy + balance loss, cross entropy, balance loss) of
    batch tokens and labels [B, S]."""
    logits, aux = forward(cfg, params, batch["tokens"], held)
    labels = batch["labels"].long()
    ce = (torch.logsumexp(logits, -1)
          - logits.gather(-1, labels[..., None])[..., 0]).mean()
    return ce + aux, ce, aux
