"""Decoder-only language model, dense family.

PyTorch counterpart of ``repro.models.lm`` for ``family == "dense"``
(GQA attention with RoPE, RMSNorm or non-parametric LayerNorm, SwiGLU or
GELU). Per-layer parameters are stacked on a leading layer axis, as in
the reference, and applied by a Python loop over the layers. The other
families raise ``NotImplementedError`` naming the ROADMAP slice that
ports them.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .attention import (attention, decode_attention, init_attn,
                        init_kv_cache, prefill_into_cache)
from .common import (ModelConfig, apply_norm, dense_init, torch_dtype,
                     tree_map)
from .mlp import init_mlp, mlp

PyTree = Any

_LATER_SLICE = {
    "ssm": "Slice C (SSM)", "hybrid": "Slice C (hybrid)",
    "moe": "Slice D (MoE)", "audio": "Slice D (encoder-decoder)",
    "vlm": "Slice D (VLM)",
}


def require_dense(cfg: ModelConfig) -> None:
    """Raise for a family the port does not run yet."""
    if cfg.family != "dense":
        where = _LATER_SLICE.get(cfg.family, "no slice")
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family!r} family is not ported to "
            f"PyTorch yet (ROADMAP Queue 1, {where})")


def layer_params(layers: PyTree, i: int) -> PyTree:
    """Views of layer ``i`` of a layer-stacked tree (no copy)."""
    return tree_map(lambda _, t: t[i], layers)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(cfg: ModelConfig, gen: torch.Generator, dtype) -> Dict:
    ones = torch.ones((cfg.d_model,), dtype=torch.float32, device=gen.device)
    return {"attn_norm": ones, "attn": init_attn(cfg, gen, dtype=dtype),
            "ffn_norm": ones.clone(), "mlp": init_mlp(cfg, gen, dtype=dtype)}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> PyTree:
    """Random parameters on the generator's device. Layers are drawn one
    at a time into the stacked tensors, so the float32 draws stay one
    layer in size."""
    require_dense(cfg)
    dtype = torch_dtype(cfg.param_dtype)
    params = {
        "embed": dense_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                            scale=1.0),
        "unembed": dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=gen.device),
    }
    layers = None
    for i in range(cfg.n_layers):
        lp = _init_layer(cfg, gen, dtype)
        if layers is None:
            layers = tree_map(lambda _, t: t.new_empty((cfg.n_layers,
                                                        *t.shape)), lp)
        tree_map(lambda path, t: _leaf(layers, path)[i].copy_(t), lp)
    params["layers"] = layers
    return params


def _leaf(tree: PyTree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


# ---------------------------------------------------------------------------
# Forward (scoring)
# ---------------------------------------------------------------------------

def _vocab_mask(cfg: ModelConfig, logits):
    if cfg.padded_vocab == cfg.vocab:
        return logits
    mask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
    return logits.masked_fill(~mask, -1e9)


def _embed(cfg: ModelConfig, params: PyTree, tokens):
    return params["embed"][tokens.long()].to(torch_dtype(cfg.compute_dtype))


def _unembed(cfg: ModelConfig, params: PyTree, x):
    x = apply_norm(cfg, x, params["final_norm"])
    logits = x @ params["unembed"].to(x.dtype)
    return _vocab_mask(cfg, logits)


def forward(cfg: ModelConfig, params: PyTree,
            tokens) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S] -> (logits [B,S,Vp], aux_loss scalar)."""
    require_dense(cfg)
    x = _embed(cfg, params, tokens)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h = apply_norm(cfg, x, lp["attn_norm"])
        x = x + attention(cfg, lp["attn"], h, causal=True)
        h = apply_norm(cfg, x, lp["ffn_norm"])
        x = x + mlp(cfg, lp["mlp"], h)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _unembed(cfg, params, x), aux


# ---------------------------------------------------------------------------
# KV cache + prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> PyTree:
    """Layer-stacked KV cache [L, B, max_seq, KV, hd] in compute dtype."""
    require_dense(cfg)
    # one allocation for all layers, viewed as [L, B, ...]
    kv = init_kv_cache(cfg.n_layers * batch, max_seq, cfg.n_kv_heads,
                       cfg.hd, torch_dtype(cfg.compute_dtype), device)
    return {"layers": tree_map(lambda _, t: t.view(cfg.n_layers, batch,
                                                   *t.shape[1:]), kv),
            "pos": 0}


def prefill(cfg: ModelConfig, params: PyTree, tokens,
            max_seq: int) -> Tuple[torch.Tensor, PyTree]:
    """Prefill a prompt into a fresh cache; returns (last logits, cache)."""
    require_dense(cfg)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_seq, device=params["embed"].device)
    x = _embed(cfg, params, tokens)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        lc = layer_params(cache["layers"], i)
        h = apply_norm(cfg, x, lp["attn_norm"])
        y, _ = prefill_into_cache(cfg, lp["attn"], h, lc)
        x = x + y
        h = apply_norm(cfg, x, lp["ffn_norm"])
        x = x + mlp(cfg, lp["mlp"], h)
    cache["pos"] = s
    return _unembed(cfg, params, x[:, -1:, :])[:, 0, :], cache


def decode_step(cfg: ModelConfig, params: PyTree, cache: PyTree,
                tokens) -> Tuple[torch.Tensor, PyTree]:
    """tokens [B] -> (logits [B,Vp], cache advanced by one position). One
    token for the whole batch; the cache tensors are written in place."""
    require_dense(cfg)
    pos = cache["pos"]
    x = _embed(cfg, params, tokens)[:, None, :]
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        lc = layer_params(cache["layers"], i)
        h = apply_norm(cfg, x, lp["attn_norm"])
        y, _ = decode_attention(cfg, lp["attn"], h, lc, pos)
        x = x + y
        h = apply_norm(cfg, x, lp["ffn_norm"])
        x = x + mlp(cfg, lp["mlp"], h)
    logits = _unembed(cfg, params, x)[:, 0, :]
    return logits, {"layers": cache["layers"], "pos": pos + 1}
