"""Whisper-style encoder-decoder backbone (arXiv:2212.04356).

PyTorch counterpart of ``repro.models.encdec``. The conv/mel frontend is
a stub: callers pass precomputed frame embeddings [B, T_enc, D]. The
encoder is bidirectional; decoder layers are (causal self-attention,
cross-attention on the encoder states, MLP). Learned absolute positions,
no RoPE; the MLP is the config's (GELU for whisper, which has no
kernel). Per-layer parameters are stacked on a leading layer axis, as in
the reference, and applied by a Python loop over the layers.

On CUDA tensors every prefill attention runs the flash kernel: the
encoder's non-causal Sq = Skv, the decoder's causal self-attention and
its non-causal cross-attention with Sq != Skv. Decode attention, self and
cross, is torch (``gqa_decode_attend``), as the reference has no kernel
for it.

When autograd records, each encoder and decoder layer is recomputed in
the backward (``lm._remat`` with policy "full"): the reference wraps both
scan bodies in ``jax.checkpoint`` with no policy, whatever
``remat_policy`` says.

Caches are updated in place, as in ``lm``: ``prime_cross_cache`` writes
the cross keys and values into the cache it is given, and
``decode_step`` the self keys and values.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from . import parallel
from .attention import (attend_cache, attention, decode_attention,
                        init_attn, init_kv_cache, init_pos)
from .common import (ModelConfig, apply_norm, dense_init, meta_generator,
                     torch_dtype)
from .lm import (_remat, _run, _stacked, _unstacked, draw_layers,
                 fresh_cache, layer_params, param_requires_grad, residual,
                 token_nll)
from .mlp import init_mlp, mlp

PyTree = Any


def _ones(cfg: ModelConfig, gen: torch.Generator):
    return torch.ones((cfg.d_model,), dtype=torch.float32, device=gen.device)


def _init_enc_layer(cfg: ModelConfig, gen: torch.Generator, dtype) -> Dict:
    return {"attn_norm": _ones(cfg, gen),
            "attn": init_attn(cfg, gen, dtype=dtype),
            "ffn_norm": _ones(cfg, gen),
            "mlp": init_mlp(cfg, gen, dtype=dtype)}


def _init_dec_layer(cfg: ModelConfig, gen: torch.Generator, dtype) -> Dict:
    return {"self_norm": _ones(cfg, gen),
            "self_attn": init_attn(cfg, gen, dtype=dtype),
            "cross_norm": _ones(cfg, gen),
            "cross_attn": init_attn(cfg, gen, dtype=dtype),
            "ffn_norm": _ones(cfg, gen),
            "mlp": init_mlp(cfg, gen, dtype=dtype)}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> PyTree:
    """Random parameters on the generator's device (the reference's tree:
    paths, shapes and dtypes); layers drawn one at a time."""
    dtype = torch_dtype(cfg.param_dtype)
    return {
        "embed": dense_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                            scale=1.0),
        "unembed": dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype),
        "enc_pos": dense_init(gen, cfg.enc_frames, cfg.d_model, dtype,
                              scale=0.02),
        "dec_pos": dense_init(gen, cfg.max_seq, cfg.d_model, dtype,
                              scale=0.02),
        "enc_norm": _ones(cfg, gen),
        "final_norm": _ones(cfg, gen),
        "encoder": draw_layers(cfg.enc_layers,
                               lambda: _init_enc_layer(cfg, gen, dtype)),
        "decoder": draw_layers(cfg.n_layers,
                               lambda: _init_dec_layer(cfg, gen, dtype)),
    }


def param_shapes(cfg: ModelConfig) -> PyTree:
    """The parameter tree on the meta device (``lm.param_shapes``)."""
    return init_params(cfg, meta_generator())


def _layers(cfg: ModelConfig, stack: PyTree, n: int, sublayers, x, remat):
    """Apply ``n`` stacked layers, each as ``sublayers(lp)``, recomputed
    in the backward when ``remat``."""
    for lp in _unstacked(stack, n):
        subs = sublayers(lp)
        x, _ = _remat("full", subs, x) if remat else _run(subs, x)
    return x


def encode(cfg: ModelConfig, params: PyTree, frames) -> torch.Tensor:
    """frames [B, T, D] (stub frontend output) -> encoder states."""
    cdt = torch_dtype(cfg.compute_dtype)
    t = frames.shape[1]
    x = parallel.to_batch(frames.to(cdt)
                          + params["enc_pos"].to(cdt)[None, :t])

    def sublayers(lp):
        return [("mix", residual(cfg, lp["attn_norm"], lambda h: attention(
                    cfg, lp["attn"], h, causal=False), "model.attention")),
                ("mlp", residual(cfg, lp["ffn_norm"], lambda h: mlp(
                    cfg, lp["mlp"], h), "model.mlp"))]

    x = _layers(cfg, params["encoder"], cfg.enc_layers, sublayers, x,
                param_requires_grad(params))
    return apply_norm(cfg, x, params["enc_norm"])


def _decoder(cfg: ModelConfig, params: PyTree, tokens, enc):
    """Teacher-forced decoder stack over the encoder states ``enc`` ->
    final-normed hidden states [B, S, D]."""
    cdt = torch_dtype(cfg.compute_dtype)
    s = tokens.shape[1]
    x = parallel.to_batch(
        parallel.gather_rows(params["embed"], tokens.long()).to(cdt)
        + params["dec_pos"].to(cdt)[None, :s])

    def sublayers(lp):
        return [("mix", residual(cfg, lp["self_norm"], lambda h: attention(
                    cfg, lp["self_attn"], h, causal=True), "model.attention")),
                ("mix", residual(cfg, lp["cross_norm"], lambda h: attention(
                    cfg, lp["cross_attn"], h, causal=False, kv_x=enc),
                    "model.attention")),
                ("mlp", residual(cfg, lp["ffn_norm"], lambda h: mlp(
                    cfg, lp["mlp"], h), "model.mlp"))]

    x = _layers(cfg, params["decoder"], cfg.n_layers, sublayers, x,
                param_requires_grad(params))
    return apply_norm(cfg, x, params["final_norm"])


def _unembed(params: PyTree, x):
    """Logits of every padded-vocab column: like the reference, encdec
    masks no padding (``lm._vocab_mask`` is the decoder-only LMs')."""
    return x @ params["unembed"].to(x.dtype)


def forward(cfg: ModelConfig, params: PyTree, tokens,
            frames) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced decoding: (tokens [B,S], frames [B,T,D]) ->
    (logits [B,S,Vp], aux 0.0 fp32)."""
    x = _decoder(cfg, params, tokens, encode(cfg, params, frames))
    return (_unembed(params, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(cfg: ModelConfig, params: PyTree,
            batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """Cross entropy over every position (``repro/models/encdec.py:
    loss_fn``: no mask, no aux in the loss); returns (ce, {"ce", "aux"})."""
    logits, aux = forward(cfg, params, batch["tokens"], batch["frames"])
    ce = token_nll(logits, batch["labels"]).mean()
    return ce, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, enc_t: int,
               device=None) -> PyTree:
    """Layer-stacked self-attention KV [L, B, max_seq, KV, hd] and
    cross-attention KV [L, B, enc_t, KV, hd] in compute dtype; ``pos`` a
    0-d int32 zero on ``device`` (``init_pos``)."""
    cdt = torch_dtype(cfg.compute_dtype)
    L, kvh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    return {"self": _stacked(init_kv_cache(L * batch, max_seq, kvh, hd, cdt,
                                           device), L, batch),
            "cross": _stacked(init_kv_cache(L * batch, enc_t, kvh, hd, cdt,
                                            device), L, batch),
            "pos": init_pos(device)}


def _write_cross(cfg: ModelConfig, params: PyTree, cache: PyTree, enc):
    """Each decoder layer's cross-attention keys and values of the encoder
    states ``enc`` [B, T, D], written into ``cache["cross"]``."""
    b, t, _ = enc.shape
    cross = cache["cross"]
    if tuple(cross["k"].shape[1:3]) != (b, t):
        raise ValueError(f"cross cache holds {tuple(cross['k'].shape[1:3])} "
                         f"(batch, frames), the encoder gave {(b, t)}")
    for i in range(cfg.n_layers):
        lp = layer_params(params["decoder"], i)["cross_attn"]
        for name in ("k", "v"):
            kv = parallel.splittable(enc @ lp["w" + name].to(enc.dtype),
                                     cfg.n_kv_heads)
            parallel.write(cross[name][i],
                           kv.reshape(b, t, cfg.n_kv_heads, cfg.hd))
    return cache


def prime_cross_cache(cfg: ModelConfig, params: PyTree, cache: PyTree,
                      frames) -> PyTree:
    """Precompute cross-attention K/V from the encoder output."""
    return _write_cross(cfg, params, cache, encode(cfg, params, frames))


def prefill(cfg: ModelConfig, params: PyTree, tokens, frames,
            max_seq: int, cache: PyTree = None) -> Tuple[torch.Tensor,
                                                      PyTree]:
    """The reference's audio prefill (``repro/models/model_zoo.py:56-65``)
    -> (last-position logits [B,Vp], cache), into a fresh cache or into
    ``cache`` (``init_cache``'s layout for this batch and frame count) in
    place. It primes only the cross cache, rewritten whole: ``pos`` is set
    to 0, so decoded tokens do not attend to the prompt (a reference
    decision, copied), and a self-attention slot is written by a decode
    step before it is read, so a reused cache leaks nothing. The
    reference runs the encoder twice (once to prime, once in
    ``forward``); this runs it once and feeds both, the same function of
    the same inputs."""
    enc = encode(cfg, params, frames)
    b = tokens.shape[0]
    if cache is None:
        cache = fresh_cache(cfg, lambda dev: init_cache(
            cfg, b, max_seq, enc.shape[1], device=dev), b, params["embed"])
    _write_cross(cfg, params, cache, enc)
    cache["pos"].fill_(0)
    x = _decoder(cfg, params, tokens, enc)
    return _unembed(params, x[:, -1]), cache


def decode_step(cfg: ModelConfig, params: PyTree, cache: PyTree,
                tokens) -> Tuple[torch.Tensor, PyTree]:
    """tokens [B] -> (logits [B,Vp], the same cache, advanced by one
    position): the self-attention cache is written in place at ``pos``,
    whose ``dec_pos`` row is gathered on its device; cross-attention
    reads every primed encoder frame."""
    cdt = torch_dtype(cfg.compute_dtype)
    pos = cache["pos"]
    x = (parallel.gather_rows(params["embed"], tokens.long()).to(cdt)
         + parallel.gather_rows(params["dec_pos"], pos.view(1).long()).to(
             cdt))[:, None, :]
    b = x.shape[0]
    for i in range(cfg.n_layers):
        lp = layer_params(params["decoder"], i)
        sc = layer_params(cache["self"], i)
        cc = layer_params(cache["cross"], i)
        h = apply_norm(cfg, x, lp["self_norm"])
        y, _ = decode_attention(cfg, lp["self_attn"], h, sc, pos, rope=False)
        x = x + parallel.like(y, x)
        h = apply_norm(cfg, x, lp["cross_norm"])
        q = parallel.splittable(h @ lp["cross_attn"]["wq"].to(x.dtype),
                                cfg.n_heads).reshape(b, 1, cfg.n_heads, cfg.hd)
        y = attend_cache(q, cc["k"], cc["v"], cc["k"].shape[1] - 1)
        x = x + parallel.like(
            y.to(x.dtype) @ lp["cross_attn"]["wo"].to(x.dtype), x)
        h = apply_norm(cfg, x, lp["ffn_norm"])
        x = x + parallel.like(mlp(cfg, lp["mlp"], h), x)
    x = apply_norm(cfg, x, params["final_norm"])
    logits = _unembed(params, x[:, 0])
    pos.add_(1)
    return logits, cache
