"""Family dispatch: the reference's one API across architectures.

PyTorch counterpart of ``repro.models.model_zoo``: ``audio``
(encoder-decoder) dispatches to ``encdec``, every other family to
``lm``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import encdec, lm, parallel
from .common import ModelConfig, tree_leaves, tree_map

PyTree = Any

# families whose decode step may be captured (``decode_graph_ok``)
GRAPH_FAMILIES = ("dense", "ssm", "hybrid")


def init_params(cfg: ModelConfig, gen: torch.Generator) -> PyTree:
    if cfg.family == "audio":
        return encdec.init_params(cfg, gen)
    return lm.init_params(cfg, gen)


def param_shapes(cfg: ModelConfig) -> PyTree:
    """The parameter tree on the meta device: shapes and dtypes only."""
    if cfg.family == "audio":
        return encdec.param_shapes(cfg)
    return lm.param_shapes(cfg)


def loss_fn(cfg: ModelConfig, params: PyTree, batch: Dict):
    if cfg.family == "audio":
        return encdec.loss_fn(cfg, params, batch)
    return lm.loss_fn(cfg, params, batch)


def forward(cfg: ModelConfig, params: PyTree, batch: Dict):
    if cfg.family == "audio":
        return encdec.forward(cfg, params, batch["tokens"], batch["frames"])
    return lm.forward(cfg, params, batch["tokens"],
                      batch.get("extra_embeds"))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> PyTree:
    if cfg.family == "audio":
        return encdec.init_cache(cfg, batch, max_seq, cfg.enc_frames,
                                 device=device)
    return lm.init_cache(cfg, batch, max_seq, device=device)


def decode_step(cfg: ModelConfig, params: PyTree, cache: PyTree, tokens):
    if cfg.family == "audio":
        return encdec.decode_step(cfg, params, cache, tokens)
    return lm.decode_step(cfg, params, cache, tokens)


def prefill(cfg: ModelConfig, params: PyTree, tokens, max_seq: int,
            frames=None, cache: PyTree = None):
    """(last-position logits, cache). ``frames`` [B, T, D] is the audio
    family's encoder input (``encdec.prefill``: the cross cache primed,
    pos 0) and is refused for the others. ``cache``, an earlier prefill's
    cache of this batch, is filled in place instead of a fresh one
    (``lm.prefill``, ``encdec.prefill``)."""
    if cfg.family == "audio":
        if frames is None:
            raise ValueError(f"{cfg.arch_id}: the audio family's prefill "
                             "needs frames")
        return encdec.prefill(cfg, params, tokens, frames, max_seq, cache)
    if frames is not None:
        raise ValueError(f"{cfg.arch_id}: frames are the audio family's "
                         f"input, not the {cfg.family!r} family's")
    return lm.prefill(cfg, params, tokens, max_seq, cache)


def reads_back(cfg: ModelConfig) -> bool:
    """Whether a decode step of ``cfg`` waits on the card for a host read:
    a feed-forward that is the dropless MoE, which reads its experts' row
    counts (``mlp._moe_dropless``), in any family."""
    return bool(cfg.n_experts) and cfg.moe_impl == "dropless"


def decode_graph_ok(cfg: ModelConfig, params: PyTree) -> bool:
    """Whether ``decode_step`` of ``cfg`` on ``params`` can be captured as
    one CUDA graph and replayed: with grad off, on CUDA parameters of
    which none is a DTensor, for a step that reads nothing back to the
    host (``reads_back``) of a family in ``GRAPH_FAMILIES`` (the audio,
    vlm and gather-MoE families are left eager)."""
    if (cfg.family not in GRAPH_FAMILIES or reads_back(cfg)
            or torch.is_grad_enabled()):
        return False
    return all(not parallel.is_dtensor(t) and t.is_cuda
               for t in tree_leaves(params))


def active_params_count(cfg: ModelConfig, params: PyTree) -> int:
    """Parameters one token runs through (``repro/launch/dryrun.py::
    _active_params``): all of them, less the routed experts' w1/w3/w2
    except their top_k / n_experts share (of the experts held, where a
    device holds ``experts_held`` of them). A shared expert runs for every
    token and counts in full (the reference's rule scales it too: its
    path also holds "moe")."""
    sizes = {}
    tree_map(lambda path, t: sizes.__setitem__(path, t.numel()), params)
    total = sum(sizes.values())
    if not cfg.n_experts:
        return total
    expert = sum(n for path, n in sizes.items()
                 if path.split("/")[-2:] in (["moe", "w1"], ["moe", "w2"],
                                             ["moe", "w3"]))
    return total - expert + expert * cfg.top_k // cfg.n_experts
