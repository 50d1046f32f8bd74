"""Family dispatch: the reference's one API across architectures.

PyTorch counterpart of ``repro.models.model_zoo``. The port runs the
dense, moe, ssm and hybrid families (all in ``lm``);
``lm.require_ported`` raises for the others.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import lm
from .common import ModelConfig, tree_map

PyTree = Any


def init_params(cfg: ModelConfig, gen: torch.Generator) -> PyTree:
    return lm.init_params(cfg, gen)


def loss_fn(cfg: ModelConfig, params: PyTree, batch: Dict):
    return lm.loss_fn(cfg, params, batch)


def forward(cfg: ModelConfig, params: PyTree, batch: Dict):
    return lm.forward(cfg, params, batch["tokens"])


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> PyTree:
    return lm.init_cache(cfg, batch, max_seq, device=device)


def decode_step(cfg: ModelConfig, params: PyTree, cache: PyTree, tokens):
    return lm.decode_step(cfg, params, cache, tokens)


def prefill(cfg: ModelConfig, params: PyTree, tokens, max_seq: int):
    return lm.prefill(cfg, params, tokens, max_seq)


def active_params_count(cfg: ModelConfig, params: PyTree) -> int:
    """Parameters one token runs through (``repro/launch/dryrun.py::
    _active_params``): all of them, less the routed experts' w1/w3/w2
    except their top_k / n_experts share. A shared expert runs for every
    token and counts in full (the reference's rule scales it too: its
    path also holds "moe")."""
    sizes = {}
    tree_map(lambda path, t: sizes.__setitem__(path, t.numel()), params)
    total = sum(sizes.values())
    if cfg.family != "moe":
        return total
    expert = sum(n for path, n in sizes.items()
                 if path.split("/")[-2:] in (["moe", "w1"], ["moe", "w2"],
                                             ["moe", "w3"]))
    return total - expert + expert * cfg.top_k // cfg.n_experts
