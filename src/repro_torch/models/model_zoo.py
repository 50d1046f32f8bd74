"""Family dispatch: the reference's one API across architectures.

PyTorch counterpart of ``repro.models.model_zoo``. The port runs the
dense family (``lm``); ``lm.require_dense`` raises for the others.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import lm
from .common import ModelConfig

PyTree = Any


def init_params(cfg: ModelConfig, gen: torch.Generator) -> PyTree:
    return lm.init_params(cfg, gen)


def forward(cfg: ModelConfig, params: PyTree, batch: Dict):
    return lm.forward(cfg, params, batch["tokens"])


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> PyTree:
    return lm.init_cache(cfg, batch, max_seq, device=device)


def decode_step(cfg: ModelConfig, params: PyTree, cache: PyTree, tokens):
    return lm.decode_step(cfg, params, cache, tokens)


def prefill(cfg: ModelConfig, params: PyTree, tokens, max_seq: int):
    return lm.prefill(cfg, params, tokens, max_seq)
