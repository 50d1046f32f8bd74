"""Prefill and decode step functions per config.

PyTorch counterpart of ``repro.launch.steps`` (serving steps). PyTorch
runs eagerly, so these are plain closures; the reference jits them."""
from __future__ import annotations

from ..models import model_zoo
from ..models.common import ModelConfig


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    def prefill_step(params, batch):
        return model_zoo.prefill(cfg, params, batch["tokens"], max_seq)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache, tokens):
        return model_zoo.decode_step(cfg, params, cache, tokens)
    return serve_step
