"""Batch construction for tests and serving (host tensors; the audio
family's ``frames`` come with the encoder-decoder slice).

PyTorch counterpart of ``repro.models.inputs``: the same numpy draws,
so a seed gives bit-identical tokens in both packages."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .common import ModelConfig


def make_train_batch(cfg: ModelConfig, batch: int, seq: int,
                     seed: int = 0) -> Dict:
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, size=(batch, seq + 1)).astype(np.int32)
    out = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
           "labels": torch.from_numpy(toks[:, 1:].copy())}
    return out


def make_decode_tokens(cfg: ModelConfig, batch: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(
        rng.randint(0, cfg.vocab, size=(batch,)).astype(np.int32))
