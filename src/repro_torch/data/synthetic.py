"""Deterministic synthetic token pipeline.

A jax-free copy of ``repro.data.synthetic`` (which loads jax through its
``ModelConfig`` import) taking the port's ``ModelConfig``; the same
numpy draws, so a (seed, step, shard, shard count) gives byte-identical
batches in both packages. Batches are numpy; the trainer moves them to
its device.

Stateless-seeded: batch ``i`` is a pure function of (seed, step, shard),
so any host can regenerate any batch after a failure or a re-shard. The
stream is an order-2 Markov chain over the vocab (not iid uniform), so a
model shows a real, decreasing loss.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from ..models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    batch: int = 8
    seq: int = 256
    markov_states: int = 64


class SyntheticStream:
    """Iterable over training batches; random-access by step."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig,
                 shard: int = 0, n_shards: int = 1):
        self.cfg, self.dcfg = cfg, dcfg
        self.shard, self.n_shards = shard, n_shards
        base = np.random.RandomState(dcfg.seed)
        m = dcfg.markov_states
        # sparse-ish transition structure shared by all shards
        self._trans = base.dirichlet(np.ones(m) * 0.2, size=m)
        self._emit = base.randint(0, cfg.vocab, size=m).astype(np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        d = self.dcfg
        rng = np.random.RandomState(
            (d.seed * 1_000_003 + step * 977 + self.shard) % (2 ** 31))
        b = d.batch // self.n_shards
        m = d.markov_states
        states = rng.randint(0, m, size=b)
        toks = np.empty((b, d.seq + 1), np.int32)
        for t in range(d.seq + 1):
            toks[:, t] = self._emit[states]
            u = rng.random(b)
            cdf = np.cumsum(self._trans[states], axis=1)
            states = (u[:, None] < cdf).argmax(axis=1)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.family == "audio":
            out["frames"] = rng.randn(
                b, self.cfg.enc_frames, self.cfg.d_model).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
