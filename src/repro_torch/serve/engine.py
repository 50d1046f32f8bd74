"""Batched serving engine: prefill + decode with a fixed-size cache (KV,
Mamba-2 state, or both).

PyTorch counterpart of ``repro.serve.engine``: a request batch is
prefilled (prompt scored, cache primed), then tokens are emitted one
decode step at a time. Greedy or temperature sampling; per-sequence stop
handling via an active mask (finished slots keep decoding but their
tokens are masked out).

The engine runs on ``device`` ("cuda" unless the caller asks for
"cpu"), and never falls back to the CPU. Weight matrices are cast to
the compute dtype once, here, which gives the values the reference's
per-use ``.astype`` gives without streaming fp32 weights at every step.

The engine keeps one cache per (batch, max_seq), the one its first
prefill of that batch made, and prefills every later call into it (a
prefill rewrites what the next decode steps read, so nothing leaks from
call to call). Its ``pos`` is a 0-d int32 on the cache's device, read
there by the decode step and advanced in place. Where
``model_zoo.decode_graph_ok`` allows (CUDA, no grad, no DTensor, the
dense, ssm and hybrid families), each decode step on that cache is
replayed from a CUDA graph of it (``decode_graph.DecodeGraph``, captured
at the first step); the same kernels run in the same order on the same
data, so the tokens are the eager step's, bit for bit. Elsewhere every
step runs eagerly on the same cache. A replay runs no Python of the
model, so it opens no ``model.*`` span.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..launch import spans
from ..launch import steps as steps_lib
from ..launch.spans import span
from ..models import model_zoo
from ..models.common import ModelConfig, keeps_fp32, torch_dtype, tree_map
from .decode_graph import COUNTER, DecodeGraph

PyTree = Any


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 512
    max_new_tokens: int = 32
    temperature: float = 0.0       # 0 => greedy
    eos_id: Optional[int] = None
    seed: int = 0


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA without a GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA requested but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    return dev


class Engine:
    """Batched LM inference: prefill + single-token decode loop with
    greedy or temperature sampling (module docstring)."""

    def __init__(self, cfg: ModelConfig, params: PyTree,
                 scfg: Optional[ServeConfig] = None, device="cuda"):
        self.cfg = cfg
        self.scfg = scfg or ServeConfig()
        self.device = resolve_device(device)
        cdt = torch_dtype(cfg.compute_dtype)
        # the reference's fp32 leaves stay fp32 (``keeps_fp32``); every
        # weight matrix goes to compute dtype
        self.params = tree_map(
            lambda path, t: t.to(self.device, torch.float32
                                 if keeps_fp32(path) else cdt), params)
        self._prefill = steps_lib.make_prefill_step(cfg, self.scfg.max_seq)
        self._step = steps_lib.make_decode_step(cfg)
        self._caches = {}       # (batch, max_seq) -> the kept cache
        self._graphs = {}       # (batch, max_seq) -> DecodeGraph or None

    def batch(self, prompts: np.ndarray,
              frames: Optional[np.ndarray] = None) -> dict:
        """The prefill batch on the engine's device: tokens, and the audio
        family's encoder frames [B, T, D] when given (``model_zoo.prefill``
        decides which family needs them)."""
        out = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32),
                                         device=self.device)}
        if frames is not None:
            out["frames"] = torch.as_tensor(np.asarray(frames),
                                            device=self.device)
        return out

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray,
                 frames: Optional[np.ndarray] = None) -> np.ndarray:
        """prompts [B, S_prompt] int32 (and, for the audio family, frames
        [B, T, D]) -> [B, max_new_tokens].

        Spans (``launch.spans``): the call in ``engine.generate``; from its
        start until the first sampled token is on the host in
        ``engine.first_token``; each ``_prefill`` and ``_decode`` call in
        ``engine.prefill`` and ``engine.decode``, each sampling in
        ``engine.sample``, each wait for a token in ``engine.readback``.
        Counter ``engine.decode_graph``: [replays, captures, eager steps]
        of the decode steps (``_decode``)."""
        scfg = self.scfg
        b, s = prompts.shape
        if s + scfg.max_new_tokens > scfg.max_seq:
            raise ValueError(
                f"prompt {s} + {scfg.max_new_tokens} new tokens exceeds "
                f"max_seq {scfg.max_seq}")
        key = (b, scfg.max_seq)
        with span("engine.generate"), contextlib.ExitStack() as first:
            first.enter_context(span("engine.first_token"))
            with span("engine.prefill"):
                logits, cache = self._prefill(
                    self.params, self.batch(prompts, frames),
                    cache=self._caches.get(key))
            self._caches[key] = cache

            gen = torch.Generator(device=self.device).manual_seed(scfg.seed)
            out = np.zeros((b, scfg.max_new_tokens), np.int32)
            done = np.zeros((b,), bool)
            with span("engine.sample"):
                tok = self._sample(logits, gen)
            for i in range(scfg.max_new_tokens):
                with span("engine.readback"):
                    host = tok.cpu().numpy()
                if i == 0:
                    first.close()
                out[:, i] = np.where(done, scfg.eos_id or 0, host)
                if scfg.eos_id is not None:
                    done |= host == scfg.eos_id
                    if done.all():
                        break
                with span("engine.decode"):
                    logits, cache = self._decode(self.params, cache, tok)
                with span("engine.sample"):
                    tok = self._sample(logits, gen)
        return out

    def _decode(self, params, cache, tok):
        """One decode step on ``cache``, the one ``_prefill`` returned for
        this batch -> (logits, cache): replayed from the batch's decode
        graph (captured at its first step) where
        ``model_zoo.decode_graph_ok`` holds, else run eagerly."""
        key = (tok.shape[0], self.scfg.max_seq)
        if key not in self._graphs:
            self._graphs[key] = (
                DecodeGraph(self._step, params, cache)
                if model_zoo.decode_graph_ok(self.cfg, params) else None)
        graph = self._graphs[key]
        if graph is None:
            spans.count(COUNTER, [0, 0, 1])
            return self._step(params, cache, tok)
        return graph(tok)

    def _sample(self, logits, gen: torch.Generator):
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            torch.int32)
