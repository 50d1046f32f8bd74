"""Batched serving engine: prefill + decode with a fixed-size KV cache.

PyTorch counterpart of ``repro.serve.engine``: a request batch is
prefilled (prompt scored, cache primed), then tokens are emitted one
decode step at a time. Greedy or temperature sampling; per-sequence stop
handling via an active mask (finished slots keep decoding but their
tokens are masked out).

The engine runs on ``device`` ("cuda" unless the caller asks for
"cpu"), and never falls back to the CPU. Weight matrices are cast to
the compute dtype once, here, which gives the values the reference's
per-use ``.astype`` gives without streaming fp32 weights at every step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..launch import steps as steps_lib
from ..models.common import ModelConfig, torch_dtype, tree_map

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
        # norm scales stay fp32; every weight matrix goes to compute dtype
        self.params = tree_map(
            lambda path, t: t.to(self.device,
                                 torch.float32 if "norm" in path else cdt),
            params)
        self._prefill = steps_lib.make_prefill_step(cfg, self.scfg.max_seq)
        self._decode = steps_lib.make_decode_step(cfg)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray) -> np.ndarray:
        """prompts [B, S_prompt] int32 -> [B, max_new_tokens]."""
        scfg = self.scfg
        b, s = prompts.shape
        if s + scfg.max_new_tokens > scfg.max_seq:
            raise ValueError(
                f"prompt {s} + {scfg.max_new_tokens} new tokens exceeds "
                f"max_seq {scfg.max_seq}")
        tokens = torch.as_tensor(np.asarray(prompts, np.int32),
                                 device=self.device)
        logits, cache = self._prefill(self.params, {"tokens": tokens})

        gen = torch.Generator(device=self.device).manual_seed(scfg.seed)
        out = np.zeros((b, scfg.max_new_tokens), np.int32)
        done = np.zeros((b,), bool)
        tok = self._sample(logits, gen)
        for i in range(scfg.max_new_tokens):
            host = tok.cpu().numpy()
            out[:, i] = np.where(done, scfg.eos_id or 0, host)
            if scfg.eos_id is not None:
                done |= host == scfg.eos_id
                if done.all():
                    break
            logits, cache = self._decode(self.params, cache, tok)
            tok = self._sample(logits, gen)
        return out

    def _sample(self, logits, gen: torch.Generator):
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            torch.int32)
