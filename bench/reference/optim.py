"""Plain AdamW with global-norm clipping and a warmup-cosine schedule, in
float32 (Loshchilov and Hutter, arXiv:1711.05101): the update the
benchmark's training cells configure (``bench/traffic/*.json``,
``optimizer``)."""
from __future__ import annotations

import math
from typing import Dict

import torch


def lr_at(opt: dict, step: int) -> float:
    """Learning rate of 1-based ``step``: linear warmup to ``lr`` over
    ``warmup_steps``, then cosine decay to ``min_lr_frac`` x ``lr`` at
    ``total_steps``."""
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(opt["warmup_steps"], 1)
    prog = min(max((step - opt["warmup_steps"]) / max(
        opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    return opt["lr"] * (opt["min_lr_frac"] + (1 - opt["min_lr_frac"])
                        * 0.5 * (1 + math.cos(math.pi * prog)))


class AdamW:
    """State: first and second moments per leaf and the step count."""

    def __init__(self, opt: dict, params: Dict[str, torch.Tensor]):
        self.opt = opt
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.step = 0

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> float:
        """Apply one step in place; returns the clip scale, by which the
        moments received ``grads``."""
        o = self.opt
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads.values()))
        scale = min(1.0, o["clip_norm"] / max(norm, 1e-9))
        self.step += 1
        lr = lr_at(o, self.step)
        bc1 = 1 - o["b1"] ** self.step
        bc2 = 1 - o["b2"] ** self.step
        for k, p in params.items():
            g = grads[k] * scale
            self.m[k].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            self.v[k].mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
            u = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + o["eps"])
            p.sub_(lr * (u + o["weight_decay"] * p))
        return scale
