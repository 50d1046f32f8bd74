"""Faults planted in the program's timed path, to show that the check
catches them: the tests run each at a small size on the CPU, and
``calibrate.py`` reads them at a cell's own size on the card.

* ``unchanged``: the train step returns its state unchanged.
* ``half_batch``: the train step's loss and gradient over half the
  batch, the mean taken over the rest.
* ``token``: every served token altered where it is sampled.
* ``stale_cache``: each decode step leaves the cache as it found it.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, attr, make):
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def unchanged():
    from . import program

    def make(orig):
        def adamw_update(cfg, params, grads, state):
            zero = torch.zeros((), device=state["step"].device)
            return params, state, {"grad_norm": zero, "lr": zero}
        return adamw_update
    return _patched(program.steps, "adamw_update", make)


def half_batch():
    from . import program

    def make(orig):
        def value_and_grad(cfg, params, batch):
            return orig(cfg, params, {k: v[:v.shape[0] // 2]
                                      for k, v in batch.items()})
        return value_and_grad
    return _patched(program.steps, "value_and_grad", make)


def token():
    from . import program

    def make(orig):
        def _sample(self, logits, gen):
            return (orig(self, logits, gen) + 1) % self.cfg.vocab
        return _sample
    return _patched(program.Engine, "_sample", make)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def stale_cache():
    from . import program

    def make(orig):
        def make_decode_step(cfg):
            step = orig(cfg)

            def serve_step(params, cache, tokens):
                saved = [t.clone() for t in _tensors(cache)]
                logits, _ = step(params, cache, tokens)
                for t, s in zip(_tensors(cache), saved):
                    t.copy_(s)
                return logits, cache
            return serve_step
        return make_decode_step
    return _patched(program.steps, "make_decode_step", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "token": token, "stale_cache": stale_cache}


def of(traffic: dict):
    """The faults a cell of this traffic can have."""
    if traffic["kind"] == "train":
        return ["unchanged", "half_batch"]
    return ["token"] + (["stale_cache"] if traffic["new_tokens"] > 1 else [])
