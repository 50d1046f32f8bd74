"""Train, prefill and decode step functions per config.

PyTorch counterpart of ``repro.launch.steps``. PyTorch runs eagerly, so
these are plain closures; the reference jits them. Train steps take and
return ``(params, opt_state, batch) -> (params, opt_state, metrics)``;
the params and the optimizer state are updated in place
(``train.optimizer.adamw_update``), as the reference's trainer donates
them. The steps run on plain tensors on one device, or on DTensors on a
mesh (params, moments and batch placed by ``launch.sharding``); the
metrics come back as plain scalars, the same on every rank. The
forward, the backward and the optimizer update run in the spans
``trainer.forward``, ``trainer.backward`` and ``trainer.optimizer``
(``launch.spans``); ``value_and_grad`` and ``adamw_update`` are called
through this module's globals, so wrapping them by attribute reaches
every step.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..models import model_zoo
from ..models.common import ModelConfig, tree_get, tree_map
from ..train.optimizer import (OptimizerConfig, adamw_update, fp32_zeros,
                               init_opt_state)
from .sharding import placements
from .spans import span

PyTree = Any


def value_and_grad(cfg: ModelConfig, params: PyTree, batch: Dict
                   ) -> Tuple[torch.Tensor, Dict, PyTree]:
    """(loss, metrics, grads) of ``model_zoo.loss_fn`` at ``params``;
    grads mirror params (a leaf the loss does not read gets zeros, as in
    JAX). Gradients come from ``torch.autograd.grad`` over detached
    leaves, so ``params`` themselves never require grad."""
    leaves = tree_map(lambda _, t: t.detach().requires_grad_(), params)
    paths = []
    tree_map(lambda path, _: paths.append(path), leaves)
    with torch.enable_grad():
        with span("trainer.forward"):
            loss, metrics = model_zoo.loss_fn(cfg, leaves, batch)
        with span("trainer.backward"):
            grads = torch.autograd.grad(
                loss, [tree_get(leaves, p) for p in paths],
                allow_unused=True, materialize_grads=True)
    by_path = dict(zip(paths, grads))
    return (_scalar(loss), {k: _scalar(v) for k, v in metrics.items()},
            tree_map(lambda path, _: by_path[path], leaves))


def _scalar(t):
    """A detached metric, reduced to a plain tensor on a mesh."""
    t = t.detach()
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[OptimizerConfig] = None):
    opt_cfg = opt_cfg or OptimizerConfig()

    def train_step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(cfg, params, batch)
        with span("trainer.optimizer"):
            params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                                 opt_state)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def make_grad_accum_train_step(cfg: ModelConfig, n_micro: int,
                               opt_cfg: Optional[OptimizerConfig] = None,
                               acc_specs: Optional[PyTree] = None):
    """Gradient accumulation over ``n_micro`` micro-batches, as the
    reference's scan: batch leaves are [n_micro, b / n_micro, ...]; fp32
    zero accumulators, to which each micro-batch's gradient is added
    (``accumulate_micro_batch``); the update takes their mean, and
    ``loss`` is the mean of the micro-batch losses.

    ``acc_specs`` (a spec tree mirroring params, ``launch.sharding``)
    places the fp32 accumulators on the params' mesh: each micro-batch's
    gradient is reduced to those placements before it is added, so the
    accumulator is never replicated where the specs shard it (the
    reference observed 162 GiB a device on deepseek_moe_16b without
    them)."""
    opt_cfg = opt_cfg or OptimizerConfig()

    def train_step(params, opt_state, batch):
        gsum = grad_accumulators(params, acc_specs)
        lsum = torch.zeros((), dtype=torch.float32,
                           device=next(iter(batch.values())).device)
        for i in range(n_micro):
            lsum = accumulate_micro_batch(
                cfg, params, gsum, lsum, {k: v[i] for k, v in batch.items()})
        grads = tree_map(lambda _, g: g / n_micro, gsum)
        with span("trainer.optimizer"):
            params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                                 opt_state)
        return params, opt_state, {"loss": lsum / n_micro, **om}

    return train_step


def grad_accumulators(params: PyTree, acc_specs: Optional[PyTree] = None
                      ) -> PyTree:
    """``make_grad_accum_train_step``'s fp32 zero accumulators, placed by
    ``acc_specs`` on the params' mesh when given."""
    where = None
    if acc_specs is not None:
        where = tree_map(lambda path, s: placements(
            s, tree_get(params, path).device_mesh), acc_specs)
    return fp32_zeros(params, where)


def accumulate_micro_batch(cfg: ModelConfig, params: PyTree, gsum: PyTree,
                           lsum, batch: Dict):
    """One micro-batch of ``make_grad_accum_train_step``: its fp32
    gradient, reduced to the accumulators' placements, added into
    ``gsum`` in place; returns ``lsum`` plus its loss."""
    loss, _, grads = value_and_grad(cfg, params, batch)

    def add(path, a):
        g = tree_get(grads, path).float()
        if isinstance(a, DTensor):
            g = g.redistribute(a.device_mesh, a.placements)
        a.add_(g)
    tree_map(add, gsum)
    return lsum + loss


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    def prefill_step(params, batch, cache=None):
        return model_zoo.prefill(cfg, params, batch["tokens"], max_seq,
                                 frames=batch.get("frames"), cache=cache)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache, tokens):
        return model_zoo.decode_step(cfg, params, cache, tokens)
    return serve_step


def opt_state_shapes(cfg: ModelConfig) -> PyTree:
    """The optimizer state of ``model_zoo.param_shapes`` on the meta
    device: shapes and dtypes only."""
    return init_opt_state(model_zoo.param_shapes(cfg))
