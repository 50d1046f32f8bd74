"""Fault-tolerant training loop, on one device or on a mesh.

PyTorch counterpart of ``repro.train.trainer``: ``TrainerConfig`` has the
same fields, and ``Trainer`` the same loop: the train step on the
synthetic stream, checkpoint every ``ckpt_every`` steps and at the end
(pruned to ``keep_ckpts``), auto-resume from the newest valid checkpoint,
a per-step straggler deadline that logs, and a failure-injection hook
for the tests. Without a mesh it runs on ``device`` ("cuda" unless the
caller asks for "cpu") and never falls back to the CPU. With a
``mesh`` (``launch.mesh``; its device type is the trainer's device) the
params are DTensors placed by ``param_specs`` of ``param_shapes``, the
AdamW moments by their ZeRO specs (``opt_state_specs``) and each batch
by ``batch_specs``, as the reference's ``_build`` does: every rank draws
the same global batch from the seed and keeps its shard. Checkpoints
hold full tensors (written by rank 0), so one saved on any mesh, or on
none, restores onto another: the elastic re-mesh.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.synthetic import DataConfig, SyntheticStream
from ..launch import sharding
from ..launch import steps as steps_lib
from ..launch.spans import span
from ..models import model_zoo
from ..models.common import ModelConfig
from ..serve.engine import resolve_device
from . import checkpoint as ckpt_lib
from .optimizer import OptimizerConfig, init_opt_state

log = logging.getLogger("repro_torch.trainer")
PyTree = Any


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    step_deadline_s: Optional[float] = None   # straggler mitigation
    seed: int = 0


class Trainer:
    """The training loop (module docstring). ``metrics_history`` holds
    the metrics of every ``log_every``-th step (and the last) as floats,
    with ``"step"``; ``step_seconds`` each step's wall time, taken after
    the card is synchronised (the next step's batch upload waits for the
    card anyway); ``final_state`` the (params, opt_state) that ``run``
    ended with."""

    def __init__(self, cfg: ModelConfig,
                 opt_cfg: Optional[OptimizerConfig] = None,
                 tcfg: Optional[TrainerConfig] = None,
                 dcfg: Optional[DataConfig] = None, device="cuda",
                 mesh=None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg or OptimizerConfig()
        self.tcfg = tcfg or TrainerConfig()
        self.dcfg = dcfg or DataConfig()
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None
                                     else mesh.device_type)
        self.stream = SyntheticStream(cfg, self.dcfg)
        self.step = 0
        self.metrics_history: list = []
        self.step_seconds: list = []
        self.final_state = None
        self._build()

    def _build(self):
        """The train step, and on a mesh the spec trees (the reference's
        ``_build``)."""
        cfg, mesh = self.cfg, self.mesh
        self.train_step = steps_lib.make_train_step(cfg, self.opt_cfg)
        if mesh is None:
            return
        if (cfg.first_dense_layers or cfg.experts_held
                or cfg.moe_impl == "dropless"):
            raise ValueError(
                f"{cfg.arch_id}: leading dense layers, a share of the "
                "experts (experts_held) and moe_impl 'dropless' train on one "
                "device; the mesh trainer has no specs for them")
        pshapes = model_zoo.param_shapes(cfg)
        self.pspecs = sharding.param_specs(pshapes, mesh)
        self.ospecs = sharding.opt_state_specs(self.pspecs, pshapes, mesh)
        self.bspecs = sharding.batch_specs(cfg, self.dcfg.batch, mesh,
                                           "train")

    def init_state(self):
        """(params, opt_state): random params from ``tcfg.seed`` on the
        trainer's device, zero moments; on a mesh, placed by the specs
        (every rank draws the same params and keeps its shards)."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = model_zoo.init_params(self.cfg, gen)
        if self.mesh is None:
            return params, init_opt_state(params)
        params = sharding.distribute(params, self.pspecs, self.mesh)
        return params, init_opt_state(
            params, sharding.spec_placements(self.ospecs, self.mesh))

    # -- checkpointing / elastic restore --------------------------------------

    def maybe_restore(self):
        """(params, opt_state) of the newest valid checkpoint in
        ``tcfg.ckpt_dir``, on the trainer's device (on a mesh, placed by
        the trainer's specs, whatever mesh saved it), with ``self.step``
        set to its step; or None. The checkpoint must have the structure
        and shapes of ``param_shapes`` and its optimizer state."""
        if not self.tcfg.ckpt_dir:
            return None
        templates = {"params": model_zoo.param_shapes(self.cfg),
                     "opt": steps_lib.opt_state_shapes(self.cfg)}
        specs = (None if self.mesh is None
                 else {"params": self.pspecs, "opt": self.ospecs})
        res = ckpt_lib.restore(self.tcfg.ckpt_dir, templates,
                               device=self.device, mesh=self.mesh,
                               specs=specs)
        if res is None:
            return None
        step, trees, meta = res
        self.step = step
        log.info("restored step %d (saved on %s, mesh %s; restored on %s, "
                 "mesh %s; arch %s)", step, meta.get("device"),
                 meta.get("mesh"), self.device, self._mesh_shape(),
                 meta.get("arch"))
        return trees["params"], trees["opt"]

    def _mesh_shape(self):
        return None if self.mesh is None else list(self.mesh.shape)

    def save(self, params, opt_state):
        """Checkpoint (params, opt_state) at ``self.step``; on a mesh every
        rank calls it and rank 0 writes the full tensors."""
        if not self.tcfg.ckpt_dir:
            return
        ckpt_lib.save(self.tcfg.ckpt_dir, self.step,
                      {"params": params, "opt": opt_state},
                      meta={"device": str(self.device),
                            "mesh": self._mesh_shape(),
                            "arch": self.cfg.arch_id})
        if ckpt_lib.is_writer():
            ckpt_lib.prune(self.tcfg.ckpt_dir, self.tcfg.keep_ckpts)

    # -- loop -----------------------------------------------------------------

    def _device_batch(self, batch_np: Dict[str, np.ndarray]):
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in batch_np.items()}
        if self.mesh is None:
            return batch
        return sharding.distribute(batch, self.bspecs, self.mesh)

    def run(self, fail_at: Optional[int] = None) -> Dict[str, float]:
        """Train to ``tcfg.steps``; ``fail_at`` raises a simulated failure
        at that step (the tests restart the trainer and check the
        resume). Returns the last logged metrics."""
        restored = self.maybe_restore()
        params, opt_state = (self.init_state() if restored is None
                             else restored)

        last = None
        while self.step < self.tcfg.steps:
            if fail_at is not None and self.step == fail_at:
                raise RuntimeError(f"injected failure at step {self.step}")
            t0 = time.perf_counter()
            with span("trainer.step"):
                batch = self._device_batch(self.stream.batch_at(self.step))
                params, opt_state, metrics = self.train_step(
                    params, opt_state, batch)
                if self.device.type == "cuda":
                    with span("trainer.sync"):
                        torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.step_seconds.append(dt)
            if self.tcfg.step_deadline_s is not None and \
                    dt > self.tcfg.step_deadline_s:
                log.warning("straggler: step %d took %.2fs (deadline %.2fs)",
                            self.step, dt, self.tcfg.step_deadline_s)
            self.step += 1
            if self.step % self.tcfg.log_every == 0 or \
                    self.step == self.tcfg.steps:
                last = {k: float(v) for k, v in metrics.items()}
                self.metrics_history.append({"step": self.step, **last})
                log.info("step %d: %s", self.step, last)
            if self.tcfg.ckpt_dir and \
                    self.step % self.tcfg.ckpt_every == 0:
                self.save(params, opt_state)
        if self.tcfg.ckpt_dir:
            self.save(params, opt_state)
        self.final_state = (params, opt_state)
        return last or {}
