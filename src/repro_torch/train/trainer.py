"""Fault-tolerant training loop on one device.

PyTorch counterpart of ``repro.train.trainer``: ``TrainerConfig`` has the
same fields, and ``Trainer`` the same loop: the train step on the
synthetic stream, checkpoint every ``ckpt_every`` steps and at the end
(pruned to ``keep_ckpts``), auto-resume from the newest valid checkpoint,
a per-step straggler deadline that logs, and a failure-injection hook
for the tests. One device and no mesh: the mesh, the ZeRO specs of the
optimizer state and the elastic re-mesh on restore wait for the
multi-GPU slice (ROADMAP Queue 1, Slice E). The trainer runs on
``device`` ("cuda" unless the caller asks for "cpu") and never falls
back to the CPU.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.synthetic import DataConfig, SyntheticStream
from ..launch import steps as steps_lib
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
                 dcfg: Optional[DataConfig] = None, device="cuda"):
        self.cfg = cfg
        self.opt_cfg = opt_cfg or OptimizerConfig()
        self.tcfg = tcfg or TrainerConfig()
        self.dcfg = dcfg or DataConfig()
        self.device = resolve_device(device)
        self.stream = SyntheticStream(cfg, self.dcfg)
        self.step = 0
        self.metrics_history: list = []
        self.step_seconds: list = []
        self.final_state = None
        self.train_step = steps_lib.make_train_step(cfg, self.opt_cfg)

    def init_state(self):
        """(params, opt_state): random params from ``tcfg.seed`` on the
        trainer's device, zero moments."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = model_zoo.init_params(self.cfg, gen)
        return params, init_opt_state(params)

    # -- checkpointing --------------------------------------------------------

    def maybe_restore(self, templates=None):
        """(params, opt_state) of the newest valid checkpoint in
        ``tcfg.ckpt_dir``, on the trainer's device, with ``self.step`` set
        to its step; or None. ``templates`` is a (params, opt_state) pair
        whose structure and shapes the checkpoint must have (default: a
        fresh ``init_state``)."""
        if not self.tcfg.ckpt_dir:
            return None
        params, opt_state = templates or self.init_state()
        res = ckpt_lib.restore(self.tcfg.ckpt_dir,
                               {"params": params, "opt": opt_state},
                               device=self.device)
        if res is None:
            return None
        step, trees, meta = res
        self.step = step
        log.info("restored step %d (saved on %s, arch %s)", step,
                 meta.get("device"), meta.get("arch"))
        return trees["params"], trees["opt"]

    def save(self, params, opt_state):
        if not self.tcfg.ckpt_dir:
            return
        ckpt_lib.save(self.tcfg.ckpt_dir, self.step,
                      {"params": params, "opt": opt_state},
                      meta={"device": str(self.device),
                            "arch": self.cfg.arch_id})
        ckpt_lib.prune(self.tcfg.ckpt_dir, self.tcfg.keep_ckpts)

    # -- loop -----------------------------------------------------------------

    def _device_batch(self, batch_np: Dict[str, np.ndarray]):
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch_np.items()}

    def run(self, fail_at: Optional[int] = None) -> Dict[str, float]:
        """Train to ``tcfg.steps``; ``fail_at`` raises a simulated failure
        at that step (the tests restart the trainer and check the
        resume). Returns the last logged metrics."""
        params, opt_state = self.init_state()
        restored = self.maybe_restore((params, opt_state))
        if restored is not None:
            params, opt_state = restored

        last = None
        while self.step < self.tcfg.steps:
            if fail_at is not None and self.step == fail_at:
                raise RuntimeError(f"injected failure at step {self.step}")
            t0 = time.perf_counter()
            batch = self._device_batch(self.stream.batch_at(self.step))
            params, opt_state, metrics = self.train_step(
                params, opt_state, batch)
            if self.device.type == "cuda":
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
