"""The system under test, as the benchmark drives it: the port
``repro_torch`` and nothing else of the repository.

The benchmark takes from the program its entry points (``Trainer.run``,
``Engine.generate``), its launch counters and its kernel names. It
hands the program the weights and batches it made itself
(``bench.inputs``): a ``Trainer`` subclass supplies ``init_state`` and
the stream, so the window times the program's loop and not its synthetic
data generator.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.kernels.fused_mlp import ops as mlp_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_opt_state)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

from . import inputs  # noqa: E402
from .reference.model import padded_vocab  # noqa: E402

# the model fields of a configuration file: every ModelConfig field
# under the same name, but the name (``arch_id``, from ``name``) and the
# remat policy (the traffic's ``remat``)
FIELDS = frozenset(f.name for f in dataclasses.fields(ModelConfig)) - {
    "arch_id", "remat_policy"}
# the keys that only the benchmark reads: what the file says of itself,
# and the sizes the reference needs that the program fixes in its code
BENCH_KEYS = frozenset({"name", "source", "reduced", "assumed",
                        "departures", "context_length", "vocab_pad",
                        "norm_eps"})

# (launch counter, function that carries it, attribute)
COUNTERS = {"flash_fwd": (flash_ops.flash_attention, "launches"),
            "flash_bwd": (flash_ops.flash_attention, "bwd_launches"),
            "mlp_fwd": (mlp_ops.fused_mlp, "launches"),
            "mlp_bwd": (mlp_ops.fused_mlp, "bwd_launches"),
            "ssd_fwd": (ssd_ops.ssd_scan, "launches"),
            "ssd_bwd": (ssd_ops.ssd_scan, "bwd_launches")}


def model_config(cfg: dict, traffic: dict) -> ModelConfig:
    """The program's ModelConfig of configuration file ``cfg``: every model
    field the file holds. A key that is neither a model field nor one of
    ``BENCH_KEYS`` is refused, as is a vocabulary padded otherwise than
    the reference pads it."""
    unknown = set(cfg) - FIELDS - BENCH_KEYS
    if unknown:
        raise ValueError(f"{cfg['name']}: keys the program does not take: "
                         f"{sorted(unknown)}")
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg.items() if k in FIELDS}
    if "remat" in traffic:
        kw["remat_policy"] = traffic["remat"]
    mcfg = ModelConfig(arch_id=cfg["name"], **kw)
    if mcfg.padded_vocab != padded_vocab(cfg):
        raise ValueError(f"{cfg['name']}: the program pads the vocabulary "
                         f"to {mcfg.padded_vocab}, the file to "
                         f"{padded_vocab(cfg)}")
    return mcfg


def counters() -> dict:
    """{op: launches so far}; an op whose counter is gone is left out."""
    out = {}
    for op, (fn, attr) in COUNTERS.items():
        if hasattr(fn, attr):
            out[op] = getattr(fn, attr)
    return out


class _Stream:
    """The benchmark's batches, by step (the trainer's stream API)."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.traffic, self.vocab, self.seed = traffic, vocab, seed

    def batch_at(self, step: int):
        return inputs.train_batch(self.traffic, self.vocab, self.seed, step)


class BenchTrainer(Trainer):
    """``Trainer`` on the benchmark's weights and batches. ``run`` may be
    called again with a larger ``tcfg.steps``: it goes on from the state
    the last call ended with."""

    def __init__(self, cfg: dict, traffic: dict, params: dict, seed: int,
                 device):
        o = traffic["optimizer"]
        super().__init__(model_config(cfg, traffic),
                         OptimizerConfig(**o),
                         TrainerConfig(steps=0, seed=seed),
                         device=device)
        self.stream = _Stream(traffic, cfg["vocab"], seed)
        self._params = params

    def init_state(self):
        if self.final_state is not None:
            return self.final_state
        return self._params, init_opt_state(self._params)

    def run_to(self, step: int) -> dict:
        """Train until ``self.step == step``; the last step's metrics."""
        self.tcfg.steps = step
        return self.run()


def engine(cfg: dict, traffic: dict, params: dict, seed: int, device):
    scfg = ServeConfig(max_seq=traffic["prompt"] + traffic["new_tokens"],
                       max_new_tokens=traffic["new_tokens"],
                       temperature=0.0, seed=seed)
    return Engine(model_config(cfg, traffic), params, scfg, device=device)


def train_spans():
    """(owner, attribute, span) the traced training run wraps."""
    return [(steps, "value_and_grad", "value_and_grad"),
            (steps, "adamw_update", "adamw_update")]


def serve_spans(eng):
    return [(eng, "_prefill", "prefill"), (eng, "_decode", "decode")]
