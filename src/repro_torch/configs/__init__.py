"""Architecture registry: the 10 assigned configs + input-shape cells.

A data-only copy of ``repro.configs`` for the PyTorch port (the port
imports nothing of the JAX package). Every family is registered; the
port's models run the dense family and raise ``NotImplementedError``
for the others.

Every config cites its public source (see per-file docstrings). Use
``get_config(arch_id)`` for the full config and
``get_config(arch_id, smoke=True)`` for the reduced same-family smoke
config exercised by CPU tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

from ..models.common import ModelConfig

ARCH_IDS = (
    "mamba2_780m",
    "zamba2_1_2b",
    "granite_moe_1b_a400m",
    "deepseek_moe_16b",
    "olmo_1b",
    "phi3_mini_3_8b",
    "stablelm_3b",
    "granite_8b",
    "whisper_base",
    "llava_next_34b",
)

# dashed aliases as listed in the assignment
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

SHAPE_NAMES = tuple(SHAPES)

# long_500k needs sub-quadratic attention: run only for SSM/hybrid archs
# (DESIGN.md Section 4); skips are part of the 40-cell accounting.
_LONG_OK = ("ssm", "hybrid")


def cell_status(arch_id: str, shape: str) -> Tuple[bool, str]:
    cfg = get_config(arch_id)
    if shape == "long_500k" and cfg.family not in _LONG_OK:
        return False, ("skip: full-attention arch — 500k context needs "
                       "sub-quadratic attention (run for ssm/hybrid only)")
    return True, "run"


def cells(include_skipped: bool = False) -> List[Tuple[str, str]]:
    out = []
    for a in ARCH_IDS:
        for s in SHAPE_NAMES:
            ok, _ = cell_status(a, s)
            if ok or include_skipped:
                out.append((a, s))
    return out


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    arch_id = ALIASES.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; have {list(ARCH_IDS)}")
    mod = importlib.import_module(f"{__name__}.{arch_id}")
    return mod.smoke_config() if smoke else mod.config()
