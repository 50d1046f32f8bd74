"""Named scenarios: ``arch:phase@length`` strings over the model zoo.

Every entry point that accepts a network name (``core.interface.
describe``, ``core.workload.get_network``, ``run.py dse --network``, a
``MappingRequest``) also accepts a *scenario* string:

    deepseek_moe_16b:prefill@2048      # 2048-token prompt, one MoE block
    mamba2_780m:decode@1               # one decode step
    granite_8b_smoke:prefill@64x2      # smoke config, two chained blocks

Grammar: ``<arch>[:phase][@length][xblocks]`` where ``arch`` is a zoo id
(dashes allowed, ``_smoke``/``-smoke`` suffix selects the reduced
same-family smoke config), ``phase`` defaults to ``prefill``, ``length``
is the prompt length (prefill) or KV/context length (decode) and
``blocks`` chains that many tranche blocks. Defaults and the canonical
per-arch names live in ``list_scenarios``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

from ..configs import ARCH_IDS, get_config
from ..core.interface import NetworkDesc
from ..core.workload import LayerSpec
from ..models.common import ModelConfig
from .lowering import PHASES, lower

#: default lengths of scenario names that omit ``@length``
DEFAULT_PREFILL_SEQ = 2048
DEFAULT_DECODE_KV = 1024
SMOKE_PREFILL_SEQ = 64
SMOKE_DECODE_KV = 16

_SCENARIO_RE = re.compile(
    r"^(?P<arch>[A-Za-z][A-Za-z0-9_\-]*?)"
    r"(?::(?P<phase>[a-z]+))?"
    r"(?:@(?P<length>\d+))?"
    r"(?:x(?P<blocks>\d+))?$")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One parsed scenario: which config, which phase, which shapes."""

    arch_id: str                 # resolved zoo id (without _smoke)
    smoke: bool
    phase: str                   # prefill | decode
    length: int                  # seq (prefill) / kv context (decode)
    blocks: int = 1

    @property
    def name(self) -> str:
        """Canonical round-trippable scenario string."""
        suffix = "" if self.blocks == 1 else f"x{self.blocks}"
        arch = self.arch_id + ("_smoke" if self.smoke else "")
        return f"{arch}:{self.phase}@{self.length}{suffix}"

    def config(self) -> ModelConfig:
        """The ``ModelConfig`` this scenario lowers."""
        return get_config(self.arch_id, smoke=self.smoke)


def _resolve_arch(token: str) -> Optional[Tuple[str, bool]]:
    """Zoo id + smoke flag of an arch token, or None if unknown."""
    norm = token.replace("-", "_")
    smoke = norm.endswith("_smoke")
    if smoke:
        norm = norm[:-len("_smoke")]
    return (norm, smoke) if norm in ARCH_IDS else None


def parse_scenario(name: str, *, seq: Optional[int] = None,
                   kv_len: Optional[int] = None,
                   blocks: Optional[int] = None) -> Scenario:
    """Parse ``arch[:phase][@length][xblocks]``; keyword overrides win
    over the string (and fill in omitted parts). Raises ``KeyError`` for
    an unknown arch and ``ValueError`` for a malformed phase/shape."""
    m = _SCENARIO_RE.match(name)
    arch = _resolve_arch(m.group("arch")) if m else None
    if arch is None:
        raise KeyError(f"unknown network/scenario {name!r}; zoo archs: "
                       f"{list(ARCH_IDS)} (grammar: "
                       "'<arch>[:phase][@length][xblocks]')")
    arch_id, smoke = arch
    phase = m.group("phase") or "prefill"
    if phase not in PHASES:
        raise ValueError(f"scenario {name!r}: phase must be one of "
                         f"{PHASES}, got {phase!r}")
    length = int(m.group("length")) if m.group("length") else None
    if phase == "prefill":
        length = seq if seq is not None else length
        if length is None:
            length = SMOKE_PREFILL_SEQ if smoke else DEFAULT_PREFILL_SEQ
    else:
        length = kv_len if kv_len is not None else length
        if length is None:
            length = SMOKE_DECODE_KV if smoke else DEFAULT_DECODE_KV
    n_blocks = blocks if blocks is not None else \
        int(m.group("blocks") or 1)
    if length < 1 or n_blocks < 1:
        raise ValueError(f"scenario {name!r}: length and blocks must be "
                         f">= 1, got {length}/{n_blocks}")
    return Scenario(arch_id=arch_id, smoke=smoke, phase=phase,
                    length=length, blocks=n_blocks)


def is_scenario_name(name: str) -> bool:
    """Cheap syntactic check: does ``name`` parse as a zoo scenario?
    (No layers are built — safe for request validation hot paths.)"""
    try:
        parse_scenario(name)
        return True
    except (KeyError, ValueError):
        return False


def lower_scenario(sc: Scenario) -> Tuple[List[LayerSpec], list]:
    """(layers, edges) of one parsed scenario."""
    cfg = sc.config()
    if sc.phase == "prefill":
        return lower(cfg, "prefill", seq=sc.length, blocks=sc.blocks)
    return lower(cfg, "decode", kv_len=sc.length, blocks=sc.blocks)


def describe_scenario(name: str, **kw) -> NetworkDesc:
    """``core.interface.describe`` backend for scenario names. Accepted
    kwargs: ``seq`` (prefill length), ``kv_len`` (decode context),
    ``blocks`` — anything else raises ``TypeError`` (a typo'd shape
    silently ignored would search the wrong workload)."""
    known = {"seq", "kv_len", "blocks"}
    unknown = sorted(set(kw) - known)
    if unknown:
        raise TypeError(f"describe({name!r}): unexpected kwargs "
                        f"{unknown}; scenarios take {sorted(known)}")
    sc = parse_scenario(name, **{k: kw[k] for k in known if k in kw})
    layers, edges = lower_scenario(sc)
    return NetworkDesc(name=sc.name, layers=layers, edges=edges)


def scenario_layers(name: str) -> List[LayerSpec]:
    """``core.workload.get_network`` backend: layers only."""
    return lower_scenario(parse_scenario(name))[0]


def list_scenarios(smoke: bool = False) -> List[str]:
    """Canonical scenario names — every zoo arch x {prefill, decode} at
    the default lengths (smoke variants at smoke lengths)."""
    pf = SMOKE_PREFILL_SEQ if smoke else DEFAULT_PREFILL_SEQ
    kv = SMOKE_DECODE_KV if smoke else DEFAULT_DECODE_KV
    names = []
    for a in ARCH_IDS:
        arch = a + ("_smoke" if smoke else "")
        names.append(f"{arch}:prefill@{pf}")
        names.append(f"{arch}:decode@{kv}")
    return names
