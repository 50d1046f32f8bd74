"""PIM architecture configuration (paper Section IV-B, Fig 6/7, Table I).

A hierarchy of memory levels, top (whole memory) to bottom (columns inside a
bank). Each level has a fanout (instances per parent), word width, optional
read/write bandwidth (bytes per ns), and — at the compute level — PIM op
latencies (ns) for bit-serial add/mul.

The analysis level (paper Section IV-H) is the Bank: data spaces are tracked
per (bank, time-step); column parallelism is folded into the per-step
latency via the performance model.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Level:
    name: str
    fanout: int = 1                 # instances per parent level
    word_bits: int = 16
    read_bw: Optional[float] = None   # bytes / ns
    write_bw: Optional[float] = None
    pim_ops: Optional[Dict[str, float]] = None  # op -> latency ns

    def __hash__(self):
        # the generated hash would choke on the pim_ops dict
        ops = None if self.pim_ops is None \
            else tuple(sorted(self.pim_ops.items()))
        return hash((self.name, self.fanout, self.word_bits,
                     self.read_bw, self.write_bw, ops))

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        if d["pim_ops"] is not None:
            d["pim_ops"] = dict(sorted(d["pim_ops"].items()))
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "Level":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class HBMTiming:
    """Table I — HBM2 timing (ns) and energy (pJ)."""

    t_rc: float = 45.0
    t_rcd: float = 16.0
    t_ras: float = 29.0
    t_cl: float = 16.0
    t_rrd: float = 2.0
    t_wr: float = 16.0
    t_ccd_s: float = 2.0
    t_ccd_l: float = 4.0
    e_act: float = 909.0
    e_pre_gsa: float = 1.51
    e_post_gsa: float = 1.17
    e_io: float = 0.80

    @property
    def t_aap(self) -> float:
        """One activate-activate-precharge (triple-row activation) step."""
        return self.t_rc  # dominant row-cycle time


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """Hierarchical PIM architecture.

    ``levels`` is ordered top -> bottom; ``target_level`` names the level at
    which data spaces / overlap are analyzed (paper: Bank).
    """

    name: str
    levels: Tuple[Level, ...]
    target_level: str = "Bank"
    word_bits: int = 16
    timing: HBMTiming = dataclasses.field(default_factory=HBMTiming)
    host_bus_gbps: float = 256.0  # GB/s host bus connecting HBM stacks

    def __hash__(self):
        return hash(self.to_key())

    def to_dict(self) -> Dict:
        """JSON-safe representation capturing every field (round-trips via
        ``from_dict``)."""
        return {
            "name": self.name,
            "levels": [lv.to_dict() for lv in self.levels],
            "target_level": self.target_level,
            "word_bits": self.word_bits,
            "timing": dataclasses.asdict(self.timing),
            "host_bus_gbps": self.host_bus_gbps,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "ArchSpec":
        return cls(
            name=d["name"],
            levels=tuple(Level.from_dict(lv) for lv in d["levels"]),
            target_level=d["target_level"],
            word_bits=d["word_bits"],
            timing=HBMTiming(**d["timing"]),
            host_bus_gbps=d["host_bus_gbps"],
        )

    @functools.cached_property
    def _key(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    def to_key(self) -> str:
        """Stable content key: equal-content specs — including specs built
        in different processes or round-tripped through ``to_dict`` — share
        the key. Used by the engine's per-arch cache bundles, ``PerfCache``
        and the DSE run journal (``repro_torch.dse.persist``)."""
        return self._key

    def level_index(self, name: str) -> int:
        for i, lv in enumerate(self.levels):
            if lv.name == name:
                return i
        raise KeyError(name)

    @property
    def target_index(self) -> int:
        return self.level_index(self.target_level)

    def instances_at(self, idx: int) -> int:
        """Total instances of level ``idx`` (product of fanouts above)."""
        n = 1
        for lv in self.levels[: idx + 1]:
            n *= lv.fanout
        return n

    @property
    def n_target_instances(self) -> int:
        return self.instances_at(self.target_index)

    @property
    def compute_level(self) -> Level:
        return self.levels[-1]

    @property
    def columns_per_target(self) -> int:
        """Compute lanes under one analysis-level instance."""
        n = 1
        for lv in self.levels[self.target_index + 1:]:
            n *= lv.fanout
        return n

    def op_latency(self, op: str) -> float:
        """Latency (ns) of a PIM op at the compute level.

        Falls back to the derived bit-serial AAP model (paper Section IV-C:
        a full addition is 4n+1 AAP operations; a multiplication is n
        sequential additions) when the config does not pin a latency.
        """
        ops = self.compute_level.pim_ops or {}
        if op in ops:
            return ops[op]
        n = self.word_bits
        add = (4 * n + 1) * self.timing.t_aap
        if op == "add":
            return add
        if op == "mul":
            return n * add
        raise KeyError(op)

    @property
    def word_bytes(self) -> float:
        return self.word_bits / 8.0

    def movement_ns_per_byte(self) -> float:
        """Intra-memory data movement cost via the tightest configured BW."""
        bws = [lv.read_bw for lv in self.levels if lv.read_bw]
        bw = min(bws) if bws else 16.0
        return 1.0 / bw


def dram_pim(channels_per_layer: int = 2, banks_per_channel: int = 8,
             columns_per_bank: int = 8192, word_bits: int = 16) -> ArchSpec:
    """HBM2 DRAM-based bit-serial row-parallel PIM (Fig 6, Table I).

    Default allocation per layer: 2 channels x 8 banks (Section V-A3 /
    Section V-E uses 1/2/4-channel settings).
    """
    levels = (
        Level("DRAM", fanout=1, word_bits=word_bits),
        Level("Channel", fanout=channels_per_layer, word_bits=word_bits,
              read_bw=16.0, write_bw=16.0),
        Level("Bank", fanout=banks_per_channel, word_bits=word_bits,
              read_bw=16.0, write_bw=16.0),
        Level("Column", fanout=columns_per_bank, word_bits=1,
              pim_ops={"add": 196.0, "mul": 980.0}),
    )
    return ArchSpec(name=f"dram_pim_{channels_per_layer}ch", levels=levels,
                    target_level="Bank", word_bits=word_bits)


def reram_pim(tiles_per_layer: int = 2, blocks_per_tile: int = 64,
              columns_per_block: int = 1024, word_bits: int = 16) -> ArchSpec:
    """FloatPIM-style ReRAM digital PIM (Fig 7)."""
    levels = (
        Level("ReRAM", fanout=1, word_bits=word_bits,
              read_bw=1024.0, write_bw=1024.0),
        Level("Tile", fanout=tiles_per_layer, word_bits=word_bits,
              read_bw=16.0, write_bw=16.0),
        Level("Bank", fanout=blocks_per_tile, word_bits=word_bits,
              read_bw=16.0, write_bw=16.0),
        Level("Column", fanout=columns_per_block, word_bits=1,
              pim_ops={"add": 442.0, "mul": 696.0}),
    )
    return ArchSpec(name=f"reram_pim_{tiles_per_layer}t", levels=levels,
                    target_level="Bank", word_bits=word_bits)


def tpu_spatial(cores: int = 8, lanes: int = 128 * 128) -> ArchSpec:
    """A TPU-like spatial config: cores <-> banks, MXU lanes <-> columns.

    Used to let the same overlap mapper emit TPU pipeline-stage schedules
    (DESIGN.md Section 3, adaptation level 3). Latencies model one MXU MAC
    slot rather than bit-serial AAPs.
    """
    levels = (
        Level("Pod", fanout=1),
        Level("Chip", fanout=1, read_bw=819.0, write_bw=819.0),
        Level("Bank", fanout=cores, read_bw=819.0, write_bw=819.0),
        Level("Column", fanout=lanes, word_bits=16,
              pim_ops={"add": 0.00107, "mul": 0.00107}),
    )
    return ArchSpec(name=f"tpu_spatial_{cores}c", levels=levels,
                    target_level="Bank", word_bits=16)


ARCH_PRESETS = {
    "dram_pim": dram_pim,
    "reram_pim": reram_pim,
    "tpu_spatial": tpu_spatial,
}
