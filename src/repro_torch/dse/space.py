"""Declarative architecture parameter spaces for design-space exploration.

A ``ParamSpace`` is a named family (one of the ``ArchSpec`` factories in
``core.arch``: ``dram_pim``, ``reram_pim``, ``tpu_spatial``) plus ordered
value axes per parameter and validity constraints over joint assignments.
Points are immutable ``DesignPoint``s (canonical sorted param tuples) with
stable content keys, so journals, Pareto payloads and explorer dedup sets
all agree on identity.

Two axes go beyond the factory signatures and are applied on top of the
built spec: ``timing_scale`` multiplies every HBM timing parameter *and*
the pinned per-op PIM latencies (a faster/slower speed bin — energies are
untouched, so the power proxy rises as timing shrinks), and
``target_level`` moves the overlap-analysis level (paper Section IV-H).
A ``word_bits`` axis additionally rescales pinned (16-bit-measured) op
latencies with precision — add ~n, mul ~n^2, the Section IV-C bit-serial
structure — so low precision buys energy *and* speed at the model's
honest exchange rate instead of dominating for free.

Cost proxies (``core.perf_model.arch_area_proxy`` / ``arch_power_proxy``)
are exposed through ``ParamSpace.costs`` so explorers and reports share one
definition of the area/power objectives.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from ..core.arch import ARCH_PRESETS, ArchSpec
from ..core.perf_model import arch_area_proxy, arch_power_proxy

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One assignment of the space's parameters (canonical, hashable)."""

    family: str
    params: Tuple[Tuple[str, object], ...]  # sorted by name

    @staticmethod
    def make(family: str, params: Params) -> "DesignPoint":
        """Canonicalize a params dict into a ``DesignPoint``."""
        return DesignPoint(family, tuple(sorted(params.items())))

    def as_dict(self) -> Params:
        """The point's parameters as a plain dict."""
        return dict(self.params)

    def key(self) -> str:
        """Stable content key (process-independent)."""
        body = ",".join(f"{k}={v}" for k, v in self.params)
        return f"{self.family}({body})"

    def __str__(self) -> str:
        return self.key()


def _scale_precision(arch: ArchSpec, word_bits: int) -> ArchSpec:
    """Rescale *pinned* PIM op latencies for a non-16-bit precision.

    The factories pin measured 16-bit latencies (Fig 6/7); the derived
    AAP model (Section IV-C) says a full add is ``4n+1`` AAPs (~linear in
    n) and a mul is n sequential adds (~quadratic). Without this, low
    precision would get its ~2x energy win at unchanged latency and
    dominate the frontier as a pure modeling artifact."""
    if word_bits == 16:
        return arch
    r = word_bits / 16.0
    scale = {"add": r, "mul": r * r}
    levels = tuple(
        dataclasses.replace(
            lv, pim_ops=None if lv.pim_ops is None
            else {op: ns * scale.get(op, r) for op, ns in
                  lv.pim_ops.items()})
        for lv in arch.levels)
    return dataclasses.replace(arch, levels=levels)


def _scale_timing(arch: ArchSpec, scale: float) -> ArchSpec:
    """Scale every timing parameter and pinned PIM op latency by ``scale``
    (a DRAM speed bin). Energies stay — power = energy/time moves."""
    if scale == 1.0:
        return arch
    t = arch.timing
    timing = dataclasses.replace(
        t, t_rc=t.t_rc * scale, t_rcd=t.t_rcd * scale,
        t_ras=t.t_ras * scale, t_cl=t.t_cl * scale, t_rrd=t.t_rrd * scale,
        t_wr=t.t_wr * scale, t_ccd_s=t.t_ccd_s * scale,
        t_ccd_l=t.t_ccd_l * scale)
    levels = tuple(
        dataclasses.replace(
            lv, pim_ops=None if lv.pim_ops is None
            else {op: ns * scale for op, ns in lv.pim_ops.items()})
        for lv in arch.levels)
    return dataclasses.replace(arch, timing=timing, levels=levels,
                               name=f"{arch.name}_ts{scale:g}")


@dataclasses.dataclass
class ParamSpace:
    """Ordered value axes + validity constraints over one arch family.

    ``axes`` order is the grid-enumeration order (first axis outermost);
    per-axis value order defines mutation neighborhoods (a mutation steps
    to an adjacent value). ``factory_params`` names the axes forwarded to
    the ``ARCH_PRESETS`` factory; the rest are post-build modifiers
    (``timing_scale``, ``target_level``)."""

    family: str
    axes: Dict[str, Tuple]
    constraints: List[Callable[[Params], bool]] = \
        dataclasses.field(default_factory=list)
    defaults: Params = dataclasses.field(default_factory=dict)
    factory_params: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.family not in ARCH_PRESETS:
            raise KeyError(f"unknown arch family {self.family!r}")
        if not self.factory_params:
            self.factory_params = tuple(
                n for n in self.axes if n not in ("timing_scale",
                                                  "target_level"))

    # -- membership ----------------------------------------------------------

    def is_valid(self, params: Params) -> bool:
        """Full assignment, on-axis values, all constraints satisfied."""
        for name, value in params.items():
            if name not in self.axes or value not in self.axes[name]:
                return False
        if set(params) != set(self.axes):
            return False
        return all(c(params) for c in self.constraints)

    def point(self, **params) -> DesignPoint:
        """A validated point: the given params over the defaults
        (raises ``ValueError`` for off-axis or constraint-violating
        assignments)."""
        full = {**self.defaults, **params}
        if not self.is_valid(full):
            raise ValueError(f"invalid point for {self.family}: {full}")
        return DesignPoint.make(self.family, full)

    def default(self) -> DesignPoint:
        """The space's baseline point (the factory-default config)."""
        return self.point()

    @property
    def size(self) -> int:
        """Grid size before constraint filtering."""
        n = 1
        for vals in self.axes.values():
            n *= len(vals)
        return n

    # -- generation ----------------------------------------------------------

    def enumerate(self) -> Iterator[DesignPoint]:
        """All valid points in grid order (first axis outermost)."""
        names = list(self.axes)
        for combo in itertools.product(*(self.axes[n] for n in names)):
            params = dict(zip(names, combo))
            if all(c(params) for c in self.constraints):
                yield DesignPoint.make(self.family, params)

    def sample(self, rng: random.Random, max_tries: int = 256) \
            -> DesignPoint:
        """One uniform-ish valid point (rejection sampling)."""
        for _ in range(max_tries):
            params = {n: rng.choice(vals) for n, vals in self.axes.items()}
            if all(c(params) for c in self.constraints):
                return DesignPoint.make(self.family, params)
        return self.default()

    # -- genetic operators (evolutionary explorer) ---------------------------

    def mutate(self, point: DesignPoint, rng: random.Random,
               max_tries: int = 64) -> DesignPoint:
        """Step one random gene to an adjacent value on its axis (falls
        back to a fresh sample if no valid neighbor is found)."""
        base = point.as_dict()
        for _ in range(max_tries):
            params = dict(base)
            name = rng.choice(list(self.axes))
            vals = self.axes[name]
            if len(vals) == 1:
                continue
            i = vals.index(params[name])
            j = i + rng.choice((-1, 1))
            if not 0 <= j < len(vals):
                j = i - (j - i)
            params[name] = vals[j]
            if params != base and all(c(params) for c in self.constraints):
                return DesignPoint.make(self.family, params)
        return self.sample(rng)

    def crossover(self, a: DesignPoint, b: DesignPoint,
                  rng: random.Random, max_tries: int = 64) -> DesignPoint:
        """Uniform per-gene crossover (falls back to mutation of ``a``)."""
        pa, pb = a.as_dict(), b.as_dict()
        for _ in range(max_tries):
            params = {n: (pa if rng.random() < 0.5 else pb)[n]
                      for n in self.axes}
            if all(c(params) for c in self.constraints):
                return DesignPoint.make(self.family, params)
        return self.mutate(a, rng)

    # -- realization ---------------------------------------------------------

    def build(self, point: DesignPoint) -> ArchSpec:
        """Materialize the ``ArchSpec`` for a point."""
        params = point.as_dict()
        factory = ARCH_PRESETS[self.family]
        arch = factory(**{n: params[n] for n in self.factory_params})
        target = params.get("target_level")
        if target is not None and target != arch.target_level:
            arch = dataclasses.replace(arch, target_level=target)
        if "word_bits" in params:
            arch = _scale_precision(arch, params["word_bits"])
        arch = _scale_timing(arch, params.get("timing_scale", 1.0))
        return arch

    def costs(self, point: DesignPoint) -> Dict[str, float]:
        """Static (mapping-independent) cost proxies of a point."""
        arch = self.build(point)
        return {"area_mm2": arch_area_proxy(arch),
                "power_w": arch_power_proxy(arch)}


# ---------------------------------------------------------------------------
# The shipped spaces, one per ArchSpec factory.
# ---------------------------------------------------------------------------

def dram_space() -> ParamSpace:
    """HBM2 DRAM PIM: channel/bank/column allocation, precision, speed
    bin, analysis level. The default point *is* ``dram_pim()``."""
    return ParamSpace(
        family="dram_pim",
        axes={
            "channels_per_layer": (1, 2, 4, 8),
            "banks_per_channel": (2, 4, 8, 16, 32),
            "columns_per_bank": (2048, 4096, 8192, 16384),
            "word_bits": (8, 16),
            "timing_scale": (1.0, 1.25),
            "target_level": ("Bank", "Channel"),
        },
        constraints=[
            # keep the analysis grids (and per-point search cost) bounded
            lambda p: (p["channels_per_layer"] * p["banks_per_channel"]
                       <= 64),
            lambda p: (p["channels_per_layer"] * p["banks_per_channel"]
                       * p["columns_per_bank"] <= 1 << 21),
        ],
        defaults={"channels_per_layer": 2, "banks_per_channel": 8,
                  "columns_per_bank": 8192, "word_bits": 16,
                  "timing_scale": 1.0, "target_level": "Bank"},
    )


def reram_space() -> ParamSpace:
    """FloatPIM-style ReRAM: tile/block/column allocation + precision."""
    return ParamSpace(
        family="reram_pim",
        axes={
            "tiles_per_layer": (1, 2, 4),
            "blocks_per_tile": (8, 16, 32, 64),
            "columns_per_block": (256, 512, 1024),
            "word_bits": (8, 16),
            "timing_scale": (1.0, 1.25),
        },
        constraints=[
            lambda p: p["tiles_per_layer"] * p["blocks_per_tile"] <= 128,
        ],
        defaults={"tiles_per_layer": 2, "blocks_per_tile": 64,
                  "columns_per_block": 1024, "word_bits": 16,
                  "timing_scale": 1.0},
    )


def tpu_space() -> ParamSpace:
    """TPU-like spatial config (adaptation level 3): cores and MXU lanes."""
    return ParamSpace(
        family="tpu_spatial",
        axes={
            "cores": (2, 4, 8, 16),
            "lanes": (64 * 64, 128 * 128),
        },
        defaults={"cores": 8, "lanes": 128 * 128},
    )


SPACES: Dict[str, Callable[[], ParamSpace]] = {
    "dram_pim": dram_space,
    "reram_pim": reram_space,
    "tpu_spatial": tpu_space,
}


def get_space(family: str) -> ParamSpace:
    """The shipped default space of an arch family (``SPACES``)."""
    try:
        return SPACES[family]()
    except KeyError:
        raise KeyError(
            f"unknown space {family!r}; one of {sorted(SPACES)}") from None
