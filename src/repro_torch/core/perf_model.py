"""PIM performance model (paper Section IV-C, Table I).

Timeloop's model counts compute/read/write only; PIM needs the data
movements of in-memory execution. Each MAC in a bank is modeled as
(1) bit-serial element-wise multiplication, (2) read/write for operand
transposition, (3) serial additions for reduction. A full n-bit addition is
4n+1 activate-activate-precharge (AAP) operations; a multiplication is n
sequential additions (Section IV-C). Configured architectures may pin
add/mul latencies directly (Fig 6: DRAM add=196ns mul=980ns; Fig 7 ReRAM
add=442ns mul=696ns) — the AAP-derived model is the fallback.
"""
from __future__ import annotations

import dataclasses
import math

from .arch import ArchSpec
from .mapping import Mapping
from .workload import OUTPUT_DIMS, REDUCTION_DIMS


@dataclasses.dataclass(frozen=True)
class LayerPerf:
    """Latency/energy decomposition of one mapping (no overlap).

    ``energy_pj`` is the mapping-invariant base energy
    (``compute_energy_pj + io_energy_pj``); the mapping-*dependent*
    movement energy of transform-relocated tiles lives on the schedule
    result (``TransformResult.move_energy_pj`` / ``LayerResult``), fed by
    ``tile_bytes`` and ``move_pj_per_byte`` here (DESIGN.md Section 9).
    """

    step_ns: float          # latency of one bank time step
    n_steps: int
    n_banks: int
    compute_ns: float       # n_steps * step_ns
    output_move_ns: float   # write outputs to next layer's input region
    tile_move_ns: float     # movement of a single (bank, step) output tile
    sequential_ns: float    # compute + output movement
    energy_pj: float        # compute_energy_pj + io_energy_pj
    compute_energy_pj: float = 0.0  # bit-serial AAP MACs
    io_energy_pj: float = 0.0       # output write-out through the links
    tile_bytes: float = 0.0         # footprint of one (bank, step) tile
    move_pj_per_byte: float = 0.0   # link energy per relocated byte

    @property
    def total_ns(self) -> float:
        return self.sequential_ns


def step_latency_ns(mapping: Mapping) -> float:
    arch = mapping.arch
    t_add = arch.op_latency("add")
    t_mul = arch.op_latency("mul")
    timing = arch.timing

    macs_step = mapping.macs_per_step()
    cols = mapping.n_columns_used
    macs_per_col = math.ceil(macs_step / cols)

    # (1)+(3): bit-serial multiply + accumulate-add per MAC
    mac_ns = t_mul + t_add
    # (2): operand transposition — one row read + one row write per MAC
    t_rw = timing.t_rcd + timing.t_cl
    # cross-column partial-sum reduction (spatial reduction loops at target)
    n_red = 1
    out_cols = 1
    ti = arch.target_index
    for li, lp in mapping.nest:
        if li == ti and lp.spatial:
            if lp.dim in REDUCTION_DIMS:
                n_red *= lp.size
            else:
                out_cols *= lp.size
    red_ns = 0.0
    if n_red > 1:
        ext = mapping.tile_extent
        out_elems = 1
        for d in OUTPUT_DIMS:
            out_elems *= ext[d]
        out_per_col = math.ceil(out_elems / out_cols)
        move_word = arch.word_bytes * arch.movement_ns_per_byte()
        red_ns = math.ceil(math.log2(n_red)) * out_per_col * (
            move_word + t_add)
    return macs_per_col * (mac_ns + 2 * t_rw) + red_ns


def move_energy_pj(arch: ArchSpec, n_bytes: float) -> float:
    """Link energy of moving ``n_bytes`` between banks (pJ).

    Same per-bit IO energy the base model charges for inter-layer output
    movement (Table I ``e_io``), so transform-relocation energy and
    output-write energy are on one scale."""
    return n_bytes * 8 * arch.timing.e_io


def analyze(mapping: Mapping) -> LayerPerf:
    arch = mapping.arch
    layer = mapping.layer
    step_ns = step_latency_ns(mapping)
    n_steps = mapping.n_steps
    n_banks = mapping.n_banks
    compute_ns = step_ns * n_steps

    # inter-layer output->input data movement through channel links
    chan_level = arch.levels[min(1, len(arch.levels) - 1)]
    write_bw = chan_level.write_bw or 16.0
    channels_used = 1
    for li, lp in mapping.nest:
        if li == 0 and lp.spatial:
            channels_used *= lp.size
    out_bytes = layer.output_elems * arch.word_bytes
    output_move_ns = out_bytes / (write_bw * channels_used)

    ext = mapping.tile_extent
    tile_out = 1
    for d in OUTPUT_DIMS:
        tile_out *= ext[d]
    tile_move_ns = tile_out * arch.word_bytes / write_bw
    tile_bytes = tile_out * arch.word_bytes

    # energy: AAP-dominated bit-serial compute + IO for the movement
    n = arch.word_bits
    e_add = (4 * n + 1) * arch.timing.e_act
    e_mac = (n + 1) * e_add  # mul = n serial adds, + 1 accumulate add
    compute_energy = layer.macs * e_mac
    io_energy = out_bytes * 8 * arch.timing.e_io

    return LayerPerf(
        step_ns=step_ns, n_steps=n_steps, n_banks=n_banks,
        compute_ns=compute_ns, output_move_ns=output_move_ns,
        tile_move_ns=tile_move_ns,
        sequential_ns=compute_ns + output_move_ns,
        energy_pj=compute_energy + io_energy,
        compute_energy_pj=compute_energy, io_energy_pj=io_energy,
        tile_bytes=tile_bytes,
        move_pj_per_byte=move_energy_pj(arch, 1.0))


# ---------------------------------------------------------------------------
# Architecture cost proxies (DSE objectives; see repro_torch.dse).
#
# Deliberately coarse: the DSE subsystem needs a consistent partial order
# over configurations, not sign-off-quality silicon numbers. Area counts the
# compute columns (the memory arrays doing bit-serial work), per-bank
# periphery (sense amps, row decoder, PIM control) and per-channel IO/TSV
# overhead. Power is peak: every bank running back-to-back AAPs (activation
# energy over the row-cycle time — faster timing bins burn more) plus the
# host-bus IO at full tilt.
# ---------------------------------------------------------------------------

_AREA_COL_MM2 = 1e-4     # one compute column (array slice)
_AREA_BANK_MM2 = 0.02    # bank periphery
_AREA_CHANNEL_MM2 = 0.5  # channel IO / TSV stack


def _channel_count(arch: ArchSpec) -> int:
    """Instances of the level just below the root (channels / tiles)."""
    return arch.instances_at(min(1, len(arch.levels) - 1))


def _physical_banks(arch: ArchSpec) -> int:
    """Instances of the level above compute (banks / blocks) — the
    *physical* structure, independent of where ``target_level`` puts the
    overlap analysis (identical hardware must cost identical area)."""
    return arch.instances_at(max(0, len(arch.levels) - 2))


def arch_area_proxy(arch: ArchSpec) -> float:
    """Relative die area (mm^2-ish) of a PIM configuration."""
    banks = _physical_banks(arch)
    cols = arch.instances_at(len(arch.levels) - 1)  # all compute columns
    return (cols * _AREA_COL_MM2 + banks * _AREA_BANK_MM2
            + _channel_count(arch) * _AREA_CHANNEL_MM2)


def arch_power_proxy(arch: ArchSpec) -> float:
    """Peak power (W-ish): all banks issuing AAPs continuously + IO.

    ``e_act / t_aap`` is pJ/ns = mW per continuously-activating bank, so a
    scaled-down (faster) timing raises power — the knob that keeps "just
    shrink the timing" from dominating the Pareto frontier for free."""
    t = arch.timing
    bank_mw = t.e_act / t.t_aap
    io_mw = arch.host_bus_gbps * 8 * t.e_io  # bytes/ns * bits * pJ/bit = mW
    return (_physical_banks(arch) * bank_mw + io_mw) / 1e3


class PerfCache:
    """Memoizes ``analyze()`` on ``(Mapping.cache_key, ArchSpec.to_key())``.

    ``Mapping.cache_key`` interns (layer, blocks) only, so the arch content
    key disambiguates equal nests under different architectures. Keying on
    content (not arch identity) lets one cache serve a multi-arch DSE sweep:
    revisiting an architecture — even via a distinct but equal ``ArchSpec``
    object — hits the existing entries."""

    def __init__(self):
        self._store: dict = {}
        #: plain-int hit/miss accounting (no telemetry dispatch — the
        #: engine folds these into its ``stats`` at publish time), so
        #: cross-request cache warming is observable (DESIGN.md §13)
        self.hits = 0
        self.misses = 0

    def analyze(self, mapping: Mapping) -> LayerPerf:
        key = (mapping.cache_key, mapping.arch.to_key())
        hit = self._store.get(key)
        if hit is None:
            self.misses += 1
            hit = self._store[key] = analyze(mapping)
        else:
            self.hits += 1
        return hit
