"""Overlap-driven mapping transformation (paper Section IV-I).

Given the per-space input-ready times of an analyzed mapping, re-sort data
spaces in ascending ready order and re-allocate them round-robin across the
layer's bank instances. This turns any analyzed mapping into an
overlap-friendly one in O(N log N) (bounded by the sort) without
re-analyzing data spaces. The transformation is not free: spaces that move
to a different bank require their partial inputs to be moved, charged as
``tile_move_ns`` on the relocated space's ready time — and, energy-wise,
as ``tile_bytes`` of data pushed through the channel links per relocated
space (``moved_bytes`` / ``move_energy_pj`` on the result; the paper
charges relocation in time only, the energy accounting is the
ROADMAP's "energy-aware transform search" extension).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TransformResult:
    end_ns: float
    finish_ns: np.ndarray   # (nb, nt), indexed by ORIGINAL (bank, step) ids
    moved_frac: float       # fraction of spaces re-homed to another bank
    moved_bytes: float = 0.0     # data relocated across banks
    move_energy_pj: float = 0.0  # moved_bytes * move_pj_per_byte


def transform_schedule(ready_ns: np.ndarray, step_ns: float,
                       tile_move_ns: float = 0.0,
                       start_floor: float = 0.0,
                       order: np.ndarray = None,
                       tile_bytes=0.0,
                       move_pj_per_byte: float = 0.0) -> TransformResult:
    """``order``, when given, must equal ``np.argsort(flat, kind='stable')``
    of the flattened ready times — the batched engine precomputes it with
    an integer radix sort on producer finish-time ranks (same ordering,
    ~5x cheaper than the float mergesort).

    ``tile_bytes`` is the data footprint relocated per re-homed space:
    a scalar (uniform tiles, the common case) or an array broadcastable
    to ``ready_ns.shape`` indexed by ORIGINAL (bank, step) ids. It feeds
    only the ``moved_bytes`` / ``move_energy_pj`` accounting — the
    schedule itself (``end_ns`` / ``finish_ns`` / ``moved_frac``) is
    unchanged for any value, so callers that ignore energy keep the exact
    pre-existing behavior.
    """
    nb, nt = ready_ns.shape
    flat = ready_ns.reshape(-1)
    if order is None:
        order = np.argsort(flat, kind="stable")      # ascending ready time
    n = flat.size

    pos = np.arange(n, dtype=np.int64)
    new_bank = pos % nb                              # round-robin allocation
    slot = pos // nb
    orig_bank = order // nt
    moved = new_bank != orig_bank
    eff_ready = np.maximum(flat[order] + moved * tile_move_ns, start_floor)

    # per-bank closed-form schedule: spaces of bank b are positions b::nb,
    # already in ascending ready order.
    fin_sorted = np.empty(n, dtype=np.float64)
    nslots = (n + nb - 1) // nb
    # pad to rectangular (nb, nslots) for vectorization
    pad = nslots * nb - n
    r = np.concatenate([eff_ready, np.full(pad, -np.inf)])
    r = r.reshape(nslots, nb).T                      # (nb, nslots)
    s = np.arange(nslots, dtype=np.float64)
    base = np.maximum.accumulate(r - s[None, :] * step_ns, axis=1)
    fin = base + (s[None, :] + 1) * step_ns          # (nb, nslots)
    fin_flat = fin.T.reshape(-1)[:n]
    fin_sorted[:] = fin_flat

    out = np.empty(n, dtype=np.float64)
    out[order] = fin_sorted
    valid_end = float(fin_flat.max()) if n else 0.0

    n_moved = int(moved.sum())
    if np.ndim(tile_bytes) == 0:
        moved_bytes = n_moved * float(tile_bytes)
    else:
        tb = np.broadcast_to(
            np.asarray(tile_bytes, dtype=np.float64), (nb, nt)).reshape(-1)
        moved_bytes = float(tb[order[moved]].sum())
    return TransformResult(end_ns=valid_end,
                           finish_ns=out.reshape(nb, nt),
                           moved_frac=float(moved.mean()) if n else 0.0,
                           moved_bytes=moved_bytes,
                           move_energy_pj=moved_bytes * move_pj_per_byte)


def transform_end_grouped(values: np.ndarray, counts: np.ndarray,
                          n_steps: np.ndarray, step_ns: np.ndarray,
                          tile_move_ns: np.ndarray,
                          start_floor: float = 0.0):
    """Closed-form ``transform_schedule`` end time + moved-space count for a
    batch of candidates whose ready matrices are given as grouped
    (value, original-bank) histograms instead of dense (nb, nt) arrays.

    ``values`` is (K, V) float64: each candidate's distinct ready values in
    strictly ascending order (rows right-padded arbitrarily — padded slots
    must carry zero counts). ``counts`` is (K, V, nb) int64:
    ``counts[k, v, b]`` spaces of candidate ``k`` with original bank ``b``
    share ready value ``values[k, v]``. All candidates in one call share
    ``nb``; ``n_steps`` / ``step_ns`` / ``tile_move_ns`` are (K,) arrays.
    Returns ``(end_ns, n_moved)`` as (K,) arrays.

    Exactness (DESIGN.md Section 6): the stable ascending sort of the dense
    matrix orders spaces by (value, flat index), and flat index order
    within one value group is original-bank-major — so the histogram
    determines the exact sorted sequence. Under round-robin re-allocation
    position ``p`` lands in bank ``p % nb`` at slot ``p // nb`` and is
    *unmoved* iff ``p % nb`` equals its original bank. Every space of a
    (value, bank) run shares ``eff = max(value [+ tile_move if moved],
    floor)``; within a run each per-new-bank term ``eff - slot * L`` is
    maximal at the run's first unmoved / first moved position (slot is
    nondecreasing along the run and float ``a - b`` / ``t * L`` are
    monotone), so the global schedule maximum — and hence
    ``end = max(eff - slot * L) + n_steps * L`` — needs only two
    representatives per run. Bit-identical to ``transform_schedule``
    (differential-tested)."""
    K, V, nb = counts.shape
    nt = np.asarray(n_steps, dtype=np.int64)
    L = np.asarray(step_ns, dtype=np.float64)[:, None, None]
    tmv = np.asarray(tile_move_ns, dtype=np.float64)[:, None, None]
    gsize = counts.sum(axis=2)                      # (K, V)
    gstart = np.cumsum(gsize, axis=1) - gsize       # exclusive prefix
    off = np.cumsum(counts, axis=2) - counts        # within-group offsets
    s = gstart[:, :, None] + off                    # run starts (K, V, nb)
    e = s + counts
    b = np.arange(nb, dtype=np.int64)[None, None, :]
    nonempty = counts > 0
    # unmoved spaces of run [s, e): positions p with p % nb == b
    unmoved = np.where(nonempty, (e - b - 1) // nb - (s - b - 1) // nb, 0)
    n_moved = nb * nt - unmoved.sum(axis=(1, 2))
    fu = s + ((b - s) % nb)                         # first unmoved position
    has_u = nonempty & (fu < e)
    fm = np.where(s % nb != b, s, s + 1)            # first moved position
    has_m = nonempty & (fm < e) & (nb > 1)
    vv = np.asarray(values, dtype=np.float64)[:, :, None]
    effu = np.maximum(vv, start_floor)
    effm = np.maximum(vv + tmv, start_floor)
    xu = np.where(has_u, effu - (fu // nb).astype(np.float64) * L, -np.inf)
    xm = np.where(has_m, effm - (fm // nb).astype(np.float64) * L, -np.inf)
    best = np.maximum(xu, xm).max(axis=(1, 2))
    end = best + nt.astype(np.float64) * np.asarray(step_ns,
                                                    dtype=np.float64)
    return end, n_moved
