"""The Mamba-2 chain kernels' share of their roofline in a traced serving
window: the least time of every chain call's work over the device time
of the kernels that did it, ``mamba2_conv_silu`` and
``mamba2_gated_rmsnorm``, found by name in the profiler's trace.

A serving prefill runs each kernel once a Mamba-2 layer on the batch's
B x S rows (training keeps the torch chain, and the decode step runs
neither). Their least work is bytes alone (a few FLOPs a byte):

* conv_silu: the x, B and C projections [rows, W + 2 GN] and dt
  [rows, H] read and SiLU of the conv of x, B and C written in bf16,
  softplus(dt + dt_bias) written in fp32 [rows, H]; the conv weights
  [K, W + 2 GN] in bf16 and dt_bias, A_log and A [H] in fp32, once;
* gated_rmsnorm: the scan's y, xc and z [rows, W] read and the output
  written in bf16; D [H] and gn_scale [W] in fp32.

The calls are counted by the program's span counter
``ssm_chain.launches_by_kind`` ([conv_silu, gated_rmsnorm]), which
counts while a profiler records, so in the traced window alone. It has
to report exactly the calls expected of each kind, else the share is not
read: a program without the counter, or a path this arithmetic does not
know, reads None rather than a wrong share.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

from . import work
from .decode_roofline import program_counters

COUNTER = "ssm_chain.launches_by_kind"
KERNELS = re.compile(r"mamba2_(conv_silu|gated_rmsnorm)")
CONV_K = 4


def conv_silu(rows: int, w: int, gn: int, h: int, k: int = CONV_K
              ) -> work.Work:
    """One pre-scan call over ``rows`` rows: (FLOPs, bytes)."""
    nbytes = (work.BF16 * (2 * rows * (w + 2 * gn) + rows * h
                           + k * (w + 2 * gn))
              + work.FP32 * (rows * h + 3 * h))
    return 0.0, nbytes


def gated_rmsnorm(rows: int, w: int, h: int) -> work.Work:
    """One post-scan call over ``rows`` rows: (FLOPs, bytes)."""
    return 0.0, work.BF16 * 4 * rows * w + work.FP32 * (h + w)


def mamba_layers(cfg: dict) -> int:
    """The Mamba-2 layers of a configuration: every layer of the ssm
    family, the "mamba" entries of a typed hybrid's ``layer_types``."""
    if cfg.get("layer_types"):
        return list(cfg["layer_types"]).count("mamba")
    return cfg["n_layers"] if cfg["family"] == "ssm" else 0


def calls(cfg: dict, traffic: dict) -> List[Tuple[int, work.Work]]:
    """[(calls, least work of one call)] of each kernel, conv_silu first,
    in one generate call of a serving mix; [] for a training mix or a
    configuration with no Mamba-2 layer."""
    n = mamba_layers(cfg)
    if traffic["kind"] != "serve" or not n:
        return []
    rows = traffic["batch"] * traffic["prompt"]
    w = cfg["ssm_expand"] * cfg["d_model"]
    h = w // cfg["ssm_head_dim"]
    gn = cfg["ssm_groups"] * cfg["ssm_state"]
    return [(n, conv_silu(rows, w, gn, h, cfg["ssm_conv"])),
            (n, gated_rmsnorm(rows, w, h))]


def device_seconds(ctx) -> float:
    return sum(s for name, s in ctx.traced["device_ops"].items()
               if KERNELS.search(name))


def share(ctx) -> Optional[float]:
    """% of the roofline that the chain kernels reached in the traced
    units, or None (module docstring)."""
    if not ctx.traced or ctx.kind != "serve":
        return None
    want = calls(ctx.cfg, ctx.traffic)
    if not want:
        return None
    got = program_counters(ctx).get(COUNTER)
    if not got or list(got) != [ctx.traced_units * c for c, _ in want]:
        return None
    least = ctx.traced_units * sum(c * work.least_seconds(*w)
                                   for c, w in want)
    spent = device_seconds(ctx)
    return 100.0 * least / spent if spent > 0 else None
