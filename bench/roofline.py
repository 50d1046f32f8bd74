"""A kernel's share of its roofline in a traced window: the least time of
the work its calls needed (``bench.work``) over the device time of the
kernels that did it, found by name in the profiler's trace.

The calls are those ``work.kernel_calls`` expects of the traced units;
the program's launch counter has to report exactly that many, else the
share is not read (a kernel taken off the path, or a path this
arithmetic does not know, reads nothing rather than a wrong share).
"""
from __future__ import annotations

import re
from typing import Optional

from . import work

# the device kernels of each op, by the names the program gives them
KERNELS = {
    "flash_fwd": r"flash_fwd",
    "flash_bwd": r"flash_bwd_",
    "mlp_fwd": r"mlp_(prefill|decode)",
    "mlp_bwd": r"mlp_bwd_",
    "ssd_fwd": r"ssd_chunk_state<\d+, false>|ssd_state_pass|ssd_chunk_scan",
    "ssd_bwd": r"ssd_chunk_state<\d+, true>|ssd_bwd_",
}


def device_seconds(ctx, op: str) -> float:
    pat = re.compile(KERNELS[op])
    return sum(s for name, s in ctx.traced["device_ops"].items()
               if pat.search(name))


def share(ctx, op: str) -> Optional[float]:
    """% of the roofline that ``op``'s kernels reached, or None."""
    if not ctx.traced:
        return None
    calls = work.kernel_calls(ctx.cfg, ctx.traffic).get(op)
    if not calls:
        return None
    n = sum(c for c, _ in calls) * ctx.traced_units
    if ctx.launches.get(op) != n:
        return None
    least = ctx.traced_units * sum(c * work.least_seconds(*w)
                                   for c, w in calls)
    spent = device_seconds(ctx, op)
    return 100.0 * least / spent if spent > 0 else None
