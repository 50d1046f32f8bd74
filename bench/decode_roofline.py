"""The decode attention kernels' share of their roofline in a traced
serving window: the least time of every decode step's attention over the
device time of the kernels that did it, ``decode_attn_kernel`` and its
``decode_attn_combine`` (the second launch of a call that splits the
keys), found by name in the profiler's trace.

One call of the program's decode attention is one attention layer of one
decode step: the new token's queries against the cached keys and values
up to and including its position. Its least work: the score and value
products, 4 x B x H x hd x keys FLOPs; q read, the live prefix of the
cache (keys and values of the KV heads) read and the output written
once, in bf16. A generate call of ``new_tokens`` tokens makes one decode
step a generated token, the last one included, at positions prompt to
prompt + new_tokens - 1.

The calls are counted by the program's span counter
``decode_attention.launches_by_regime`` ([no split, split]), which counts
while a profiler records, so in the traced window alone. It has to report
exactly the calls expected, else the share is not read: a program without
the counter, or a path this arithmetic does not know, reads None rather
than a wrong share.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

from . import work
from .reference.model import head_dim

COUNTER = "decode_attention.launches_by_regime"
KERNELS = re.compile(r"decode_attn_(kernel|combine)")


def decode_attn(b: int, h: int, kv: int, hd: int, keys: int) -> work.Work:
    """One call over ``keys`` cached keys (the position, plus one):
    (FLOPs, bytes)."""
    flops = 4.0 * b * h * hd * keys
    nbytes = work.BF16 * (2 * b * h * hd + 2 * b * keys * kv * hd)
    return flops, nbytes


def calls(cfg: dict, traffic: dict) -> List[Tuple[int, work.Work]]:
    """[(calls, least work of one call)] of one generate call of a serving
    mix of the dense family: every layer at each decode step; [] for
    another family or mix."""
    if traffic["kind"] != "serve" or cfg["family"] != "dense":
        return []
    b, s = traffic["batch"], traffic["prompt"]
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    return [(cfg["n_layers"], decode_attn(b, h, kv, hd, s + t + 1))
            for t in range(traffic["new_tokens"])]


def program_counters(ctx) -> dict:
    """The program's span counters of the traced window
    (``repro_torch.launch.spans.counters``): the first read of a run takes
    and empties them, the readers of that run share what it took; {} for
    a run that was not traced or a program without them."""
    if not ctx.traced:
        return {}
    if not hasattr(ctx, "program_counters"):
        try:
            from repro_torch.launch import spans
        except ImportError:
            spans = None
        if spans is None or not hasattr(spans, "counters"):
            ctx.program_counters = {}
        else:
            ctx.program_counters = spans.counters()
            spans.reset_counters()
    return ctx.program_counters


def device_seconds(ctx) -> float:
    return sum(s for name, s in ctx.traced["device_ops"].items()
               if KERNELS.search(name))


def share(ctx) -> Optional[float]:
    """% of the roofline that the decode attention kernels reached in the
    traced units, or None (module docstring)."""
    if not ctx.traced or ctx.kind != "serve":
        return None
    want = calls(ctx.cfg, ctx.traffic)
    if not want:
        return None
    got = program_counters(ctx).get(COUNTER)
    if not got or sum(got) != ctx.traced_units * sum(c for c, _ in want):
        return None
    least = ctx.traced_units * sum(c * work.least_seconds(*w)
                                   for c, w in want)
    spent = device_seconds(ctx)
    return 100.0 * least / spent if spent > 0 else None
