"""The program's own span table (``repro_torch.launch.spans``) as the
per-layer readers read it.

The program fills its table while a profiler records, which in a run of
the benchmark is the traced window alone. The first reader of a traced
run takes the table and empties it, so each run reads its own window;
the readers of that run share what it took. A run that was not traced,
or a program without the table, reads None.

A key of the table is the stack of spans open on a thread, outermost
first, joined with ``;``; a span's name is the last element of its key.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

Table = Dict[str, Tuple[int, float]]


def table(ctx) -> Optional[Table]:
    """{folded stack: (count, host seconds)} of the traced window, or
    None."""
    if not ctx.traced:
        return None
    if not hasattr(ctx, "program_spans"):
        try:
            from repro_torch.launch import spans
        except ImportError:
            ctx.program_spans = None
        else:
            ctx.program_spans = spans.table() or None
            spans.reset()
    return ctx.program_spans


def total(tab: Table, name=None, prefix=None, under=None
          ) -> Tuple[int, float]:
    """(count, host seconds) summed over the spans named ``name`` (or
    whose name starts with ``prefix``, counting none inside another such
    span, so no time is counted twice), with ``under`` among their
    enclosing spans when given."""
    n, secs = 0, 0.0
    for key, (c, s) in tab.items():
        stack = key.split(";")
        leaf, outer = stack[-1], stack[:-1]
        if name is not None and leaf != name:
            continue
        if prefix is not None and (not leaf.startswith(prefix) or any(
                o.startswith(prefix) for o in outer)):
            continue
        if under is not None and under not in outer:
            continue
        n += c
        secs += s
    return n, secs


def ms_per(ctx, per: str, **which) -> Optional[float]:
    """Host ms of the spans ``which`` selects (``total``'s keywords) over
    the count of the spans named ``per``; None where either is missing."""
    tab = table(ctx)
    if tab is None:
        return None
    units = total(tab, name=per)[0]
    n, secs = total(tab, **which)
    if not units or not n:
        return None
    return 1e3 * secs / units
