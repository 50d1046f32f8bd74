"""Spans on the LM hot path: the training step, the serving engine, the
model layers and the kernel wrappers.

``span(name)`` is a context manager named ``<layer>.<part>``
(``trainer.forward``, ``engine.decode``, ``model.attention``,
``kernel.fused_mlp.bwd``, ...). It is live while a torch profiler records
or ``obs`` telemetry is on; otherwise it is one shared no-op object, so a
call site costs a function call and two flag reads. A live span:

* while a profiler records, opens a profiler range ``name``: it sits in
  the profiler's trace on the profiler's clock (``start_ns`` on the Unix
  epoch, as ``obs``'s ``ts0``), nested with the operations launched
  inside it, and in ``export_chrome_trace``. The range is the profiler's
  ``RecordFunctionFast``, which ``torch.profiler.record_function`` is
  not: that one is a dispatched operation, which selective checkpointing
  (remat "dots") records in the forward and replays in the recompute, so
  a range opened in the recompute alone (``trainer.recompute``), or a
  profiler started between a forward and its backward, would make the
  backward raise;
* adds its count and host seconds to a process-wide table, keyed by the
  thread's stack of open spans joined with ``;`` (the folded-stack form);
  backward ``Function``\\ s on the card run on autograd's own thread, whose
  stacks start afresh;
* when ``obs`` telemetry is on, also enters ``obs.span(name)``, so the
  JSONL sink and the ``span.<name>`` histograms see it.

``table()`` returns a copy of the table, ``reset()`` empties it. Spans
observe and never steer: what the program computes is the same with them
live or not.

Counters count what the program already knows on the host (rows, host
reads), under names of the same form (``moe.routed_rows``):
``count(name, n)`` adds ``n`` (a number, or a list added elementwise,
such as rows by expert) while spans are live, and is a no-op otherwise.
``counters()`` returns a copy and ``reset_counters()`` empties them; a
reader takes them once a run, as the span table.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Sequence, Tuple, Union

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

from .. import obs

_lock = threading.Lock()
_table: Dict[str, list] = {}      # folded stack -> [count, host seconds]
_counters: Dict[str, list] = {}   # counter name -> [total of each entry]
_local = threading.local()


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NOOP = _NoopSpan()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "_inner", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _stack().append(self.name)
        inner = []
        if _profiler._is_profiler_enabled:
            inner.append(_RecordFunctionFast(self.name))
        if obs.enabled():
            inner.append(obs.span(self.name))
        for cm in inner:
            cm.__enter__()
        self._inner = inner
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        stack = _stack()
        key = ";".join(stack)
        stack.pop()
        with _lock:
            rec = _table.get(key)
            if rec is None:
                _table[key] = [1, dt]
            else:
                rec[0] += 1
                rec[1] += dt
        for cm in reversed(self._inner):
            cm.__exit__(*exc)
        return None


def span(name: str):
    """The span ``name`` (module docstring): live while a profiler records
    or telemetry is on, else the shared no-op."""
    if _profiler._is_profiler_enabled or obs.enabled():
        return _Span(name)
    return _NOOP


def table() -> Dict[str, Tuple[int, float]]:
    """{folded stack: (count, host seconds)} of every span closed since
    the last ``reset``."""
    with _lock:
        return {k: (v[0], v[1]) for k, v in _table.items()}


def reset() -> None:
    """Empty the table."""
    with _lock:
        _table.clear()


def count(name: str, n: Union[int, Sequence[int]]) -> None:
    """Add ``n`` to the counter ``name`` (module docstring) while spans
    are live."""
    if not (_profiler._is_profiler_enabled or obs.enabled()):
        return
    vals = [int(n)] if isinstance(n, int) else [int(v) for v in n]
    with _lock:
        rec = _counters.setdefault(name, [0] * len(vals))
        if len(rec) < len(vals):
            rec.extend([0] * (len(vals) - len(rec)))
        for i, v in enumerate(vals):
            rec[i] += v


def counters() -> Dict[str, List[int]]:
    """{counter: [total of each entry]} since the last
    ``reset_counters``."""
    with _lock:
        return {k: list(v) for k, v in _counters.items()}


def reset_counters() -> None:
    """Empty the counters."""
    with _lock:
        _counters.clear()
