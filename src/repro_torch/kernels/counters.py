"""The launch counters of the port's kernels, in one registry.

Each kernel's op counts on the host the calls that launched its kernels,
in attributes of the op function whose names hold ``launches``: an int,
or a dict of ints by regime (each ``ops`` module's docstring). ``OPS``
lists the ops; ``read``, ``moved`` and ``add`` snapshot, difference and
add to every counter they carry (a decode step replayed from a CUDA
graph runs no Python, so ``serve.decode_graph`` adds what its capture
moved), and ``reset`` sets them all to zero. ``add`` also adds the
decode attention's launches by regime to its span counter
(``decode_attn.ops.COUNTER``), which a profiled window reads as its
own."""
from __future__ import annotations

from typing import Dict, Tuple

from ..launch import spans
from .decode_attn import ops as decode_ops
from .flash_attn import ops as flash_ops
from .fused_mlp import ops as mlp_ops
from .ssd_scan import ops as ssd_ops
from .ssm_chain import ops as chain_ops

OPS = (flash_ops.flash_attention, mlp_ops.fused_mlp, ssd_ops.ssd_scan,
       decode_ops.decode_attention, chain_ops.conv_silu,
       chain_ops.gated_rmsnorm)

_BY_NAME = {fn.__name__: fn for fn in OPS}
Key = Tuple[str, str]      # (op name, counter attribute)


def _counters():
    return [(fn, attr) for fn in OPS for attr in sorted(vars(fn))
            if "launches" in attr]


def read() -> Dict[Key, object]:
    """{(op, counter): its value} of every counter, dicts copied."""
    return {(fn.__name__, attr): dict(v) if isinstance(v, dict) else v
            for fn, attr in _counters() for v in (getattr(fn, attr),)}


def moved(before: Dict[Key, object], after: Dict[Key, object]):
    """How far each counter moved from ``before`` to ``after`` (``read``'s)."""
    out = {}
    for key, a in after.items():
        b = before[key]
        out[key] = ({k: n - b[k] for k, n in a.items()}
                    if isinstance(a, dict) else a - b)
    return out


def add(amounts: Dict[Key, object], sign: int = 1) -> None:
    """Add ``sign`` times ``amounts`` (``moved``'s) to the counters, the
    decode attention's span counter included."""
    for (name, attr), n in amounts.items():
        fn = _BY_NAME[name]
        cur = getattr(fn, attr)
        if isinstance(cur, dict):
            for k, v in n.items():
                cur[k] += sign * v
        else:
            setattr(fn, attr, cur + sign * n)
        if (name, attr) == ("decode_attention", "launches_by_regime"):
            spans.count(decode_ops.COUNTER,
                        [sign * n[k] for k in decode_ops.REGIMES])


def reset() -> None:
    """Every counter to zero (a dict's every regime)."""
    for fn, attr in _counters():
        cur = getattr(fn, attr)
        setattr(fn, attr, dict.fromkeys(cur, 0) if isinstance(cur, dict)
                else 0)
