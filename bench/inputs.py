"""What the benchmark makes from ``--seed`` and hands to both sides: the
weights, the training batches and the prompts.

One general generator serves every traffic file: a training mix gives
``batch`` and ``seq``, a serving mix ``batch``, ``prompt`` and
``new_tokens``. Tokens are uniform over the real vocabulary, drawn by
numpy from (seed, stream, index), so every row of every step or call
differs and the same seed gives the same inputs. Weights are drawn on
the device by one ``torch.Generator`` in one call over all their
elements, in float32, and cast to the type they are run in.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .reference.model import fp32_leaf, param_layout

TRAIN_STREAM, PROMPT_STREAM, SAMPLE_STREAM = 1, 2, 3
ALIGN = 256             # elements between leaves of the flat draw


def rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream, index])


def train_batch(traffic: dict, vocab: int, seed: int, step: int
                ) -> Dict[str, np.ndarray]:
    """Step ``step``'s batch: tokens and next-token labels [batch, seq]."""
    rows = rng(seed, TRAIN_STREAM, step).integers(
        0, vocab, (traffic["batch"], traffic["seq"] + 1), dtype=np.int32)
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def prompts(traffic: dict, vocab: int, seed: int, call: int) -> np.ndarray:
    """Call ``call``'s prompts [batch, prompt]."""
    return rng(seed, PROMPT_STREAM, call).integers(
        0, vocab, (traffic["batch"], traffic["prompt"]), dtype=np.int32)


def sample(seed: int, calls: int, batch: int, k: int) -> np.ndarray:
    """``k`` distinct requests (``call * batch + slot``) of ``calls``
    calls of ``batch`` slots, drawn from the seed, in increasing order:
    the slots as evenly as ``k`` allows (every slot once ``k`` reaches
    ``batch``), each slot's calls drawn without repeats."""
    g = rng(seed, SAMPLE_STREAM)
    k = min(k, calls * batch)
    out = []
    for i, slot in enumerate(g.permutation(batch)):
        n = min(k // batch + (i < k % batch), calls)
        out += [c * batch + slot for c in g.choice(calls, n, replace=False)]
    return np.sort(np.asarray(out, dtype=np.int64))


def _aligned(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def weights(cfg: dict, seed: int, device, served: bool = False
            ) -> Dict[str, torch.Tensor]:
    """{path: tensor} of ``param_layout(cfg)`` from ``seed``: every normal
    leaf a view of one flat float32 draw, scaled by its std (in the
    compute dtype when ``served``, except ``fp32_leaf``s); constant
    leaves filled."""
    layout = param_layout(cfg)
    sizes = [int(np.prod(shape)) for _, shape, _ in layout]
    total = sum(_aligned(n) for (_, _, init), n in zip(layout, sizes)
                if init[0] == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, dtype=torch.float32,
                       device=device)
    out, off = {}, 0
    for (path, shape, init), n in zip(layout, sizes):
        if init[0] == "normal":
            out[path] = flat[off:off + n].view(shape).mul_(init[1])
            off += _aligned(n)
        else:
            out[path] = torch.full(shape, 1.0 if init[0] == "ones" else 0.0,
                                   dtype=torch.float32, device=device)
    if not served:
        return out
    cdt = getattr(torch, cfg["compute_dtype"])
    low = flat.to(cdt)
    del flat
    off = 0
    for (path, shape, init), n in zip(layout, sizes):
        if init[0] != "normal":
            continue
        if not fp32_leaf(path):
            out[path] = low[off:off + n].view(shape)
        off += _aligned(n)
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """The '/'-path dict as the nested dict the program takes."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def layer_leaves(flat: Dict[str, torch.Tensor], n_layers: int
                 ) -> Tuple[Tuple[str, torch.Tensor], ...]:
    """(name, tensor) of every leaf, a stacked leaf split per layer
    ("layers/attn/wq[3]"): the units the training checks compare."""
    out = []
    for path, t in flat.items():
        if path.startswith("layers/"):
            out += [(f"{path}[{i}]", t[i]) for i in range(n_layers)]
        else:
            out.append((path, t))
    return tuple(out)
