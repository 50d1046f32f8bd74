"""Carry parameters across from the JAX package.

jax.random and torch generators draw different numbers from one seed,
so parity tests build weights once with the reference ``init_params``
and convert them here. The reference tree (nested dicts, per-layer
leaves stacked on a leading layer axis, weights ``[d_in, d_out]``, norm
scales fp32) keeps its layout; only the leaf type changes.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .common import ModelConfig, tree_map

PyTree = Any


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: carry the bits as int16
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_numpy(cfg: ModelConfig, tree: PyTree, device,
                      dtype: Optional[torch.dtype] = None) -> PyTree:
    """The reference parameter tree (numpy leaves, bfloat16 as ml_dtypes)
    as torch tensors on ``device``. Lossless when ``dtype`` is None;
    otherwise weight leaves are cast to ``dtype`` and norm scales stay
    fp32. Raises if the tree's shapes are not ``cfg``'s."""
    want = (cfg.padded_vocab, cfg.d_model)
    if tuple(np.shape(tree["embed"])) != want:
        raise ValueError(f"embed is {np.shape(tree['embed'])}, {cfg.arch_id} "
                         f"needs {want}")

    def leaf(path, arr):
        if path.startswith("layers/") and np.shape(arr)[0] != cfg.n_layers:
            raise ValueError(f"{path} stacks {np.shape(arr)[0]} layers, "
                             f"{cfg.arch_id} has {cfg.n_layers}")
        t = _tensor(arr)
        if dtype is not None and "norm" not in path.rsplit("/", 1)[-1]:
            t = t.to(dtype)
        return t.to(device)

    return tree_map(leaf, tree)
