"""Carry parameters across from the JAX package.

jax.random and torch generators draw different numbers from one seed,
so parity tests build weights once with the reference ``init_params``
and convert them here. The reference tree (nested dicts, per-layer
leaves stacked on a leading layer axis, weights ``[d_in, d_out]``, the
MoE's expert stacks ``[L, E, D, F]``, norm scales, the SSM's
``dt_bias``/``A_log``/``D``/``gn_scale`` and the MoE router fp32) keeps
its layout; only the leaf type changes.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .common import ModelConfig, keeps_fp32, tree_map

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
    otherwise leaves are cast to ``dtype``, except those ``keeps_fp32``
    names (norm scales, the SSM's fp32 leaves, the MoE router). Raises if
    the tree's shapes are not ``cfg``'s."""
    want = (cfg.padded_vocab, cfg.d_model)
    if tuple(np.shape(tree["embed"])) != want:
        raise ValueError(f"embed is {np.shape(tree['embed'])}, {cfg.arch_id} "
                         f"needs {want}")

    depth = {"layers": cfg.n_layers, "decoder": cfg.n_layers,
             "encoder": cfg.enc_layers}

    def leaf(path, arr):
        stack = path.split("/", 1)[0]
        if stack in depth and np.shape(arr)[0] != depth[stack]:
            raise ValueError(f"{path} stacks {np.shape(arr)[0]} layers, "
                             f"{cfg.arch_id} has {depth[stack]}")
        t = _tensor(arr)
        if dtype is not None and not keeps_fp32(path):
            t = t.to(dtype)
        return t.to(device)

    return tree_map(leaf, tree)
