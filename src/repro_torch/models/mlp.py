"""Dense FFN (SwiGLU / GELU).

PyTorch counterpart of ``repro.models.mlp`` (dense part). On CUDA
tensors SwiGLU runs the hand-written fused MLP kernel
(``kernels.fused_mlp``), which forms h in fp32 and rounds it once; on
CPU tensors it runs the reference's formula, which rounds each product
to x.dtype. In bf16 the two round differently.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..kernels import fused_mlp as fused_kernel
from .common import ModelConfig, dense_init


def init_mlp(cfg: ModelConfig, gen: torch.Generator,
             dtype=torch.float32) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp == "swiglu":
        return {"w1": dense_init(gen, d, f, dtype),
                "w3": dense_init(gen, d, f, dtype),
                "w2": dense_init(gen, f, d, dtype)}
    return {"w1": dense_init(gen, d, f, dtype),
            "w2": dense_init(gen, f, d, dtype)}


def mlp(cfg: ModelConfig, params: Dict, x):
    if "w3" not in params:
        h = F.gelu(x @ params["w1"].to(x.dtype), approximate="tanh")
        return h @ params["w2"].to(x.dtype)
    if x.is_cuda:
        y = fused_kernel.fused_mlp(x.reshape(-1, x.shape[-1]),
                                   params["w1"].to(x.dtype),
                                   params["w3"].to(x.dtype),
                                   params["w2"].to(x.dtype))
        return y.reshape(x.shape)
    h = F.silu(x @ params["w1"].to(x.dtype)) * (x @ params["w3"].to(x.dtype))
    return h @ params["w2"].to(x.dtype)
