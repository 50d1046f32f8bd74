"""Shared model substrate: config, norms, RoPE, initializers.

PyTorch counterpart of ``repro.models.common``. ``ModelConfig`` is a
jax-free copy with the same fields and properties, so a config built
here and one built by the JAX package compare equal field by field.
Per-layer parameters are stacked on a leading layer axis, as in the
reference, so the two packages share one parameter layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

PyTree = Any

VOCAB_PAD = 512  # pad vocab so the unembed shards on any model axis <= 512


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0
    norm: str = "rmsnorm"        # rmsnorm | layernorm_np (OLMo)
    mlp: str = "swiglu"          # swiglu | gelu
    rope_theta: float = 10_000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_shards: int = 1
    moe_impl: str = "gather"
    moe_data_axes: tuple = ()
    moe_expert_axis: str = ""
    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (Zamba-2): one shared attention block applied every k layers
    attn_every: int = 0
    # encoder-decoder (Whisper backbone)
    enc_layers: int = 0
    enc_frames: int = 1500
    # vlm (LLaVA-NeXT backbone): anyres patch embeddings prepended (stub)
    img_tokens: int = 0
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # decoder learned-position table size (encoder-decoder family)
    max_seq: int = 32768
    remat_policy: str = "full"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_ssm_family(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def params_count(self, params: PyTree) -> int:
        return sum(t.numel() for t in tree_leaves(params))


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config dtype name ("float32", "bfloat16")."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def tree_leaves(tree: PyTree):
    """Tensors of a nested dict, in key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key])
    else:
        yield tree


def tree_map(fn, tree: PyTree, path: str = "") -> PyTree:
    """Apply ``fn(path, leaf)`` to every leaf of a nested dict; ``path``
    is the '/'-joined key path."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layernorm_np(x, _scale_unused=None, eps=1e-5):
    """Non-parametric LayerNorm (OLMo: no scale/bias)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(cfg: ModelConfig, x, scale):
    if cfg.norm == "layernorm_np":
        return layernorm_np(x)
    return rmsnorm(x, scale)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, positions):
    """positions [*] -> (cos, sin) each [*, hd/2], float32."""
    hd = cfg.hd
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    inv = 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [..., S, H, hd]; cos/sin [S, hd/2] (broadcast over batch/heads).
    Rotates split halves, not interleaved pairs."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None):
    """Normal(0, std) weight [d_in, d_out] drawn in float32 on the
    generator's device, then cast; std defaults to 1/sqrt(d_in)."""
    std = scale if scale is not None else (1.0 / math.sqrt(d_in))
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * std).to(dtype)
