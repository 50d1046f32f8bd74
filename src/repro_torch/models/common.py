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

from .parallel import replicate_like

PyTree = Any

VOCAB_PAD = 512  # pad vocab so the unembed shards on any model axis <= 512
RMS_EPS = 1e-6   # rmsnorm's epsilon, every config's

# A published config.json key -> the field (or property) it equals in the
# port, or the port's fixed choice: its RMSNorm epsilon, no projection or
# conv bias; None: recorded only (a NoPE model's context has no table to
# hold it to).
PUBLISHED = {
    "hidden_size": "d_model", "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "intermediate_size": "d_ff", "shared_intermediate_size": "shared_width",
    "num_local_experts": "n_experts", "num_experts_per_tok": "top_k",
    "vocab_size": "vocab", "mamba_n_heads": "ssm_heads",
    "mamba_d_head": "ssm_head_dim", "mamba_d_state": "ssm_state",
    "mamba_expand": "ssm_expand", "mamba_n_groups": "ssm_groups",
    "mamba_d_conv": "ssm_conv", "mamba_chunk_size": "ssm_chunk",
    "tie_word_embeddings": "tie_embeddings", "rms_norm_eps": RMS_EPS,
    "attention_bias": False, "mamba_proj_bias": False,
    "mamba_conv_bias": False, "max_position_embeddings": None,
}


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
    # DeepSeekMoE's layout (the port's own; the reference has none of
    # these): ``first_dense_layers`` leading dense layers of width
    # ``dense_d_ff``; the ``experts_held`` experts that this device
    # computes, the router's first columns (0: all ``n_experts``; the
    # router still scores all of them); whether the top-k gates are
    # renormalised; and the balance loss, GShard's over all tokens or
    # DeepSeekMoE's sequence-level one ("seq")
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    experts_held: int = 0
    moe_norm_topk: bool = True
    router_aux: str = "gshard"
    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (Zamba-2): one shared attention block applied every k layers
    attn_every: int = 0
    # hybrid with typed layers (Granite 4.0-H, the port's own; the
    # reference has none of these): ``layer_types`` gives each layer's
    # mixer, "mamba" or "attention", each followed by the feed-forward
    # (empty: the family's own layout); the µP multipliers of the
    # embedding, of every residual branch and of the logits (divided by
    # ``logits_scaling``); the softmax scale (0: 1/sqrt(hd))
    layer_types: tuple = ()
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    logits_scaling: float = 1.0
    # the published config.json's keys under their own names, as a
    # configuration file states them beside the fields above; each is held
    # to what the port runs (``published_mismatches``, ``PUBLISHED``);
    # 0 or None: not stated
    hidden_size: int = 0
    num_hidden_layers: int = 0
    num_attention_heads: int = 0
    num_key_value_heads: int = 0
    intermediate_size: int = 0
    shared_intermediate_size: int = 0
    num_local_experts: int = 0
    num_experts_per_tok: int = 0
    vocab_size: int = 0
    mamba_n_heads: int = 0
    mamba_d_head: int = 0
    mamba_d_state: int = 0
    mamba_expand: int = 0
    mamba_n_groups: int = 0
    mamba_d_conv: int = 0
    mamba_chunk_size: int = 0
    max_position_embeddings: int = 0
    rms_norm_eps: float = 0.0
    tie_word_embeddings: Optional[bool] = None
    attention_bias: Optional[bool] = None
    mamba_proj_bias: Optional[bool] = None
    mamba_conv_bias: Optional[bool] = None
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
    def held_experts(self) -> int:
        """The routed experts whose weights this device holds."""
        return self.experts_held or self.n_experts

    @property
    def is_ssm_family(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def shared_width(self) -> int:
        """The shared expert's SwiGLU width."""
        return self.n_shared_experts * self.d_ff

    def softmax_scale(self) -> Optional[float]:
        """The attention's softmax scale, ``attention_multiplier``; None
        for the default 1/sqrt(hd), which every kernel and path computes
        as it always has."""
        return self.attention_multiplier or None

    def published_mismatches(self) -> list:
        """["key: published X, runs Y"] of every stated published key
        (``PUBLISHED``) that disagrees with what the port runs."""
        out = []
        for key, runs in PUBLISHED.items():
            stated = getattr(self, key)
            if runs is None or stated is None or (
                    stated is not False and stated == 0):
                continue
            want = getattr(self, runs) if isinstance(runs, str) else runs
            if stated != want:
                out.append(f"{key}: published {stated!r}, runs {want!r}")
        return out

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


# Mamba-2 leaves the reference creates in fp32 whatever ``param_dtype`` is
# (``repro/models/ssm.py::init_mamba2``).
SSM_FP32_LEAVES = ("dt_bias", "A_log", "D", "gn_scale")


def keeps_fp32(path: str) -> bool:
    """True for the leaves that stay fp32 when the weights are cast: the
    norm scales, the SSM's ``dt_bias``, ``A_log``, ``D`` and
    ``gn_scale``, and the MoE ``router`` (``repro/models/mlp.py:52``), as
    the reference creates them in fp32 regardless of ``param_dtype``.
    ``path`` is a '/'-joined ``tree_map`` path."""
    keys = path.split("/")
    return ("norm" in keys[-1]
            or ("ssm" in keys[:-1] and keys[-1] in SSM_FP32_LEAVES)
            or ("moe" in keys[:-1] and keys[-1] == "router"))


def tree_leaves(tree: PyTree):
    """Tensors of a nested dict, in key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key])
    else:
        yield tree


def tree_get(tree: PyTree, path: str):
    """The leaf (or subtree) of a nested dict at a '/'-joined path."""
    for key in path.split("/"):
        tree = tree[key]
    return tree


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

def rmsnorm(x, scale, eps=RMS_EPS):
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
    c = replicate_like(cos[..., :, None, :], x)
    s = replicate_like(sin[..., :, None, :], x)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is meta: the initialisers, which
    allocate on their generator's device, then build shapes and dtypes
    only (a parameter-shape tree without allocating or drawing)."""

    @property
    def device(self):
        return torch.device("meta")


def meta_generator() -> torch.Generator:
    return _MetaGenerator()


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None):
    """Normal(0, std) weight [d_in, d_out] drawn in float32 on the
    generator's device, then cast; std defaults to 1/sqrt(d_in)."""
    std = scale if scale is not None else (1.0 / math.sqrt(d_in))
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * std).to(dtype)
