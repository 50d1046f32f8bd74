"""phi3-mini-3.8b — RoPE SwiGLU GQA [arXiv:2404.14219].

32L d_model=3072, 32H (GQA kv=32), d_ff=8192, vocab=32064.
"""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="phi3_mini_3_8b", family="dense",
        n_layers=32, d_model=3072, vocab=32064,
        n_heads=32, n_kv_heads=32, d_ff=8192,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="phi3_mini_3_8b_smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, d_ff=128,
    )
