"""stablelm-3b [hf:stabilityai/stablelm-2-1_6b family].

32L d_model=2560, 32H (GQA kv=32), d_ff=6912, vocab=50304.
"""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="stablelm_3b", family="dense",
        n_layers=32, d_model=2560, vocab=50304,
        n_heads=32, n_kv_heads=32, d_ff=6912,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="stablelm_3b_smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, d_ff=128,
    )
