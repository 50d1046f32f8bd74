"""olmo-1b — non-parametric LayerNorm [arXiv:2402.00838].

16L d_model=2048, 16H (GQA kv=16), d_ff=8192, vocab=50304.
"""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="olmo_1b", family="dense",
        n_layers=16, d_model=2048, vocab=50304,
        n_heads=16, n_kv_heads=16, d_ff=8192,
        norm="layernorm_np",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="olmo_1b_smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, d_ff=128,
        norm="layernorm_np",
    )
