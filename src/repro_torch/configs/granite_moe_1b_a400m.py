"""granite-moe-1b-a400m — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024, 16H (GQA kv=8), expert d_ff=512, vocab=49155.
"""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite_moe_1b_a400m", family="moe",
        n_layers=24, d_model=1024, vocab=49155,
        n_heads=16, n_kv_heads=8, d_ff=512,
        n_experts=32, top_k=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite_moe_1b_a400m_smoke", family="moe",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, d_ff=64,
        n_experts=4, top_k=2,
    )
