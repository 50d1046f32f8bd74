"""deepseek-moe-16b — 2 shared + 64 routed top-6, fine-grained experts
[arXiv:2401.06066].

28L d_model=2048, 16H (GQA kv=16), expert d_ff=1408, vocab=102400.
"""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek_moe_16b", family="moe",
        n_layers=28, d_model=2048, vocab=102400,
        n_heads=16, n_kv_heads=16, d_ff=1408,
        n_experts=64, top_k=6, n_shared_experts=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek_moe_16b_smoke", family="moe",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, d_ff=64,
        n_experts=4, top_k=2, n_shared_experts=1,
    )
