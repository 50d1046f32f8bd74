"""zamba2-1.2b — Mamba2 + shared attention blocks [arXiv:2411.15242].

38L d_model=2048, 32H (GQA kv=32), d_ff=8192, vocab=32000, ssm_state=64.
One shared attention+MLP block (shared weights) applied every 6 layers.
"""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2_1_2b", family="hybrid",
        n_layers=38, d_model=2048, vocab=32000,
        n_heads=32, n_kv_heads=32, d_ff=8192,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
        ssm_conv=4, ssm_chunk=256, attn_every=6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2_1_2b_smoke", family="hybrid",
        n_layers=4, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, d_ff=128,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_groups=1,
        ssm_conv=4, ssm_chunk=16, attn_every=2,
    )
