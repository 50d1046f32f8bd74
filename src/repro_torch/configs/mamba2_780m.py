"""mamba2-780m — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1536, attn-free, vocab=50280, ssm_state=128.
"""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2_780m", family="ssm",
        n_layers=48, d_model=1536, vocab=50280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
        ssm_conv=4, ssm_chunk=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2_780m_smoke", family="ssm",
        n_layers=2, d_model=64, vocab=256,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_groups=1,
        ssm_conv=4, ssm_chunk=16,
    )
