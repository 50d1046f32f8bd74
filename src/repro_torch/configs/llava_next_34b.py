"""llava-next-34b — anyres tiling VLM backbone
[hf:llava-hf/llava-v1.6 family].

60L d_model=7168, 56H (GQA kv=8), d_ff=20480, vocab=64000. The vision
tower / anyres tiling is a STUB: ``input_specs()``/smoke tests supply
precomputed patch embeddings prepended to the token stream.
"""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="llava_next_34b", family="vlm",
        n_layers=60, d_model=7168, vocab=64000,
        n_heads=56, n_kv_heads=8, d_ff=20480,
        head_dim=128, img_tokens=576,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="llava_next_34b_smoke", family="vlm",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, d_ff=128, img_tokens=8,
    )
