"""whisper-base — enc-dec, conv frontend STUB [arXiv:2212.04356].

6L (enc) + 6L (dec), d_model=512, 8H (kv=8), d_ff=2048, vocab=51865.
``input_specs()`` supplies precomputed frame embeddings (the mel+conv
frontend is stubbed per the assignment).
"""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper_base", family="audio",
        n_layers=6, enc_layers=6, d_model=512, vocab=51865,
        n_heads=8, n_kv_heads=8, d_ff=2048, mlp="gelu",
        use_rope=False, enc_frames=1500, max_seq=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper_base_smoke", family="audio",
        n_layers=2, enc_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, d_ff=128, mlp="gelu",
        use_rope=False, enc_frames=16, max_seq=64,
    )
