"""granite-8b — llama-arch code model [arXiv:2405.04324].

36L d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=49152 (Table 1, the
8B column). The settings Table 1 leaves out (RMSNorm epsilon, RoPE base,
projection biases, tied embeddings) are the port's defaults here; the
benchmark's configuration ``bench/configs/granite_8b.json`` records each
under ``assumed`` or ``departures``.
"""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite_8b", family="dense",
        n_layers=36, d_model=4096, vocab=49152,
        n_heads=32, n_kv_heads=8, d_ff=14336,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite_8b_smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, d_ff=128,
    )
