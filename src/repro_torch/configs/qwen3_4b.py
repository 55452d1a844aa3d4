"""Qwen3-4B — dense GQA LM with qk_norm.

[hf:Qwen/Qwen3-8B family] 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, head_dim=128, qk_norm.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    window=4096,
    n_global=128,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-4b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_head=32, d_ff=384, vocab_size=512, window=64,
        n_global=8,
    )
