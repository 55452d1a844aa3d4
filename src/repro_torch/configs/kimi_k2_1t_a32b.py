"""Kimi-K2 — trillion-parameter MoE (paper-table config), 384 experts top-8.

[arXiv:2501.kimi2 / DeepSeek-V3-style] 61L d_model=7168 64H (GQA kv=8 per
assignment) expert d_ff=2048, vocab=163840, 384 experts top-8 + 1 shared
expert, first layer dense FFN (d_ff=18432), head_dim=128.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=2048,               # = expert dim
    vocab_size=163840,
    moe_experts=384,
    moe_top_k=8,
    moe_d_ff=2048,
    moe_every=1,
    moe_shared_experts=1,
    n_dense_layers=1,
    dense_d_ff=18432,
    rope_theta=50_000.0,
    window=4096,
    n_global=128,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="kimi-k2-smoke", n_layers=3, d_model=128, n_heads=4,
        n_kv_heads=2, d_head=32, d_ff=128, vocab_size=512,
        moe_experts=8, moe_top_k=2, moe_d_ff=128, n_dense_layers=1,
        dense_d_ff=256, window=64, n_global=8,
    )
