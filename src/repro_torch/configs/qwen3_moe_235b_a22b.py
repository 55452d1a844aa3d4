"""Qwen3-235B-A22B — MoE LM, 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B family] 94L d_model=4096 64H (GQA kv=4)
expert d_ff=1536, vocab=151936, 128 experts top-8, qk_norm, head_dim=128.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=1536,              # = expert dim (spec lists it as d_ff)
    vocab_size=151936,
    qk_norm=True,
    moe_experts=128,
    moe_top_k=8,
    moe_d_ff=1536,
    moe_every=1,
    rope_theta=1_000_000.0,
    window=4096,
    n_global=128,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-moe-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_head=32, d_ff=128, vocab_size=512,
        moe_experts=8, moe_top_k=2, moe_d_ff=128, window=64, n_global=8,
    )
