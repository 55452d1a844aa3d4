"""Jamba-v0.1 (52B total / 12B active) — hybrid Mamba+attention with MoE.

[arXiv:2403.19887] 32L d_model=4096, attention 32H (GQA kv=8) d_ff=14336,
vocab=65536. Attention:Mamba ratio 1:7 (one attention layer per 8-layer
block, at in-block index 4); MoE every other layer, 16 experts top-2.
SSM: d_inner=2*d_model, state=16, conv=4.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=65536,
    attn_every=8,            # 1:7 attention:mamba interleave
    moe_experts=16,
    moe_top_k=2,
    moe_d_ff=14336,
    moe_every=2,             # MoE every other layer
    ssm_state=16,
    ssm_head_dim=64,
    expand=2,
    conv_width=4,
    rope_theta=0.0,          # Jamba uses no positional encoding
    window=4096,
    n_global=128,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="jamba-52b-smoke", n_layers=8, d_model=128, n_heads=4,
        n_kv_heads=2, d_head=32, d_ff=256, vocab_size=512,
        moe_experts=4, moe_top_k=2, moe_d_ff=256, ssm_state=16,
        ssm_chunk=32, window=64, n_global=8,
    )
