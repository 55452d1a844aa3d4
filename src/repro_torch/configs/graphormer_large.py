"""Graphormer_large (GPH_large) — paper Table IV: 12L, hidden 768, 32 heads."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="graphormer-large",
    family="graph",
    n_layers=12,
    d_model=768,
    n_heads=32,
    n_kv_heads=32,
    d_head=24,
    d_ff=3072,
    vocab_size=0,
    feat_dim=128,
    n_classes=47,
    graph_bias="adj",
    max_degree=512,
    max_spd=16,
    causal=False,
    attn_backend="cluster_sparse",
    interleave_period=8,
    elastic_every=1,
    n_global=1,
    rope_theta=0.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="graphormer-large-smoke", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=4, d_head=8, d_ff=64, feat_dim=16, n_classes=4,
    )
