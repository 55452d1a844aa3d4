"""Graphormer_slim (GPH_slim) — paper Table IV: 4L, hidden 64, 8 heads.

Graph transformer with degree encodings + SPD/adjacency attention bias,
dual-interleaved attention, cluster-aware graph parallelism.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="graphormer-slim",
    family="graph",
    n_layers=4,
    d_model=64,
    n_heads=8,
    n_kv_heads=8,
    d_head=8,
    d_ff=256,
    vocab_size=0,
    feat_dim=128,
    n_classes=40,
    graph_bias="adj",
    max_degree=512,
    max_spd=16,
    causal=False,
    attn_backend="cluster_sparse",
    interleave_period=8,    # dense attention every 8 steps (paper §III-B)
    elastic_every=1,        # full-graph task: 1 step = 1 epoch (§III-D)
    n_global=1,             # [graph] global token
    rope_theta=0.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="graphormer-slim-smoke", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=4, d_head=8, d_ff=64, feat_dim=16, n_classes=4,
    )
