"""GT (Dwivedi & Bresson) — paper Table IV: 4L, hidden 128, 8 heads.

Uses Laplacian positional encodings instead of degree encodings and no
SPD bias (adjacency bias only in our cluster-sparse layout).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gt",
    family="graph",
    n_layers=4,
    d_model=128,
    n_heads=8,
    n_kv_heads=8,
    d_head=16,
    d_ff=512,
    vocab_size=0,
    feat_dim=128,
    n_classes=40,
    graph_bias=None,       # GT: no SPD bias; lap-PE added to inputs
    max_degree=512,
    causal=False,
    attn_backend="cluster_sparse",
    interleave_period=8,
    elastic_every=1,
    n_global=1,
    rope_theta=0.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="gt-smoke", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
        d_head=8, d_ff=64, feat_dim=16, n_classes=4,
    )
