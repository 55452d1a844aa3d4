"""InternVL2-76B — VLM: InternViT frontend (STUB) + InternLM2-76B backbone.

[arXiv:2404.16821] Backbone: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256. Per assignment spec, the vision frontend is a stub:
``input_specs()`` provides precomputed patch embeddings (already projected
to d_model) that are prepended to the text token sequence.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_tokens=256,   # ViT patch embeddings per image (stub)
    window=4096,
    n_global=128,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="internvl2-76b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_head=32, d_ff=384, vocab_size=512,
        frontend_tokens=8, window=64, n_global=8,
    )
