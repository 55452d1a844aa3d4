"""SmolLM-135M — llama-arch small dense LM.

[hf:HuggingFaceTB/SmolLM-135M] 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152, head_dim=64, tied embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_head=64,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    rope_theta=10_000.0,
    window=4096,      # cluster-sparse (long-context) block window
    n_global=128,     # global/sink tokens
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="smollm-135m-smoke", n_layers=2, d_model=96, n_heads=3,
        n_kv_heads=3, d_head=32, d_ff=256, vocab_size=512, window=64,
        n_global=8,
    )
