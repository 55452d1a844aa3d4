"""Mamba2-2.7B — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060] 64L d_model=2560, d_inner=2*d_model=5120, ssm_state=128,
head_dim=64 (80 SSM heads), conv=4, vocab=50280. No attention, no FFN
(the Mamba2 block subsumes both).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    d_head=64,              # unused (attention-free)
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,        # -> 80 heads at d_inner=5120
    ssm_chunk=256,
    expand=2,
    conv_width=4,
    tie_embeddings=True,
    causal=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="mamba2-smoke", n_layers=2, d_model=128, ssm_state=16,
        ssm_head_dim=32, ssm_chunk=32, vocab_size=512,
    )
