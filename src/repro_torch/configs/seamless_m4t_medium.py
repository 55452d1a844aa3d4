"""SeamlessM4T-medium — encoder-decoder multimodal (audio frontend STUB).

[arXiv:2308.11596] 12L encoder + 12L decoder, d_model=1024 16H (kv=16)
d_ff=4096, vocab=256206. The speech frontend (w2v-BERT conformer) is a
stub per assignment spec: ``input_specs()`` provides precomputed frame
embeddings at d_model, consumed by the text-style encoder stack.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,            # decoder layers
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio",
    frontend_tokens=1024,   # precomputed speech frames per utterance (stub)
    rope_theta=10_000.0,    # original uses sinusoidal PE; RoPE here (DESIGN.md)
    causal=True,            # decoder causal; encoder bidirectional
    window=4096,
    n_global=128,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="seamless-smoke", n_layers=2, enc_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_head=32, d_ff=256, vocab_size=512,
        frontend_tokens=16, window=64, n_global=8,
    )
