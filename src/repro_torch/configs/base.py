"""Model configuration: the port's copy of ``repro.configs.base.ModelConfig``
(field for field, so a config compares equal to its JAX counterpart) and
a registry of the graph archs the port serves so far.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio | graph
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_kv_heads: int = 0           # 0 -> = n_heads
    d_head: int = 0               # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0             # per-expert hidden dim
    moe_every: int = 1            # MoE every k-th layer (others dense FFN)
    moe_shared_experts: int = 0
    n_dense_layers: int = 0       # leading dense-FFN layers (Kimi-K2: 1)
    dense_d_ff: int = 0           # hidden dim of those dense layers
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    expand: int = 2               # d_inner = expand * d_model
    attn_every: int = 0           # hybrid: 1 attention layer every k layers
    # --- enc-dec ---
    enc_layers: int = 0
    # --- modality frontend stubs (vlm/audio) ---
    frontend: Optional[str] = None   # vision | audio
    frontend_tokens: int = 0         # patches / frames prepended to sequence
    # --- attention backend ---
    attn_backend: str = "dense"      # dense | cluster_sparse
    window: int = 0                  # local-window block width (LM sparse mode)
    n_global: int = 0                # global (sink) tokens
    causal: bool = True
    # --- graph transformer (paper's own models) ---
    graph_bias: Optional[str] = None  # spd | adj
    feat_dim: int = 0
    n_classes: int = 0
    max_degree: int = 512
    max_spd: int = 16
    interleave_period: int = 0       # dense-attention interleave cadence
    elastic_every: int = 0           # steps per AutoTuner epoch (0 = frozen)
    # --- numerics / perf knobs ---
    dtype: str = "bfloat16"
    remat: str = "block"             # none | block | full
    attn_chunk_q: int = 2048         # jnp flash-path q/k chunk sizes
    attn_chunk_k: int = 1024

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# the archs the port serves so far (graph family only)
ARCHS = ["graphormer_slim", "graphormer_large"]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def _module(arch: str):
    arch = _ALIASES.get(arch, arch)
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; the port has {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
