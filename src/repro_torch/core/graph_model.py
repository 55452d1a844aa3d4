"""Graphormer on the port: degree encodings + cluster-sparse attention
over the reformation layout — the serving half of
``repro.core.graph_model`` (``graph_defs``, ``graph_forward`` with
``dense=False``, ``apply_head``, ``graph_predict``).

Batch layout (built by data/graph_pipeline.py, moved to the device by
:func:`batch_to_torch`):
  feat       (B, S, F)      node features, zeros at global/pad positions
  in_deg     (B, S)         clipped degrees (0 at global/pad)
  out_deg    (B, S)
  block_idx  (B, nq, mb)    cluster-sparse layout, int32
  buckets    (B, nq, mb, bq, bk) int8 bias/mask buckets

Parameters are fp32; compute runs in ``cfg.dtype``. The dense interleave
step and the losses wait for the training slice.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L

# numpy batch arrays -> the torch dtype each lives in on the device
_BATCH_DTYPES = {"feat": torch.float32, "in_deg": torch.long,
                 "out_deg": torch.long, "block_idx": torch.int32,
                 "buckets": torch.int8}


def _n_buckets(cfg) -> int:
    # SPD: hop counts 0..max_spd + the global-token virtual-distance bucket
    return (cfg.max_spd + 2) if cfg.graph_bias == "spd" else 3


def graph_defs(cfg) -> dict:
    """``{name: (shape, init)}`` of every parameter, per layer for the
    ``layers.*`` entries (the model holds ``n_layers`` of each). Shapes
    and init families are the reference's: ``fan_in`` is a normal scaled
    by ``shape[0] ** -0.5``, ``normal``/``embed`` a normal scaled by 0.02."""
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    defs = {
        "feat_proj": ((cfg.feat_dim, D), "fan_in"),
        "global_tok": ((max(cfg.n_global, 1), D), "normal"),
        "layers.attn_norm.scale": ((D,), "ones"),
        "layers.attn.wq": ((D, H, Dh), "fan_in"),
        "layers.attn.wk": ((D, KV, Dh), "fan_in"),
        "layers.attn.wv": ((D, KV, Dh), "fan_in"),
        "layers.attn.wo": ((H, Dh, D), "fan_in"),
        "layers.mlp_norm.scale": ((D,), "ones"),
        "layers.mlp.w_gate": ((D, cfg.d_ff), "fan_in"),
        "layers.mlp.w_up": ((D, cfg.d_ff), "fan_in"),
        "layers.mlp.w_down": ((cfg.d_ff, D), "fan_in"),
        "final_norm.scale": ((D,), "ones"),
        "head": ((D, cfg.n_classes), "fan_in"),
    }
    if cfg.name.startswith("graphormer"):
        defs["z_in"] = ((cfg.max_degree, D), "embed")
        defs["z_out"] = ((cfg.max_degree, D), "embed")
    if cfg.graph_bias:
        defs["bias_table"] = ((cfg.n_heads, _n_buckets(cfg)), "zeros")
    return defs


def _def_name(name: str) -> str:
    """``layers.3.attn.wq`` -> ``layers.attn.wq``."""
    parts = name.split(".")
    if parts[0] == "layers":
        del parts[1]
    return ".".join(parts)


class GraphLayer(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.attn_norm = L.RMSNorm(cfg.d_model, device=device)
        self.attn = L.Attention(cfg, device=device)
        self.mlp_norm = L.RMSNorm(cfg.d_model, device=device)
        self.mlp = L.MLP(cfg, device=device)


class GraphModel(nn.Module):
    """Graphormer with the reference's parameter names and shapes, so a
    JAX parameter tree loads through ``convert.params_from_jax``.
    ``seed`` drives the port's own init (same shapes and init families as
    the reference, other random numbers)."""

    def __init__(self, cfg, *, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.family != "graph":
            raise ValueError(f"GraphModel is the graph family, got "
                             f"{cfg.family!r}")
        dev = resolve(device)
        self.cfg = cfg
        defs = graph_defs(cfg)
        for name, (shape, _) in defs.items():
            if "." not in name:
                setattr(self, name, nn.Parameter(torch.empty(shape,
                                                             device=dev)))
        self.layers = nn.ModuleList(GraphLayer(cfg, device=dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, device=dev)
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.head.device

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Seeded init, drawn on the CPU in registration order so the
        weights do not depend on the device."""
        gen = torch.Generator().manual_seed(seed)
        defs = graph_defs(self.cfg)
        for name, p in self.named_parameters():
            shape, init = defs[_def_name(name)]
            assert tuple(p.shape) == shape, (name, p.shape, shape)
            if init == "zeros":
                p.zero_()
            elif init == "ones":
                p.fill_(1.0)
            else:
                scale = shape[0] ** -0.5 if init == "fan_in" else 0.02
                p.copy_(torch.randn(shape, generator=gen) * scale)

    def forward(self, batch: dict, *, impl: str | None = None):
        return graph_forward(self, batch, impl=impl)


def batch_to_torch(batch: dict, device) -> dict:
    """The numpy batch of ``prepare_node_task`` as tensors on ``device``
    (the keys the forward reads)."""
    dev = resolve(device)
    return {key: torch.from_numpy(np.ascontiguousarray(batch[key])).to(
        device=dev, dtype=dt) for key, dt in _BATCH_DTYPES.items()
        if key in batch}


def _graph_attn(p: L.Attention, h, batch, bias_table, impl):
    q, k, v = L.project_qkv(p, h)
    o = kops.cluster_attention(q, k, v, batch["block_idx"],
                               batch.get("buckets"), bias_table,
                               causal=False, impl=impl)
    return L.out_proj(p, o)


def graph_forward(model: GraphModel, batch: dict, *,
                  impl: str | None = None):
    """(B, S, D) final-normed hidden states. ``impl="plain"`` runs the
    attention's plain version on any device (for holding the kernel
    against it)."""
    cfg = model.cfg
    dtype = getattr(torch, cfg.dtype)
    feat = batch["feat"].to(dtype)
    h = feat @ model.feat_proj.to(dtype)
    if hasattr(model, "z_in"):
        h = h + model.z_in[batch["in_deg"]].to(dtype)
        h = h + model.z_out[batch["out_deg"]].to(dtype)
    if cfg.n_global:
        # the leading n_global positions are the global tokens
        h[:, :cfg.n_global] = model.global_tok[:cfg.n_global].to(dtype)
    bias_table = getattr(model, "bias_table", None)
    for layer in model.layers:
        a = L.rmsnorm(layer.attn_norm, h, cfg.norm_eps)
        h = h + _graph_attn(layer.attn, a, batch, bias_table, impl)
        m = L.rmsnorm(layer.mlp_norm, h, cfg.norm_eps)
        h = h + L.mlp(layer.mlp, m)
    return L.rmsnorm(model.final_norm, h, cfg.norm_eps)


def apply_head(model: GraphModel, h):
    """(B, S, D) hidden states -> (B, S, n_classes) logits."""
    return h @ model.head.to(h.dtype)


def graph_predict(model: GraphModel, batch: dict, *,
                  impl: str | None = None):
    return apply_head(model, graph_forward(model, batch, impl=impl))

