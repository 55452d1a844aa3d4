"""Decoder-only LM of the dense family (llama / qwen3) on the port — the
port of ``repro.models.lm``'s training path (``lm_defs``, ``attn_apply``
in its mesh-free branch, ``lm_forward``, ``lm_loss``).

Attention dispatches as the reference's does:

* ``cfg.attn_backend == "cluster_sparse"`` and S >= 256: the TorchGT
  cluster-sparse op (``kernels/ops.cluster_attention``) over the token
  LM's local+global layout (``core/reformation.lm_local_global_layout``,
  ``bq = bk = 128``, ``cfg.window``, ``cfg.n_global``), causal when
  ``cfg.causal``. On CUDA tensors that is the unbiased forward kernel
  and, under autograd, the unbiased dQ and dK/dV kernels;
* otherwise the plain chunked attention (``models/layers.py``).

The layout depends on the shape only: the model builds it on the host
once per (S, window, n_global, causal) and uploads it once, with its
transposed form for the dK/dV backward (``LMModel.layout``).

Each layer runs under the reference's recomputation (``_maybe_remat``),
read from ``cfg.remat`` when grad is enabled (``layers.maybe_remat``):
``"none"`` keeps every activation; ``"dots"`` keeps the outputs of the
un-batched products (the projections and the MLP) and recomputes the
rest, the attention op included; any other value keeps only the layer's
input and recomputes the whole layer in the backward. Under
recomputation each attention forward kernel launches twice per layer
and step, the dQ and dK/dV kernels once. Not ported, each raising
``NotImplementedError`` naming its ``ROADMAP.md`` item: MoE, VLM and
the leading dense layers of ``n_dense_layers`` (A10), prefill, decode
and the paged cache (A9). There is no mesh, so no Ulysses or
sequence-parallel attention (A8).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from repro_torch.core.reformation import lm_local_global_layout
from repro_torch.device import resolve
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L

LM_BLOCK = 128      # bq = bk of the local+global layout (reference lm.py)


def lm_defs(cfg) -> dict:
    """``{name: (shape, init)}`` of every parameter of a dense LM, per
    layer for the ``layers.*`` entries: the reference's ``lm_defs``
    names and shapes."""
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    FF, Vp = cfg.d_ff, cfg.vocab_padded
    defs = {
        "embed.tok": ((Vp, D), "embed"),
        "final_norm.scale": ((D,), "ones"),
        "layers.attn_norm.scale": ((D,), "ones"),
        "layers.attn.wq": ((D, H, Dh), "fan_in"),
        "layers.attn.wk": ((D, KV, Dh), "fan_in"),
        "layers.attn.wv": ((D, KV, Dh), "fan_in"),
        "layers.attn.wo": ((H, Dh, D), "fan_in"),
        "layers.mlp_norm.scale": ((D,), "ones"),
        "layers.mlp.w_gate": ((D, FF), "fan_in"),
        "layers.mlp.w_up": ((D, FF), "fan_in"),
        "layers.mlp.w_down": ((FF, D), "fan_in"),
    }
    if not cfg.tie_embeddings:
        defs["embed.unembed"] = ((D, Vp), "fan_in")
    if cfg.qk_norm:
        defs["layers.attn.q_norm"] = ((Dh,), "ones")
        defs["layers.attn.k_norm"] = ((Dh,), "ones")
    return defs


class LMLayer(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.attn_norm = L.RMSNorm(cfg.d_model, device=device)
        self.attn = L.Attention(cfg, device=device)
        self.mlp_norm = L.RMSNorm(cfg.d_model, device=device)
        self.mlp = L.MLP(cfg, device=device)


class LMModel(nn.Module):
    """A dense decoder-only LM with the reference's parameter names and
    shapes, so a JAX parameter tree loads through
    ``convert.params_from_jax``. ``seed`` drives the port's own init."""

    def __init__(self, cfg, *, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.family == "ssm":
            raise ValueError(f"{cfg.name}: the ssm family is "
                             f"models/api.SSMLMModel, not LMModel")
        if cfg.family != "dense" or cfg.moe_experts or cfg.frontend:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family (MoE, VLM, hybrid, "
                f"enc-dec) is not ported yet (ROADMAP.md A10)")
        if cfg.n_dense_layers or cfg.dense_d_ff:
            raise NotImplementedError(
                f"{cfg.name}: leading dense layers (n_dense_layers, "
                f"dense_d_ff) are not ported yet (ROADMAP.md A10)")
        if cfg.attn_backend not in ("dense", "cluster_sparse"):
            raise ValueError(f"attn_backend {cfg.attn_backend!r} not in "
                             f"('dense', 'cluster_sparse')")
        dev = resolve(device)
        self.cfg = cfg
        self.embed = L.Embedding(cfg, device=dev)
        self.final_norm = L.RMSNorm(cfg.d_model, device=dev)
        self.layers = nn.ModuleList(LMLayer(cfg, device=dev)
                                    for _ in range(cfg.n_layers))
        self.reset_parameters(seed)
        self._layouts = {}

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def layout(self, S: int):
        """``(block_idx, block_idx_t)`` of the local+global layout for
        sequences of length ``S`` on the model's device: built on the host
        and uploaded once per (S, window, n_global, causal)."""
        cfg = self.cfg
        key = (S, cfg.window, cfg.n_global, cfg.causal)
        if key not in self._layouts:
            lay = lm_local_global_layout(S, bq=LM_BLOCK, bk=LM_BLOCK,
                                         window=cfg.window,
                                         n_global=cfg.n_global,
                                         causal=cfg.causal)
            if lay.seq_len != S:
                raise ValueError(f"the cluster-sparse LM path tiles S in "
                                 f"blocks of {LM_BLOCK}; S={S} is not a "
                                 f"multiple")
            self._layouts[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (lay.block_idx, lay.block_idx_t))
        return self._layouts[key]

    def reset_parameters(self, seed: int = 0) -> None:
        """Seeded init (``layers.seeded_init``)."""
        L.seeded_init(self, lm_defs(self.cfg), seed)

    @property
    def loss_variants(self) -> dict:
        """The named losses a task trains: ``{"sparse": lm_loss}``."""
        return {"sparse": lm_loss}


def attention_fn(model: LMModel, S: int, impl: str | None = None):
    """``fn(q, k, v) -> o`` for sequences of length ``S``: the
    cluster-sparse op over the local+global layout, or the plain chunked
    attention (the reference's ``attn_apply`` dispatch, mesh-free).
    ``impl="plain"`` runs the sparse op's plain versions on any device."""
    cfg = model.cfg
    if cfg.attn_backend == "cluster_sparse" and S >= 2 * LM_BLOCK:
        bi, bit = model.layout(S)
        return lambda q, k, v: kops.cluster_attention(
            q, k, v, bi, None, None, bit, causal=cfg.causal, impl=impl)
    return lambda q, k, v: L.chunked_attention(
        q, k, v, causal=cfg.causal, chunk_q=cfg.attn_chunk_q,
        chunk_k=cfg.attn_chunk_k)


def _layer(layer: LMLayer, h, cfg, pos, attn):
    """One decoder layer: pre-norm attention and SwiGLU MLP, residual."""
    a = L.rmsnorm(layer.attn_norm, h, cfg.norm_eps)
    q, k, v = L.project_qkv(layer.attn, cfg, a, pos)
    h = h + L.out_proj(layer.attn, attn(q, k, v))
    m = L.rmsnorm(layer.mlp_norm, h, cfg.norm_eps)
    return h + L.mlp(layer.mlp, m)


def lm_forward(model: LMModel, batch: dict, *, impl: str | None = None):
    """-> (final hidden states (B, S, D) after the final norm, aux loss).
    ``batch["tokens"]`` is (B, S) int on the model's device. The aux loss
    is the MoE balance term: 0 for a dense model, as in the reference."""
    cfg = model.cfg
    dtype = getattr(torch, cfg.dtype)
    tokens = batch["tokens"]
    h = L.embed_tokens(model.embed, tokens, dtype)
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    if cfg.rope_theta:   # one rotation table for every layer
        pos = L.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    body = L.maybe_remat(functools.partial(
        _layer, cfg=cfg, pos=pos, attn=attention_fn(model, S, impl)), cfg)
    for layer in model.layers:
        h = body(layer, h)
    h = L.rmsnorm(model.final_norm, h, cfg.norm_eps)
    return h, torch.zeros((), device=h.device)


def lm_loss(model: LMModel, batch: dict, *, aux_coef: float = 0.01,
            impl: str | None = None):
    """Mean next-token cross-entropy over ``batch["labels"]`` (-1
    ignored), computed in sequence chunks without the full logits:
    ``(loss, {"xent": loss, "aux": aux})``."""
    h, aux = lm_forward(model, batch, impl=impl)
    loss = L.chunked_softmax_xent(model.embed, model.cfg, h, batch["labels"])
    return loss + aux_coef * aux, {"xent": loss, "aux": aux}


def lm_prefill(*args, **kwargs):
    raise NotImplementedError("LM prefill is not ported yet (ROADMAP.md A9)")


def lm_decode_step(*args, **kwargs):
    raise NotImplementedError("LM decode is not ported yet (ROADMAP.md A9)")


def lm_paged_decode_step(*args, **kwargs):
    raise NotImplementedError("paged LM decode is not ported yet "
                              "(ROADMAP.md A9)")
