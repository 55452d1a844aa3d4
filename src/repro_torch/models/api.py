"""The SSM family's LM on the port (Mamba2): the port of the ssm half of
``repro.models.api`` (``ssm_lm_defs``, ``ssm_lm_forward``,
``ssm_lm_loss``), as an ``nn.Module`` with the reference's parameter
names, so a JAX parameter tree loads through ``convert.params_from_jax``.

Each layer is a pre-norm Mamba2 block (``models/ssm.mamba_apply``) with
a residual, under the layer recomputation of every family
(``layers.maybe_remat``, read from ``cfg.remat``). The loss is the
chunked cross-entropy of the dense LMs, named ``"sparse"`` as every
family's primary loss is. Decode (``ssm_lm_decode``, ``ssm_cache_defs``)
is not ported yet (ROADMAP.md A9).
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models.ssm import Mamba, mamba_apply, mamba_defs


def ssm_lm_defs(cfg) -> dict:
    """``{name: (shape, init)}`` of every parameter, per layer for the
    ``layers.*`` entries: the reference's ``ssm_lm_defs`` names and
    shapes."""
    D = cfg.d_model
    defs = {
        "embed.tok": ((cfg.vocab_padded, D), "embed"),
        "final_norm.scale": ((D,), "ones"),
        "layers.norm.scale": ((D,), "ones"),
        **{f"layers.mamba.{k}": v for k, v in mamba_defs(cfg).items()},
    }
    if not cfg.tie_embeddings:
        defs["embed.unembed"] = ((D, cfg.vocab_padded), "fan_in")
    return defs


class SSMLayer(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.norm = L.RMSNorm(cfg.d_model, device=device)
        self.mamba = Mamba(cfg, device=device)


class SSMLMModel(nn.Module):
    """An attention-free Mamba2 LM with the reference's parameter names
    and shapes. ``seed`` drives the port's own init."""

    def __init__(self, cfg, *, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"SSMLMModel is the ssm family, got "
                             f"{cfg.family!r}")
        dev = resolve(device)
        self.cfg = cfg
        self.embed = L.Embedding(cfg, device=dev)
        self.final_norm = L.RMSNorm(cfg.d_model, device=dev)
        self.layers = nn.ModuleList(SSMLayer(cfg, device=dev)
                                    for _ in range(cfg.n_layers))
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def reset_parameters(self, seed: int = 0) -> None:
        """Seeded init (``layers.seeded_init``)."""
        L.seeded_init(self, ssm_lm_defs(self.cfg), seed)

    @property
    def loss_variants(self) -> dict:
        """The named losses a task trains: ``{"sparse": ssm_lm_loss}``."""
        return {"sparse": ssm_lm_loss}


def _layer(layer: SSMLayer, h, cfg):
    a, _ = mamba_apply(layer.mamba, cfg,
                       L.rmsnorm(layer.norm, h, cfg.norm_eps))
    return h + a


def ssm_lm_forward(model: SSMLMModel, batch: dict):
    """-> final hidden states (B, S, D) after the final norm.
    ``batch["tokens"]`` is (B, S) int on the model's device."""
    cfg = model.cfg
    h = L.embed_tokens(model.embed, batch["tokens"], getattr(torch,
                                                             cfg.dtype))
    body = L.maybe_remat(functools.partial(_layer, cfg=cfg), cfg)
    for layer in model.layers:
        h = body(layer, h)
    return L.rmsnorm(model.final_norm, h, cfg.norm_eps)


def ssm_lm_loss(model: SSMLMModel, batch: dict):
    """Mean next-token cross-entropy over ``batch["labels"]`` (-1
    ignored), in sequence chunks: ``(loss, {"xent": loss})``."""
    h = ssm_lm_forward(model, batch)
    loss = L.chunked_softmax_xent(model.embed, model.cfg, h, batch["labels"])
    return loss, {"xent": loss}


def ssm_lm_decode(*args, **kwargs):
    raise NotImplementedError("SSM LM decode is not ported yet "
                              "(ROADMAP.md A9)")


def ssm_cache_defs(*args, **kwargs):
    raise NotImplementedError("the SSM LM decode cache is not ported yet "
                              "(ROADMAP.md A9)")
