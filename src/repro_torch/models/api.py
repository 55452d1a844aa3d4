"""The SSM family's LM on the port (Mamba2): the port of the ssm half of
``repro.models.api`` (``ssm_lm_defs``, ``ssm_lm_forward``,
``ssm_lm_loss``), as an ``nn.Module`` with the reference's parameter
names, so a JAX parameter tree loads through ``convert.params_from_jax``.

Each layer is a pre-norm Mamba2 block (``models/ssm.mamba_apply``) with
a residual, under the layer recomputation of every family
(``layers.maybe_remat``, read from ``cfg.remat``). The loss is the
chunked cross-entropy of the dense LMs, named ``"sparse"`` as every
family's primary loss is. Serving: ``ssm_lm_prefill`` (the last token's
logits of the full forward, and no cache, as the reference's
``_ssm_prefill``), ``ssm_lm_decode`` (one token through every block's
``mamba_decode``) over the caches of ``ssm_cache_defs``. The recurrent
state is no positional KV cache, so the model has no paged serving
path: its ``prefill_chunk``, ``paged_decode`` and ``paged_cache_defs``
are None, as the reference's ``Model`` fields are.

On a mesh (``parallel.axes.axis_rules``) each rank holds S/P tokens of
the sequence and each block runs ``models/ssm.mamba_mixer``
(its H/P SSM heads on the gathered sequence, or the whole block where
the heads do not split); the loss is the mean over every rank's shard.

``lm_model_class`` picks the port's model class of a token-LM config by
its family, as the reference's ``build`` does: ``SSMLMModel``,
``models/hybrid.HybridLMModel``, ``models/encdec.EncDecModel`` or
``models/lm.LMModel`` (dense, MoE, VLM).
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models.ssm import (Mamba, mamba_cache_defs, mamba_decode,
                                    mamba_defs, mamba_mixer)
from repro_torch.parallel import axes as pax


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

    # the serving contract (the reference's ``models/api.Model`` fields);
    # no paged path for a recurrent state
    prefill_chunk = paged_decode = paged_cache_defs = None

    def prefill(self, batch: dict):
        """``(logits (B, 1, V), {})``: :func:`ssm_lm_prefill`."""
        return ssm_lm_prefill(self, batch)

    def decode(self, cache: dict, tokens, pos, *, sparse: bool = False):
        """``(logits (B, 1, V), new_cache)``: :func:`ssm_lm_decode`."""
        return ssm_lm_decode(self, cache, tokens, pos, sparse=sparse)

    def cache_defs(self, batch: int, seq_len: int) -> dict:
        """Zeroed caches on the model's device: :func:`ssm_cache_defs`."""
        return ssm_cache_defs(self.cfg, batch, seq_len, device=self.device)


def lm_model_class(cfg) -> type:
    """The model class of a token-LM config's family: ``ssm`` ->
    :class:`SSMLMModel`, ``hybrid`` -> ``HybridLMModel``, ``encdec`` ->
    ``EncDecModel``, anything else (dense, moe, vlm) -> ``LMModel``
    (which raises for a family it does not hold)."""
    from repro_torch.models.encdec import EncDecModel
    from repro_torch.models.hybrid import HybridLMModel
    from repro_torch.models.lm import LMModel

    return {"ssm": SSMLMModel, "hybrid": HybridLMModel,
            "encdec": EncDecModel}.get(cfg.family, LMModel)


def _layer(layer: SSMLayer, h, cfg, group):
    return h + mamba_mixer(layer.mamba, cfg,
                           L.rmsnorm(layer.norm, h, cfg.norm_eps), group)


def ssm_lm_forward(model: SSMLMModel, batch: dict):
    """-> final hidden states (B, S, D) after the final norm.
    ``batch["tokens"]`` is (B, S) int on the model's device."""
    cfg = model.cfg
    h = L.embed_tokens(model.embed, batch["tokens"], getattr(torch,
                                                             cfg.dtype))
    body = L.maybe_remat(functools.partial(_layer, cfg=cfg,
                                           group=pax.seq_group()), cfg)
    for layer in model.layers:
        h = body(layer, h)
    return L.rmsnorm(model.final_norm, h, cfg.norm_eps)


def ssm_lm_loss(model: SSMLMModel, batch: dict):
    """Mean next-token cross-entropy over ``batch["labels"]`` (-1
    ignored), in sequence chunks: ``(loss, {"xent": loss})``; on a mesh
    the mean over every rank's shard."""
    h = ssm_lm_forward(model, batch)
    loss = L.chunked_softmax_xent(model.embed, model.cfg, h, batch["labels"],
                                  group=pax.mesh_group())
    return loss, {"xent": loss}


def ssm_lm_prefill(model: SSMLMModel, batch: dict):
    """The last token's logits ``(B, 1, V)`` of the full forward, and no
    cache (``{}``), as the reference's ``_ssm_prefill``."""
    h = ssm_lm_forward(model, batch)
    return L.logits_fn(model.embed, model.cfg, h[:, -1:]), {}


def ssm_lm_decode(model: SSMLMModel, cache: dict, tokens, pos, *,
                  sparse: bool = False):
    """One decode step: tokens (B, 1) int through every layer's
    ``mamba_decode``. ``pos`` and ``sparse`` are the decode contract's
    and unused: the state carries the position. Returns ``(logits (B, 1,
    V), new_cache)``, the layers' new caches stacked as ``cache``."""
    cfg = model.cfg
    h = L.embed_tokens(model.embed, tokens, getattr(torch, cfg.dtype))
    conv, state = cache["layers"]["conv"], cache["layers"]["ssm"]
    convs, states = [], []
    for i, layer in enumerate(model.layers):
        a, cc = mamba_decode(layer.mamba, cfg,
                             L.rmsnorm(layer.norm, h, cfg.norm_eps),
                             {"conv": conv[i], "ssm": state[i]})
        h = h + a
        convs.append(cc["conv"])
        states.append(cc["ssm"])
    h = L.rmsnorm(model.final_norm, h, cfg.norm_eps)
    return L.logits_fn(model.embed, cfg, h), {
        "layers": {"conv": torch.stack(convs), "ssm": torch.stack(states)}}


def ssm_cache_defs(cfg, batch: int, seq_len: int, *, device="cpu") -> dict:
    """Zeroed decode caches on ``device``: ``{"layers": {"conv", "ssm"}}``,
    each layer's ``mamba_cache_defs`` stacked on a leading layer axis;
    ``seq_len`` is the contract's and unused (the state has no length)."""
    one = mamba_cache_defs(cfg, batch, device=device)
    return {"layers": {k: v.new_zeros((cfg.n_layers, *v.shape))
                       for k, v in one.items()}}


def batch_spec(cfg, shape, *, device="cuda") -> dict:
    """Empty stand-ins for every model input of one cell (``shape`` a
    ``ShapeConfig``), the reference's ``models/api.batch_spec``: the
    same names, shapes and dtypes. To train or prefill, ``tokens`` (B, S)
    int32 (``labels`` too to train); the VLM's ``patches`` (B, Tp, D)
    bf16 before ``S - Tp`` tokens, the encoder-decoder's ``frames`` (B,
    Tf, D) bf16 beside S tokens; to decode, one token a sequence, (B, 1).
    The tensors are uninitialised: the function is meant to be called
    under a fake mode (``repro_torch.fake``), where nothing is
    allocated."""
    B, S, D = shape.global_batch, shape.seq_len, cfg.d_model

    def ints(*dims):
        return torch.empty(dims, dtype=torch.int32, device=device)

    def bf16(*dims):
        return torch.empty(dims, dtype=torch.bfloat16, device=device)

    if shape.kind == "decode":
        return {"tokens": ints(B, 1)}
    T = S
    out = {}
    if cfg.family == "vlm":
        out["patches"] = bf16(B, cfg.frontend_tokens, D)
        T = S - cfg.frontend_tokens
    elif cfg.family == "encdec":
        out["frames"] = bf16(B, cfg.frontend_tokens, D)
    out["tokens"] = ints(B, T)
    if shape.kind == "train":
        out["labels"] = ints(B, T)
    return out
