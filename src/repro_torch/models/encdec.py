"""Encoder-decoder backbone (SeamlessM4T-medium) on the port — the port
of ``repro.models.encdec``, as an ``nn.Module`` with the reference's
parameter names, so a JAX parameter tree loads through
``convert.params_from_jax``.

The speech frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``batch["frames"]`` (B, Tf, D).

* ``enc_layers``: a stack of the LM's layer (``attn_norm``, ``attn``,
  ``mlp_norm``, ``mlp``) run non-causal, then ``enc_norm``. Its
  attention's causal flag and its cluster-sparse layout come from the
  encoder (``lm.attention_fn(causal=False)``), never from ``cfg.causal``:
  at Tf == S the encoder and the decoder still get a layout each;
* ``dec_layers``: the same layer with a cross-attention block
  (``cross_norm``, ``cross``) between the self-attention and the MLP,
  then ``final_norm``. Self-attention is the LM's (causal,
  cluster-sparse at S >= 256 under ``attn_backend="cluster_sparse"``);
  the cross-attention projects k and v from the normed encoder output in
  its dtype and attends with the plain ``chunked_attention``
  (non-causal, Sq != Sk), as the reference computes it in jnp;
* the token embeddings are scaled by ``sqrt(d_model)``
  (``layers.embed_tokens`` with the config);
* both stacks recompute their layers in the backward as ``cfg.remat``
  says (``layers.maybe_remat``).

On a mesh (``parallel.axes.axis_rules``) the frames arrive whole on
every rank, as the reference's ``batch_shardings`` gives them, and the
encoder runs on this rank's S/P of them, its self-attention through
``lm.sharded_attention_fn(causal=False)`` (non-causal Ulysses); its
output is all-gathered once (``GatherSeq``, whose backward
reduce-scatters), since every decoder layer's cross-attention takes the
whole encoder sequence. The decoder holds its S/P tokens, its
self-attention sharded as the LM's, and each rank's queries attend the
whole cross k and v (non-causal: no offset). Positions are global, and
the loss is the mean over every rank's shard.

``encdec_loss`` is the chunked cross-entropy (``{"xent"}``), named
``"sparse"`` as every family's primary loss is. Serving:
``encdec_prefill`` (the last token's logits of the full forward and an
empty cache, as the reference's ``_encdec_prefill``),
``encdec_cache_defs`` and ``encdec_decode_step`` (self-attention through
the LM's ``attn_decode``, under the sparse decode mask when ``sparse``;
cross-attention over every frame of the cached ``ck``/``cv``). There is
no paged path (``prefill_chunk``, ``paged_decode`` and
``paged_cache_defs`` are None), so ``ServeEngine`` and the serve CLI
refuse the family, as the reference's do.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.parallel import axes as pax
from repro_torch.parallel import collectives as C


def _layer_defs(cfg, prefix: str, cross: bool) -> dict:
    D = cfg.d_model
    defs = LM._layer_defs(cfg, prefix, False)
    if cross:
        defs[prefix + "cross_norm.scale"] = ((D,), "ones")
        defs.update(L.attention_defs(cfg, prefix + "cross."))
    return defs


def encdec_defs(cfg) -> dict:
    """``{name: (shape, init)}`` of every parameter, per layer for the
    ``enc_layers.*`` and ``dec_layers.*`` entries: the reference's
    ``encdec_defs`` names and shapes."""
    D, Vp = cfg.d_model, cfg.vocab_padded
    defs = {"embed.tok": ((Vp, D), "embed"),
            "enc_norm.scale": ((D,), "ones"),
            "final_norm.scale": ((D,), "ones"),
            **_layer_defs(cfg, "enc_layers.", False),
            **_layer_defs(cfg, "dec_layers.", True)}
    if not cfg.tie_embeddings:
        defs["embed.unembed"] = ((D, Vp), "fan_in")
    return defs


class DecLayer(LM.LMLayer):
    """The LM's layer with a cross-attention block."""

    def __init__(self, cfg, *, device=None):
        super().__init__(cfg, device=device)
        self.cross_norm = L.RMSNorm(cfg.d_model, device=device)
        self.cross = L.Attention(cfg, device=device)


class EncDecModel(nn.Module):
    """An encoder-decoder with the reference's parameter names and
    shapes. ``seed`` drives the port's own init."""

    # the LM's cache of uploaded layouts, keyed on (S, ..., causal)
    layout = LM.LMModel.layout
    # no paged serving path: cross-attention state is no paged KV cache
    prefill_chunk = paged_decode = paged_cache_defs = None

    def __init__(self, cfg, *, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDecModel is the encdec family, got "
                             f"{cfg.family!r}")
        LM._check_attn_backend(cfg)
        dev = resolve(device)
        self.cfg = cfg
        self.embed = L.Embedding(cfg, device=dev)
        self.enc_layers = nn.ModuleList(LM.LMLayer(cfg, device=dev)
                                        for _ in range(cfg.enc_layers))
        self.enc_norm = L.RMSNorm(cfg.d_model, device=dev)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, device=dev)
                                        for _ in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, device=dev)
        self.reset_parameters(seed)
        self._layouts = {}

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def reset_parameters(self, seed: int = 0) -> None:
        """Seeded init (``layers.seeded_init``)."""
        L.seeded_init(self, encdec_defs(self.cfg), seed)

    @property
    def loss_variants(self) -> dict:
        """The named losses a task trains: ``{"sparse": encdec_loss}``."""
        return {"sparse": encdec_loss}

    def prefill(self, batch: dict, **kw):
        """``(logits (B, 1, V), {})``: :func:`encdec_prefill`."""
        return encdec_prefill(self, batch, **kw)

    def decode(self, cache: dict, tokens, pos, *, sparse: bool = False):
        """``(logits (B, 1, V), cache)``: :func:`encdec_decode_step`."""
        return encdec_decode_step(self, cache, tokens, pos, sparse=sparse)

    def cache_defs(self, batch: int, seq_len: int) -> dict:
        """Zeroed caches on the model's device:
        :func:`encdec_cache_defs`."""
        return encdec_cache_defs(self.cfg, batch, seq_len,
                                 device=self.device)


def encode(model: EncDecModel, frames, *, impl: str | None = None):
    """The encoder: ``frames`` (B, Tf, D) cast to the compute dtype,
    through every encoder layer non-causal, then ``enc_norm``: (B, Tf, D).
    On a mesh each rank encodes its Tf/P frames and the output is
    all-gathered."""
    cfg = model.cfg
    h = frames.to(getattr(torch, cfg.dtype))
    group = pax.seq_group()
    if group is not None:
        p, m = C.size(group), C.rank(group)
        if h.shape[1] % p:
            raise ValueError(f"{h.shape[1]} frames do not split {p} ways")
        n = h.shape[1] // p
        h = h[:, m * n:(m + 1) * n]
    Tf = h.shape[1]
    off, attn = LM.offset_and_attention(model, Tf, group, impl, causal=False)
    enc = cfg.replace(causal=False)
    body = L.maybe_remat(functools.partial(
        LM._layer, kv=None, cfg=enc,
        pos=LM._rotation(cfg, torch.arange(off, off + Tf, device=h.device)),
        attn=attn), cfg)
    for layer in model.enc_layers:
        h, _ = body(layer, h)
    h = L.rmsnorm(model.enc_norm, h, cfg.norm_eps)
    return h if group is None else C.GatherSeq.apply(h, group)


def cross_kv(attn: L.Attention, enc_out):
    """The cross-attention's k and v (B, Tf, KV, Dh), projected from the
    normed encoder output in its dtype (no RoPE, no norm)."""
    return L._proj(enc_out, attn.wk), L._proj(enc_out, attn.wv)


def cross_attend(attn: L.Attention, c, ck, cv):
    """The cross-attention of the normed decoder states ``c`` over the
    frames' ``ck``/``cv``: the plain chunked attention, non-causal."""
    q = L._proj(c, attn.wq)
    return L.out_proj(attn, L.chunked_attention(q, ck, cv, causal=False))


def _dec_layer(layer: DecLayer, h, enc_out, cfg, pos, attn):
    a = L.rmsnorm(layer.attn_norm, h, cfg.norm_eps)
    q, k, v = L.project_qkv(layer.attn, cfg, a, pos)
    h = h + L.out_proj(layer.attn, attn(q, k, v))
    c = L.rmsnorm(layer.cross_norm, h, cfg.norm_eps)
    h = h + cross_attend(layer.cross, c, *cross_kv(layer.cross, enc_out))
    m = L.rmsnorm(layer.mlp_norm, h, cfg.norm_eps)
    return h + L.mlp(layer.mlp, m)


def encdec_forward(model: EncDecModel, batch: dict, *,
                   impl: str | None = None):
    """-> the decoder's final hidden states (B, S, D) after
    ``final_norm``. ``batch["frames"]`` (B, Tf, D), ``batch["tokens"]``
    (B, S) int, on the model's device."""
    cfg = model.cfg
    enc_out = encode(model, batch["frames"], impl=impl)
    tokens = batch["tokens"]
    h = L.embed_tokens(model.embed, tokens, getattr(torch, cfg.dtype), cfg)
    S = tokens.shape[1]
    off, attn = LM.offset_and_attention(model, S, pax.seq_group(), impl)
    body = L.maybe_remat(functools.partial(
        _dec_layer, cfg=cfg,
        pos=LM._rotation(cfg, torch.arange(off, off + S,
                                           device=tokens.device)),
        attn=attn), cfg)
    for layer in model.dec_layers:
        h = body(layer, h, enc_out)
    return L.rmsnorm(model.final_norm, h, cfg.norm_eps)


def encdec_loss(model: EncDecModel, batch: dict, *,
                impl: str | None = None):
    """Mean next-token cross-entropy over ``batch["labels"]`` (-1
    ignored), in sequence chunks: ``(loss, {"xent": loss})``."""
    h = encdec_forward(model, batch, impl=impl)
    loss = L.chunked_softmax_xent(model.embed, model.cfg, h, batch["labels"],
                                  group=pax.mesh_group())
    return loss, {"xent": loss}


def encdec_prefill(model: EncDecModel, batch: dict, *,
                   impl: str | None = None):
    """The last token's logits ``(B, 1, V)`` of the full forward, and no
    cache (``{}``), as the reference's ``_encdec_prefill``."""
    h = encdec_forward(model, batch, impl=impl)
    return L.logits_fn(model.embed, model.cfg, h[:, -1:]), {}


def encdec_cache_defs(cfg, batch: int, seq_len: int, *,
                      device="cpu") -> dict:
    """Zeroed decode caches on ``device``: ``{"dec": {"k", "v", "ck",
    "cv"}}``, bf16, stacked on a leading layer axis: the self-attention's
    ``(n_layers, batch, seq_len, KV, Dh)`` and the cross-attention's
    ``(n_layers, batch, frontend_tokens, KV, Dh)`` (the reference's
    ``encdec_cache_defs``). The caller fills ``ck``/``cv`` from
    :func:`encode` and :func:`cross_kv`."""
    KV, Dh = cfg.kv_heads, cfg.head_dim

    def zeros(rows):
        return torch.zeros((cfg.n_layers, batch, rows, KV, Dh),
                           dtype=torch.bfloat16, device=device)
    return {"dec": {"k": zeros(seq_len), "v": zeros(seq_len),
                    "ck": zeros(cfg.frontend_tokens),
                    "cv": zeros(cfg.frontend_tokens)}}


def encdec_decode_step(model: EncDecModel, cache: dict, tokens, pos, *,
                       sparse: bool = False):
    """One decode step: tokens (B, 1) int at position ``pos`` (a host int
    or a 0-d int64 tensor on the device), the self-attention caches
    written in place (``lm.attn_decode``, under the cluster-sparse decode
    mask when ``sparse``), the cross-attention over every frame of
    ``ck``/``cv``. Returns ``(logits (B, 1, V), cache)``."""
    cfg = model.cfg
    dev = tokens.device
    c = cache["dec"]
    window, n_global = LM._sparse_mask(cfg, sparse)
    idx = pos.reshape(1) if torch.is_tensor(pos) else torch.full(
        (1,), int(pos), device=dev)
    rot = LM._rotation(cfg, idx[None])
    mask = L.attention_mask(c["k"].shape[2], idx + 1, window=window,
                            n_global=n_global, device=dev)
    h = L.embed_tokens(model.embed, tokens, getattr(torch, cfg.dtype), cfg)
    for i, layer in enumerate(model.dec_layers):
        a = L.rmsnorm(layer.attn_norm, h, cfg.norm_eps)
        h = h + LM.attn_decode(layer.attn, cfg, a, c["k"][i], c["v"][i],
                               idx, rot, mask)
        x = L.rmsnorm(layer.cross_norm, h, cfg.norm_eps)
        o = L.decode_attention(L._proj(x, layer.cross.wq), c["ck"][i],
                               c["cv"][i], c["ck"].shape[2])
        h = h + L.out_proj(layer.cross, o)
        h = h + L.mlp(layer.mlp, L.rmsnorm(layer.mlp_norm, h, cfg.norm_eps))
    h = L.rmsnorm(model.final_norm, h, cfg.norm_eps)
    return L.logits_fn(model.embed, cfg, h), cache
