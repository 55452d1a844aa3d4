"""Jamba-style hybrid on the port: Mamba2 and attention interleaved 7:1,
MoE every other FFN — the port of ``repro.models.hybrid``
(``_period_pattern``, ``hybrid_defs``, ``hybrid_forward``,
``hybrid_loss``, ``hybrid_cache_defs``, ``hybrid_decode_step``) and of
the reference's ``_hybrid_prefill`` (``models/api.py``).

The layers come in periods of ``cfg.attn_every``: within a period slot
``attn_every // 2`` mixes with attention and the others with a Mamba2
block, and slot j's FFN is the MoE when ``j % cfg.moe_every == 0`` (and
the config has experts), else an MLP. Parameters are named
``periods.<p>.slot<j>.{mixer_norm, mixer, ffn_norm, ffn}``, the
reference's tree with its period axis unstacked
(``convert.params_from_jax``).

The attention slot is the LM's (``models/lm.attention_fn``): the
TorchGT cluster-sparse op at S >= 256 when ``cfg.attn_backend ==
"cluster_sparse"`` (the unbiased forward kernel and, under autograd, dQ
and dK/dV on CUDA tensors), else the plain chunked attention; Jamba has
no positional encoding (``rope_theta == 0``). The Mamba slots run
``models/ssm.mamba_apply``, whose scan is the plain ``ssd_chunked``, as
the reference's model calls its jnp one. Each period runs under the
recomputation of ``cfg.remat`` (``layers.maybe_remat``), as the
reference wraps its period body.

On a mesh (``parallel.axes.axis_rules``) each rank holds S/P tokens of
the sequence: the Mamba slots run ``models/ssm.mamba_mixer`` on the
shard (the rank's SSM heads on the gathered sequence), the attention
slot ``lm.sharded_attention_fn`` (Ulysses, or sequence-parallel
attention), the MoE slots the expert-parallel path of
``models/moe.py``; positions are global, and the loss is the mean over
every rank's shard. ``experts=(m, P)`` makes the MoE slots hold only
expert part m of P, as ``LMModel``'s do.

Serving: ``hybrid_prefill`` returns the last token's logits of the full
forward and no cache (the reference's ``_hybrid_prefill``);
``hybrid_decode_step`` advances one token through every slot over the
caches of ``hybrid_cache_defs`` (bf16 k/v for the attention slot, the
Mamba2 conv history and state for the others). The recurrent state is
no positional KV cache, so the model has no paged serving path: its
``prefill_chunk``, ``paged_decode`` and ``paged_cache_defs`` are None, as
the reference's ``Model`` fields are.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models.lm import (LMModel, _check_attn_backend, _rotation,
                                   _sparse_mask, attn_decode,
                                   offset_and_attention)
from repro_torch.models.moe import (MoE, moe_apply, moe_defs,
                                    routing_contexts)
from repro_torch.models.ssm import (Mamba, mamba_cache_defs, mamba_decode,
                                    mamba_defs, mamba_mixer)
from repro_torch.parallel import axes as pax


def _period_pattern(cfg) -> list:
    """The static ``(mixer, ffn)`` tags of one period's slots."""
    pe = cfg.attn_every
    return [("attn" if j == pe // 2 else "mamba",
             "moe" if j % cfg.moe_every == 0 and cfg.moe_experts
             else "dense") for j in range(pe)]


def hybrid_defs(cfg) -> dict:
    """``{name: (shape, init)}`` of every parameter, per period for the
    ``periods.*`` entries: the reference's ``hybrid_defs`` names and
    shapes."""
    D = cfg.d_model
    defs = {"embed.tok": ((cfg.vocab_padded, D), "embed"),
            "final_norm.scale": ((D,), "ones")}
    if not cfg.tie_embeddings:
        defs["embed.unembed"] = ((D, cfg.vocab_padded), "fan_in")
    for j, (mixer, ffn) in enumerate(_period_pattern(cfg)):
        pre = f"periods.slot{j}."
        defs[pre + "mixer_norm.scale"] = ((D,), "ones")
        defs[pre + "ffn_norm.scale"] = ((D,), "ones")
        if mixer == "attn":
            defs.update(L.attention_defs(cfg, pre + "mixer."))
        else:
            defs.update({pre + "mixer." + k: v
                         for k, v in mamba_defs(cfg).items()})
        if ffn == "moe":
            defs.update({pre + "ffn." + k: v
                         for k, v in moe_defs(cfg).items()})
        else:
            defs.update(L.mlp_defs(cfg, pre + "ffn."))
    return defs


class Slot(nn.Module):
    def __init__(self, cfg, mixer: str, ffn: str, *, device=None,
                 experts=None):
        super().__init__()
        self.mixer_norm = L.RMSNorm(cfg.d_model, device=device)
        self.mixer = (L.Attention(cfg, device=device) if mixer == "attn"
                      else Mamba(cfg, device=device))
        self.ffn_norm = L.RMSNorm(cfg.d_model, device=device)
        self.ffn = (MoE(cfg, device=device, experts=experts) if ffn == "moe"
                    else L.MLP(cfg, device=device))


class Period(nn.Module):
    """One period's slots, ``slot0`` .. ``slot<attn_every - 1>``."""

    def __init__(self, cfg, *, device=None, experts=None):
        super().__init__()
        for j, (mixer, ffn) in enumerate(_period_pattern(cfg)):
            setattr(self, f"slot{j}", Slot(cfg, mixer, ffn, device=device,
                                           experts=experts))


class HybridLMModel(nn.Module):
    """A Jamba-style hybrid LM with the reference's parameter names and
    shapes. ``seed`` drives the port's own init. ``experts=(m, P)``: the
    MoE slots hold only expert part m of P (``models/moe.py``), with the
    same numbers as those rows of the whole model's init."""

    def __init__(self, cfg, *, device="cuda", seed: int = 0,
                 experts=None):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"HybridLMModel is the hybrid family, got "
                             f"{cfg.family!r}")
        if not cfg.attn_every or cfg.n_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} must be "
                             f"a multiple of attn_every {cfg.attn_every}")
        _check_attn_backend(cfg)
        dev = resolve(device)
        self.cfg = cfg
        self.embed = L.Embedding(cfg, device=dev)
        self.final_norm = L.RMSNorm(cfg.d_model, device=dev)
        self.periods = nn.ModuleList(
            Period(cfg, device=dev, experts=experts)
            for _ in range(cfg.n_layers // cfg.attn_every))
        self.reset_parameters(seed)
        self._layouts = {}

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    # the attention slot's local+global layout, cached as the LM's
    layout = LMModel.layout

    def reset_parameters(self, seed: int = 0) -> None:
        """Seeded init (``layers.seeded_init``)."""
        L.seeded_init(self, hybrid_defs(self.cfg), seed)

    @property
    def loss_variants(self) -> dict:
        """The named losses a task trains: ``{"sparse": hybrid_loss}``."""
        return {"sparse": hybrid_loss}

    # the serving contract (the reference's ``models/api.Model`` fields);
    # no paged path for a recurrent state
    prefill_chunk = paged_decode = paged_cache_defs = None

    def prefill(self, batch: dict):
        """``(logits (B, 1, V), {})``: :func:`hybrid_prefill`."""
        return hybrid_prefill(self, batch)

    def decode(self, cache: dict, tokens, pos, *, sparse: bool = False):
        """``(logits (B, 1, V), new_cache)``: :func:`hybrid_decode_step`."""
        return hybrid_decode_step(self, cache, tokens, pos, sparse=sparse)

    def cache_defs(self, batch: int, seq_len: int) -> dict:
        """Zeroed caches on the model's device: :func:`hybrid_cache_defs`."""
        return hybrid_cache_defs(self.cfg, batch, seq_len,
                                 device=self.device)


def _period(period: Period, h, cfg, pos, attn, group):
    """One period's slots: ``(h, aux summed over its MoE slots)``; ``h``
    this rank's shard of a sequence sharded over ``group`` when it is not
    None."""
    aux = torch.zeros((), device=h.device)
    for j, (mixer, ffn) in enumerate(_period_pattern(cfg)):
        slot = getattr(period, f"slot{j}")
        a = L.rmsnorm(slot.mixer_norm, h, cfg.norm_eps)
        if mixer == "attn":
            q, k, v = L.project_qkv(slot.mixer, cfg, a, pos)
            a = L.out_proj(slot.mixer, attn(q, k, v))
        else:
            a = mamba_mixer(slot.mixer, cfg, a, group)
        h = h + a
        m = L.rmsnorm(slot.ffn_norm, h, cfg.norm_eps)
        if ffn == "moe":
            y, a = moe_apply(slot.ffn, cfg, m)
            aux = aux + a
        else:
            y = L.mlp(slot.ffn, m)
        h = h + y
    return h, aux


def hybrid_forward(model: HybridLMModel, batch: dict, *,
                   impl: str | None = None):
    """-> (final hidden states (B, S, D) after the final norm, aux loss:
    the MoE balance term summed over the slots, divided by
    ``n_layers``). ``batch["tokens"]`` is (B, S) int on the model's
    device. ``impl="plain"`` runs the cluster op's plain versions."""
    cfg = model.cfg
    tokens = batch["tokens"]
    h = L.embed_tokens(model.embed, tokens, getattr(torch, cfg.dtype))
    S = tokens.shape[1]
    group = pax.seq_group()
    off, attn = offset_and_attention(model, S, group, impl)
    pos = _rotation(cfg, torch.arange(off, off + S, device=tokens.device))
    body = L.maybe_remat(functools.partial(
        _period, cfg=cfg, pos=pos, attn=attn, group=group), cfg,
        routing_contexts)
    aux = torch.zeros((), device=h.device)
    for period in model.periods:
        h, a = body(period, h)
        aux = aux + a
    h = L.rmsnorm(model.final_norm, h, cfg.norm_eps)
    return h, aux / max(cfg.n_layers, 1)


def hybrid_loss(model: HybridLMModel, batch: dict, *, aux_coef: float = 0.01,
                impl: str | None = None):
    """Mean next-token cross-entropy over ``batch["labels"]`` (-1
    ignored), plus ``aux_coef`` times the balance term: ``(loss, {"xent",
    "aux"})``."""
    h, aux = hybrid_forward(model, batch, impl=impl)
    loss = L.chunked_softmax_xent(model.embed, model.cfg, h, batch["labels"],
                                  group=pax.mesh_group())
    return loss + aux_coef * aux, {"xent": loss, "aux": aux}


def hybrid_prefill(model: HybridLMModel, batch: dict):
    """The last token's logits ``(B, 1, V)`` of the full forward, and no
    cache (``{}``), as the reference's ``_hybrid_prefill``."""
    h, _ = hybrid_forward(model, batch)
    return L.logits_fn(model.embed, model.cfg, h[:, -1:]), {}


# ------------------------------------------------------------ decode

def hybrid_cache_defs(cfg, batch: int, seq_len: int, *,
                      device="cpu") -> dict:
    """Zeroed decode caches on ``device``: ``{"periods": {"slot<j>":
    ...}}``, the attention slot's ``{"k", "v"}`` ``(n_periods, batch,
    seq_len, KV, Dh)`` bf16, each Mamba slot's ``mamba_cache_defs``, all
    stacked on a leading period axis: the reference's
    ``hybrid_cache_defs``."""
    n = cfg.n_layers // cfg.attn_every
    kv = (n, batch, seq_len, cfg.kv_heads, cfg.head_dim)
    mamba = mamba_cache_defs(cfg, batch, device=device)
    tree = {}
    for j, (mixer, _) in enumerate(_period_pattern(cfg)):
        if mixer == "attn":
            tree[f"slot{j}"] = {
                "k": torch.zeros(kv, dtype=torch.bfloat16, device=device),
                "v": torch.zeros(kv, dtype=torch.bfloat16, device=device)}
        else:
            tree[f"slot{j}"] = {k: v.new_zeros((n, *v.shape))
                                for k, v in mamba.items()}
    return {"periods": tree}


def hybrid_decode_step(model: HybridLMModel, cache: dict, tokens, pos, *,
                       sparse: bool = False):
    """One decode step: tokens (B, 1) int at position ``pos`` (a host int
    or a 0-d int64 tensor on the device: the attention caches' current
    length). The attention slots write their k/v row in place; the Mamba
    slots' caches are new tensors (``mamba_decode``). Returns ``(logits
    (B, 1, V), new_cache)``, the cache tree of ``hybrid_cache_defs``.
    ``sparse`` applies the cluster-sparse decode mask to the attention
    slots."""
    cfg = model.cfg
    dev = tokens.device
    pat = _period_pattern(cfg)
    window, n_global = _sparse_mask(cfg, sparse)
    idx = pos.reshape(1) if torch.is_tensor(pos) else torch.full(
        (1,), int(pos), device=dev)
    rot = _rotation(cfg, idx[None])
    tree = cache["periods"]
    S = tree[f"slot{cfg.attn_every // 2}"]["k"].shape[2]
    mask = L.attention_mask(S, idx + 1, window=window, n_global=n_global,
                            device=dev)
    h = L.embed_tokens(model.embed, tokens, getattr(torch, cfg.dtype))
    new = {f"slot{j}": {k: [] for k in tree[f"slot{j}"]}
           for j, (m, _) in enumerate(pat) if m == "mamba"}
    for p, period in enumerate(model.periods):
        for j, (mixer, ffn) in enumerate(pat):
            slot, c = getattr(period, f"slot{j}"), tree[f"slot{j}"]
            a = L.rmsnorm(slot.mixer_norm, h, cfg.norm_eps)
            if mixer == "attn":
                a = attn_decode(slot.mixer, cfg, a, c["k"][p], c["v"][p],
                                idx, rot, mask)
            else:
                a, cc = mamba_decode(slot.mixer, cfg, a,
                                     {k: v[p] for k, v in c.items()})
                for k, v in cc.items():
                    new[f"slot{j}"][k].append(v)
            h = h + a
            m = L.rmsnorm(slot.ffn_norm, h, cfg.norm_eps)
            h = h + (moe_apply(slot.ffn, cfg, m)[0] if ffn == "moe"
                     else L.mlp(slot.ffn, m))
    h = L.rmsnorm(model.final_norm, h, cfg.norm_eps)
    out = {f"slot{j}": (tree[f"slot{j}"] if m == "attn" else
                        {k: torch.stack(v)
                         for k, v in new[f"slot{j}"].items()})
           for j, (m, _) in enumerate(pat)}
    return L.logits_fn(model.embed, cfg, h), {"periods": out}

