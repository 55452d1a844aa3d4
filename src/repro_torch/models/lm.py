"""Decoder-only LM of the dense, MoE and VLM families (llama / qwen3,
qwen3-moe / kimi-k2, the internvl2 backbone with its stub frontend) on
the port — the port of ``repro.models.lm`` (``lm_defs``,
``attn_apply`` in its mesh-free branch, ``_embed_inputs``,
``lm_forward``, ``lm_loss`` and the serving half).

With ``cfg.moe_experts`` every layer of ``layers.*`` runs the MoE FFN of
``models/moe.py`` (``cfg.moe_every`` is the hybrid's and is ignored here,
as in the reference), and ``cfg.n_dense_layers`` leading layers
``dense_layer_<i>`` run an MLP of width ``cfg.dense_d_ff or cfg.d_ff``
before them, outside the layers' recomputation, as in the reference.
The forward's aux loss is the MoE balance term summed over the layers
and divided by ``n_layers`` (0 for a dense model).

The VLM (``cfg.family == "vlm"``) takes ``batch["patches"]`` (B, Tp, D),
the stub vision frontend's patch embeddings, projects them by
``frontend_proj.w`` (D, D) in the compute dtype and puts them before the
token embeddings (``_embed_inputs``; the reference's gather-and-select
computes the same concatenation, an idiom for XLA's partitioner); its
loss counts only the text positions, and its prefill caches hold the Tp
+ T positions, so decode goes on at Tp + T. Its paged serving path is
text-only, as the reference's: ``ServeEngine`` serves a VLM as a dense
LM.

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
un-batched products (the projections, the MLP and the experts' products)
and recomputes the rest, the attention op included; any other value
keeps only the layer's input and recomputes the whole layer in the
backward. Under recomputation each attention forward kernel launches
twice per layer and step, the dQ and dK/dV kernels once.

Serving, the port of the reference's decode half (no grad, so no
recomputation and the cluster op's forward only):

* ``lm_prefill``: the forward over a whole prompt, returning the last
  token's logits and every layer's k and v, cast to bf16 whatever the
  model's dtype (the reference's ``lm.py:100-101``), in caches of
  ``lm_cache_defs``'s layout;
* ``lm_decode_step``: one token against the contiguous caches, at one
  position shared by the batch, optionally under the cluster-sparse
  decode mask (``cfg.window`` rows and ``cfg.n_global`` sinks);
* the paged path of ``serve/engine.py``: ``lm_paged_cache_defs`` (one
  pool of ``page``-row blocks shared by every request),
  ``lm_prefill_chunk`` (one fixed-size chunk of one prompt) and
  ``lm_paged_decode_step`` (a batch of slots, each at its own position),
  both through ``kernels/ops.paged_attention``.

The caches and pools hold ``{"layers": {"k", "v"}}`` stacked on a leading
layer axis, and one ``{"k", "v"}`` entry of each leading dense layer
under ``dense_layer_<i>``, the reference's tree. They are written in
place: the decode steps and the prefill chunk return the caches they
were given, whose rows they have overwritten.

The hybrid is ``models/hybrid.py``'s model, the SSM ``models/api.py``'s
and the encoder-decoder ``models/encdec.py``'s.

Under a mesh (``parallel.axes.axis_rules``, as the Trainer runs a step
with ``mesh=``) the dense, MoE and VLM families train sequence-sharded:
each rank holds S/P contiguous positions of the model group's sequence,
RoPE at their global positions, and attention dispatches as the
reference's ``attn_apply`` does:

* Ulysses (``parallel/ulysses.py``) when the recipe asks for it and the
  heads split over the group (``can_ulysses``): the all-to-all gives
  each rank the full sequence for H/P heads, where the op above runs
  unchanged, the cluster-sparse layout included;
* otherwise sequence-parallel attention (``seqpar_attention``, e.g.
  SmolLM's 9 heads two ways): the rank's queries against all-gathered
  k and v, causal at the queries' global offset, on the plain chunked
  attention. The cluster-sparse op takes no query offset, so that
  combination raises: the reference's ``attn_apply`` cannot run it
  either (it calls its sparse op with a ``q_offset`` keyword the op
  does not take).

The MoE FFN takes the expert-parallel path of ``models/moe.py``.
``lm_loss`` is then the global mean over every rank's shard. The VLM's
sequence is its Tp patches and then its T tokens, sharded as one: the
batch's ``tokens`` and ``labels`` are those of the rank's S/P positions
of the Tp + T, with placeholders (label -1) at patch positions
(``tasks/base.BatchFnTask``), and a rank projects the patches of its
positions below Tp and embeds the tokens of the rest; its loss counts
the text positions by their labels. Sequence-sharded prefill
(``return_kv`` on a mesh) raises unless the caller asks for each rank's
share of the caches (``shard_kv``): the reference's dry-run cells
compile prefill with the sequence sharded and the caches' sequence over
"model", and the sweep's prefill step (``launch/steps.py``) is its
counterpart; no serving entry point runs it.

Serving on a mesh (``ServeEngine(mesh_model=P)``, under the "decode"
recipe): the paged pool holds KV/P kv heads a rank, and each layer of
``lm_prefill_chunk`` and ``lm_paged_decode_step`` computes this rank's
H/P query heads and KV/P kv heads from its slices of the (replicated)
projection weights, attends over its own heads, and sums the output
projection's partial products over the model group with one
all-reduce; the MoE FFN takes the expert-parallel path on the whole
batch, every rank routing every token. Where the query or kv heads do
not split P ways (SmolLM's 9 and 3 two ways) the pool holds every head
on every rank and every rank computes every head, with no all-reduce:
the reference's ``fit_spec`` rule, an axis that does not divide staying
whole (``heads_split``).
"""

from __future__ import annotations

import functools
import types

import numpy as np
import torch
from torch import nn

from repro_torch.core.reformation import lm_local_global_layout
from repro_torch.device import resolve
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.moe import (MoE, moe_apply, moe_defs,
                                    routing_contexts)
from repro_torch.parallel import axes as pax
from repro_torch.parallel import collectives as C
from repro_torch.parallel.ulysses import (can_ulysses, seqpar_attention,
                                          ulysses_attention)

LM_BLOCK = 128      # bq = bk of the local+global layout (reference lm.py)


def _layer_defs(cfg, prefix: str, moe: bool) -> dict:
    """One decoder layer's defs: attention, and the MoE FFN or an MLP of
    width ``cfg.dense_d_ff or cfg.d_ff`` (the reference's
    ``_layer_defs``)."""
    D = cfg.d_model
    defs = {prefix + "attn_norm.scale": ((D,), "ones"),
            **L.attention_defs(cfg, prefix + "attn."),
            prefix + "mlp_norm.scale": ((D,), "ones")}
    if moe:
        defs.update({f"{prefix}moe.{k}": v
                     for k, v in moe_defs(cfg).items()})
    else:
        defs.update(L.mlp_defs(cfg, prefix + "mlp.", cfg.dense_d_ff))
    return defs


def lm_defs(cfg) -> dict:
    """``{name: (shape, init)}`` of every parameter of a dense or MoE LM,
    per layer for the ``layers.*`` entries: the reference's ``lm_defs``
    names and shapes."""
    D, Vp = cfg.d_model, cfg.vocab_padded
    defs = {"embed.tok": ((Vp, D), "embed"),
            "final_norm.scale": ((D,), "ones"),
            **_layer_defs(cfg, "layers.", bool(cfg.moe_experts))}
    for i in range(cfg.n_dense_layers):
        defs.update(_layer_defs(cfg, f"dense_layer_{i}.", False))
    if not cfg.tie_embeddings:
        defs["embed.unembed"] = ((D, Vp), "fan_in")
    if cfg.family == "vlm":
        defs["frontend_proj.w"] = ((D, D), "fan_in")
    return defs


class LMLayer(nn.Module):
    """Pre-norm attention and an FFN: the MoE (``moe``) when ``moe``,
    else an MLP (``mlp``) of width ``cfg.dense_d_ff or cfg.d_ff``."""

    def __init__(self, cfg, *, moe: bool = False, device=None,
                 experts=None):
        super().__init__()
        self.attn_norm = L.RMSNorm(cfg.d_model, device=device)
        self.attn = L.Attention(cfg, device=device)
        self.mlp_norm = L.RMSNorm(cfg.d_model, device=device)
        if moe:
            self.moe = MoE(cfg, device=device, experts=experts)
        else:
            self.mlp = L.MLP(cfg, cfg.dense_d_ff, device=device)


class FrontendProj(nn.Module):
    """The VLM's projection of the frontend's patch embeddings, ``w``
    (D, D)."""

    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d, d, device=device))


def _check_attn_backend(cfg) -> None:
    if cfg.attn_backend not in ("dense", "cluster_sparse"):
        raise ValueError(f"attn_backend {cfg.attn_backend!r} not in "
                         f"('dense', 'cluster_sparse')")


class LMModel(nn.Module):
    """A dense or MoE decoder-only LM with the reference's parameter names
    and shapes, so a JAX parameter tree loads through
    ``convert.params_from_jax``. ``seed`` drives the port's own init.
    ``experts=(m, P)``: the MoE layers hold only expert part m of P (rank
    m of a P-way model axis, ``models/moe.py``), with the same numbers
    as those rows of the whole model's init."""

    def __init__(self, cfg, *, device="cuda", seed: int = 0,
                 experts=None):
        super().__init__()
        where = {"ssm": "models/api.SSMLMModel",
                 "hybrid": "models/hybrid.HybridLMModel",
                 "encdec": "models/encdec.EncDecModel"}
        if cfg.family in where:
            raise ValueError(f"{cfg.name}: the {cfg.family} family is "
                             f"{where[cfg.family]}, not LMModel")
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
        _check_attn_backend(cfg)
        dev = resolve(device)
        self.cfg = cfg
        self.embed = L.Embedding(cfg, device=dev)
        self.final_norm = L.RMSNorm(cfg.d_model, device=dev)
        self.layers = nn.ModuleList(
            LMLayer(cfg, moe=bool(cfg.moe_experts), device=dev,
                    experts=experts)
            for _ in range(cfg.n_layers - cfg.n_dense_layers))
        for i in range(cfg.n_dense_layers):
            setattr(self, f"dense_layer_{i}", LMLayer(cfg, device=dev))
        if cfg.family == "vlm":
            self.frontend_proj = FrontendProj(cfg.d_model, device=dev)
        self.reset_parameters(seed)
        self._layouts = {}

    @property
    def dense_layers(self) -> list:
        """The leading dense layers, in order."""
        return [getattr(self, f"dense_layer_{i}")
                for i in range(self.cfg.n_dense_layers)]

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def layout(self, S: int, causal: bool | None = None):
        """``(block_idx, block_idx_t)`` of the local+global layout for
        sequences of length ``S`` on the model's device, causal as
        ``causal`` says (default ``cfg.causal``): built on the host and
        uploaded once per (S, window, n_global, causal)."""
        cfg = self.cfg
        causal = cfg.causal if causal is None else causal
        key = (S, cfg.window, cfg.n_global, causal)
        if key not in self._layouts:
            lay = lm_local_global_layout(S, bq=LM_BLOCK, bk=LM_BLOCK,
                                         window=cfg.window,
                                         n_global=cfg.n_global,
                                         causal=causal)
            if lay.seq_len != S:
                raise ValueError(f"the cluster-sparse LM path tiles S in "
                                 f"blocks of {LM_BLOCK}; S={S} is not a "
                                 f"multiple")
            self._layouts[key] = tuple(
                kops.keep_host_copy(torch.from_numpy(np.ascontiguousarray(a))
                               .to(self.device), a)
                for a in (lay.block_idx, lay.block_idx_t))
        return self._layouts[key]

    def reset_parameters(self, seed: int = 0) -> None:
        """Seeded init (``layers.seeded_init``)."""
        L.seeded_init(self, lm_defs(self.cfg), seed)

    @property
    def loss_variants(self) -> dict:
        """The named losses a task trains: ``{"sparse": lm_loss}``."""
        return {"sparse": lm_loss}

    # the serving contract (the reference's ``models/api.Model`` fields)

    def prefill(self, batch: dict, **kw):
        """``(logits (B, 1, V), caches)``: :func:`lm_prefill`."""
        return lm_prefill(self, batch, **kw)

    def decode(self, cache: dict, tokens, pos, *, sparse: bool = False):
        """``(logits (B, 1, V), cache)``: :func:`lm_decode_step`."""
        return lm_decode_step(self, cache, tokens, pos, sparse=sparse)

    def cache_defs(self, batch: int, seq_len: int) -> dict:
        """Zeroed contiguous caches on the model's device:
        :func:`lm_cache_defs`."""
        return lm_cache_defs(self.cfg, batch, seq_len, device=self.device)

    def prefill_chunk(self, pool: dict, tokens, offset: int, length: int,
                      block_tables, *, sparse: bool = False):
        """``(logits (1, 1, V), pool)``: :func:`lm_prefill_chunk`."""
        return lm_prefill_chunk(self, pool, tokens, offset, length,
                                block_tables, sparse=sparse)

    def paged_decode(self, pool: dict, tokens, pos, block_tables, *,
                     sparse: bool = False):
        """``(logits (B, 1, V), pool)``: :func:`lm_paged_decode_step`."""
        return lm_paged_decode_step(self, pool, tokens, pos, block_tables,
                                    sparse=sparse)

    def paged_cache_defs(self, num_blocks: int, page: int, **kw) -> dict:
        """A zeroed paged pool on the model's device:
        :func:`lm_paged_cache_defs`."""
        return lm_paged_cache_defs(self.cfg, num_blocks, page,
                                   device=self.device, **kw)


def attention_fn(model, S: int, impl: str | None = None,
                 causal: bool | None = None):
    """``fn(q, k, v) -> o`` for sequences of length ``S``: the
    cluster-sparse op over the local+global layout, or the plain chunked
    attention (the reference's ``attn_apply`` dispatch, mesh-free),
    causal as ``causal`` says (default ``model.cfg.causal``; the
    encoder-decoder's encoder passes False). ``impl="plain"`` runs the
    sparse op's plain versions on any device."""
    cfg = model.cfg
    causal = cfg.causal if causal is None else causal
    if cfg.attn_backend == "cluster_sparse" and S >= 2 * LM_BLOCK:
        bi, bit = model.layout(S, causal)
        return lambda q, k, v: kops.cluster_attention(
            q, k, v, bi, None, None, bit, causal=causal, impl=impl)
    return lambda q, k, v: L.chunked_attention(
        q, k, v, causal=causal, chunk_q=cfg.attn_chunk_q,
        chunk_k=cfg.attn_chunk_k)


def sharded_attention_fn(model, S: int, group, impl: str | None = None,
                         causal: bool | None = None):
    """``fn(q, k, v) -> o`` on this rank's sequence shards, of a sequence
    of ``S`` tokens in all sharded over ``group``: Ulysses around
    :func:`attention_fn` where the recipe asks for it and the heads
    split, else sequence-parallel chunked attention (the reference's
    ``attn_apply`` on a mesh); causal as ``causal`` says (default
    ``cfg.causal``; the encoder-decoder's encoder passes False)."""
    cfg = model.cfg
    causal = cfg.causal if causal is None else causal
    p = C.size(group)
    recipe = pax.current()[0]
    if recipe.ulysses and can_ulysses(cfg.n_heads, cfg.kv_heads, S, p):
        inner = attention_fn(model, S, impl, causal)
        return lambda q, k, v: ulysses_attention(q, k, v, group=group,
                                                 attn_fn=inner)
    if cfg.attn_backend == "cluster_sparse" and S >= 2 * LM_BLOCK:
        # the reference's seqpar branch calls its sparse op with a
        # q_offset keyword the op does not take, so it cannot run this
        raise ValueError(
            f"{cfg.name}: H={cfg.n_heads} KV={cfg.kv_heads} cannot split "
            f"{p} ways for Ulysses, and the cluster-sparse op takes no "
            f"query offset for sequence-parallel attention (S={S}); the "
            f"reference cannot run this combination either")
    return lambda q, k, v: seqpar_attention(
        q, k, v, group=group, attn_fn=lambda a, b, c, off:
        L.chunked_attention(a, b, c, causal=causal,
                            chunk_q=cfg.attn_chunk_q,
                            chunk_k=cfg.attn_chunk_k, q_offset=off))


def offset_and_attention(model, S: int, group, impl: str | None = None,
                         causal: bool | None = None):
    """``(offset, fn)`` for this rank's ``S`` positions: the global
    position of its first and its attention (:func:`attention_fn` without
    ``group``; with it, the shard's offset and :func:`sharded_attention_fn`
    over the whole sequence of ``S`` times the group's size)."""
    if group is None:
        return 0, attention_fn(model, S, impl, causal)
    return C.rank(group) * S, sharded_attention_fn(
        model, S * C.size(group), group, impl, causal)


def ffn(layer, cfg, m):
    """The layer's FFN on the normed residual ``m``: ``(y, aux)``, the
    MoE's balance term or 0 for an MLP."""
    if hasattr(layer, "moe"):
        return moe_apply(layer.moe, cfg, m)
    return L.mlp(layer.mlp, m), 0.0


def _layer(layer: LMLayer, h, kv, cfg, pos, attn):
    """One decoder layer: pre-norm attention and the FFN, residual:
    ``(h, aux)``. ``kv``, a pair of cache views ``(B, >= S, KV, Dh)`` or
    None, receives the layer's k and v (in the caches' dtype, without
    grad)."""
    a = L.rmsnorm(layer.attn_norm, h, cfg.norm_eps)
    q, k, v = L.project_qkv(layer.attn, cfg, a, pos)
    if kv is not None:
        S = k.shape[1]
        kv[0][:, :S] = k.detach()
        kv[1][:, :S] = v.detach()
    h = h + L.out_proj(layer.attn, attn(q, k, v))
    y, aux = ffn(layer, cfg, L.rmsnorm(layer.mlp_norm, h, cfg.norm_eps))
    return h + y, aux


def _rotation(cfg, pos):
    """What :func:`layers.rope` takes for positions ``pos``: the
    ``(cos, sin)`` pair, computed once for every layer, or ``pos`` itself
    when the model has no RoPE."""
    return L.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta) \
        if cfg.rope_theta else pos


def _stacked_kv(cache: dict, i: int):
    """Layer ``i``'s ``(k, v)`` views of a cache or pool tree."""
    return cache["layers"]["k"][i], cache["layers"]["v"][i]


def _all_layers(model: LMModel, cache: dict):
    """``(layer, k, v)`` of every layer in order, the leading dense layers
    first, with its views of ``cache``."""
    for i, layer in enumerate(model.dense_layers):
        c = cache[f"dense_layer_{i}"]
        yield layer, c["k"], c["v"]
    for i, layer in enumerate(model.layers):
        yield (layer, *_stacked_kv(cache, i))


def _embed_inputs(model: LMModel, batch: dict, dtype, group=None):
    """The token embeddings, and for the VLM the projected patches before
    them: (B, Tp + T, D) in ``dtype``. The patches are cast to ``dtype``
    and projected there, as in the reference. With ``group`` (the
    sequence sharded over it) the VLM's ``tokens`` are this rank's
    positions of the Tp + T (``tasks/base.BatchFnTask``): the positions
    below Tp take their projected patches, the others their tokens."""
    tokens = batch["tokens"]
    if model.cfg.family != "vlm":
        return L.embed_tokens(model.embed, tokens, dtype)
    patches = batch["patches"]
    if group is not None:
        n = tokens.shape[1]
        lo = C.rank(group) * n
        npatch = min(max(patches.shape[1] - lo, 0), n)
        patches, tokens = patches[:, lo:lo + npatch], tokens[:, npatch:]
    h = L.embed_tokens(model.embed, tokens, dtype)
    proj = patches.to(dtype) @ model.frontend_proj.w.to(dtype)
    return torch.cat([proj, h], 1)


def lm_forward(model: LMModel, batch: dict, *, impl: str | None = None,
               return_kv: bool = False, cache_len: int | None = None,
               shard_kv: bool = False):
    """-> (final hidden states (B, S, D) after the final norm, aux loss),
    and with ``return_kv`` also the caches: every layer's k and v in bf16
    (``lm_cache_defs``'s layout, ``cache_len`` rows, default S, the rows
    past S zero). ``batch["tokens"]`` is (B, T) int on the model's
    device, and for the VLM ``batch["patches"]`` (B, Tp, D), so S = Tp +
    T; else S = T. The aux loss is the MoE balance term summed over the
    layers and divided by ``n_layers``: 0 for a dense model, as in the
    reference. The leading dense layers run outside the recomputation,
    as the reference's do. With the sequence sharded, ``return_kv``
    needs ``shard_kv``: each rank's caches then hold the k and v of its
    own positions (the reference's "kv_seq" over "model")."""
    cfg = model.cfg
    dtype = getattr(torch, cfg.dtype)
    group = pax.seq_group()
    if group is not None and return_kv and not shard_kv:
        raise ValueError(
            f"{cfg.name}: sequence-sharded prefill is not run by any entry "
            f"point, here or in the reference; ServeEngine serves on a "
            f"mesh by heads, through the paged path")
    h = _embed_inputs(model, batch, dtype, group)
    B, S = h.shape[:2]
    off, attn = offset_and_attention(model, S, group, impl)
    # RoPE at the tokens' global positions
    pos = _rotation(cfg, torch.arange(off, off + S, device=h.device))
    layer_fn = functools.partial(_layer, cfg=cfg, pos=pos, attn=attn)
    body = L.maybe_remat(layer_fn, cfg, routing_contexts
                         if cfg.moe_experts else None)
    caches = lm_cache_defs(cfg, B, cache_len or S, device=h.device) \
        if return_kv else None
    aux = torch.zeros((), device=h.device)
    for i, layer in enumerate(model.dense_layers):
        kv = None if caches is None else (caches[f"dense_layer_{i}"]["k"],
                                          caches[f"dense_layer_{i}"]["v"])
        h, _ = layer_fn(layer, h, kv)
    for i, layer in enumerate(model.layers):
        kv = None if caches is None else _stacked_kv(caches, i)
        h, a = body(layer, h, kv)
        aux = aux + a
    h = L.rmsnorm(model.final_norm, h, cfg.norm_eps)
    aux = aux / max(cfg.n_layers, 1)
    return (h, aux, caches) if return_kv else (h, aux)


def lm_loss(model: LMModel, batch: dict, *, aux_coef: float = 0.01,
            impl: str | None = None):
    """Mean next-token cross-entropy over ``batch["labels"]`` (-1
    ignored; the VLM's over the text positions only), computed in
    sequence chunks without the full logits: ``(loss, {"xent": loss,
    "aux": aux})``."""
    h, aux = lm_forward(model, batch, impl=impl)
    if model.cfg.family == "vlm" and pax.seq_group() is None:
        # sharded, the labels at patch positions are -1 instead
        h = h[:, batch["patches"].shape[1]:]
    loss = L.chunked_softmax_xent(model.embed, model.cfg, h, batch["labels"],
                                  group=pax.mesh_group())
    return loss + aux_coef * aux, {"xent": loss, "aux": aux}


# ------------------------------------------------------------ decode

def _zeros_bf16(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.bfloat16, device=device)


def _kv_tree(cfg, rows: tuple, device, kv_heads: int | None = None) -> dict:
    """Zeroed bf16 ``{"layers": {"k", "v"}}`` of shape ``(n_scan, *rows,
    KV, Dh)``, and ``dense_layer_<i>: {"k", "v"}`` of ``(*rows, KV, Dh)``
    for each leading dense layer: the reference's cache tree (``KV`` =
    ``kv_heads``, default ``cfg.kv_heads``)."""
    one = (*rows, kv_heads or cfg.kv_heads, cfg.head_dim)
    n_scan = cfg.n_layers - cfg.n_dense_layers
    tree = {"layers": {"k": _zeros_bf16((n_scan, *one), device),
                       "v": _zeros_bf16((n_scan, *one), device)}}
    for i in range(cfg.n_dense_layers):
        tree[f"dense_layer_{i}"] = {"k": _zeros_bf16(one, device),
                                    "v": _zeros_bf16(one, device)}
    return tree


def lm_cache_defs(cfg, batch: int, seq_len: int, *, device="cpu") -> dict:
    """Zeroed contiguous decode caches on ``device``: ``{"layers": {"k",
    "v"}}``, each ``(n_layers - n_dense_layers, batch, seq_len, KV, Dh)``
    bf16, and ``dense_layer_<i>: {"k", "v"}`` of ``(batch, seq_len, KV,
    Dh)``: the reference's ``lm_cache_defs`` with its layer axis
    stacked."""
    return _kv_tree(cfg, (batch, seq_len), device)


def lm_prefill(model: LMModel, batch: dict, *, impl: str | None = None,
               cache_len: int | None = None, shard_kv: bool = False):
    """Prefill: the forward over ``batch["tokens"]`` (B, T) (and the VLM's
    ``batch["patches"]`` before them), returning the last token's logits
    ``(B, 1, V)`` and the caches (``lm_forward``'s, ``cache_len`` rows,
    default the S = Tp + T positions, so that decode can go on in place
    at S). With
    ``cfg.attn_backend == "cluster_sparse"`` and S >= 256 each layer
    launches the cluster op's forward kernel once on CUDA tensors (no
    grad); ``impl="plain"`` runs its plain version. ``shard_kv`` (the
    sequence sharded over the model group): the caches of this rank's
    positions, and the logits of the sequence's last token, which the
    group's last rank holds, summed over the group."""
    h, _, caches = lm_forward(model, batch, impl=impl, return_kv=True,
                              cache_len=cache_len, shard_kv=shard_kv)
    logits = L.logits_fn(model.embed, model.cfg, h[:, -1:])
    group = pax.seq_group()
    if group is not None:
        if C.rank(group) != C.size(group) - 1:
            logits = torch.zeros_like(logits)
        logits = C.all_reduce_(logits, group)
    return logits, caches


def _sparse_mask(cfg, sparse: bool):
    """``(window, n_global)`` of the cluster-sparse decode mask, or zeros."""
    return (cfg.window, cfg.n_global) if sparse else (0, 0)


def attn_decode(attn: L.Attention, cfg, a, ck, cv, idx, rot, mask):
    """Attention of one decode token: a (B, 1, D), normed; writes its k/v
    row at position ``idx`` ((1,) int64 on the device) of the caches
    ``ck``/``cv`` (B, S, KV, Dh) in place, cast to their dtype, then
    attends over them under ``mask`` (the reference's ``attn_decode``)."""
    q, k, v = L.project_qkv(attn, cfg, a, rot)
    ck.index_copy_(1, idx, k.to(ck.dtype))
    cv.index_copy_(1, idx, v.to(cv.dtype))
    return L.out_proj(attn, L.masked_attention(q, ck, cv, mask))


def _layer_decode(layer: LMLayer, h, cfg, ck, cv, idx, rot, mask):
    """One layer of contiguous decode: h (B, 1, D), the layer's caches
    written in place (:func:`attn_decode`)."""
    a = L.rmsnorm(layer.attn_norm, h, cfg.norm_eps)
    h = h + attn_decode(layer.attn, cfg, a, ck, cv, idx, rot, mask)
    y, _ = ffn(layer, cfg, L.rmsnorm(layer.mlp_norm, h, cfg.norm_eps))
    return h + y


def lm_decode_step(model: LMModel, cache: dict, tokens, pos, *,
                   sparse: bool = False):
    """One decode step. tokens (B, 1) int; ``pos`` a host int or a 0-d
    int64 tensor on the device (then the step makes no host sync, and a
    CUDA graph of it can be replayed at each position), the position
    every row's token takes, which is the caches' current length. Writes
    each layer's new k/v row into ``cache`` in place and returns
    ``(logits (B, 1, V), cache)``. ``sparse`` applies the cluster-sparse
    decode mask."""
    cfg = model.cfg
    dev = tokens.device
    window, n_global = _sparse_mask(cfg, sparse)
    idx = pos.reshape(1) if torch.is_tensor(pos) else torch.full(
        (1,), int(pos), device=dev)
    rot = _rotation(cfg, idx[None])
    mask = L.attention_mask(cache["layers"]["k"].shape[2], idx + 1,
                            window=window, n_global=n_global, device=dev)
    h = L.embed_tokens(model.embed, tokens, getattr(torch, cfg.dtype))
    for layer, ck, cv in _all_layers(model, cache):
        h = _layer_decode(layer, h, cfg, ck, cv, idx, rot, mask)
    h = L.rmsnorm(model.final_norm, h, cfg.norm_eps)
    return L.logits_fn(model.embed, cfg, h), cache


# ------------------------------------------------------------ paged serving

def lm_paged_cache_defs(cfg, num_blocks: int, page: int, *,
                        device="cpu", kv_heads: int | None = None) -> dict:
    """The serving engine's zeroed paged KV pool on ``device``:
    ``{"layers": {"k", "v"}}``, each ``(n_layers - n_dense_layers,
    num_blocks, page, KV, Dh)`` bf16, and ``dense_layer_<i>: {"k", "v"}``
    of ``(num_blocks, page, KV, Dh)``, shared by every request;
    per-request block tables map logical positions onto its blocks
    (``serve/``). Physical block 0 is the engine's scratch sink for idle
    decode slots and chunk padding: the allocator never hands it to a
    request. ``kv_heads``: the heads a rank's pool holds on a serving
    mesh (KV/P)."""
    return _kv_tree(cfg, (num_blocks, page), device, kv_heads)


def _pool_scatter(pk, pv, k_rows, v_rows, flat):
    """Write per-token k/v rows ``(N, KV, Dh)`` into one layer's pool
    ``(NB, page, KV, Dh)`` at flat token indices ``flat`` ((N,) int64,
    ``block * page + slot``), in place, cast to the pool's dtype.
    Duplicate indices (padding rows and idle slots, all in scratch block
    0) land in an unspecified order, as the reference's scatter does."""
    NB, page, KV, Dh = pk.shape
    pk.view(NB * page, KV, Dh).index_copy_(0, flat, k_rows.to(pk.dtype))
    pv.view(NB * page, KV, Dh).index_copy_(0, flat, v_rows.to(pv.dtype))


def heads_split(cfg, p: int) -> bool:
    """Whether a serving mesh of ``p`` ranks splits the attention heads:
    the query and the kv heads both divide ``p`` (else every rank holds
    and computes them all)."""
    return cfg.n_heads % p == 0 and cfg.kv_heads % p == 0


def _rank_heads(attn: L.Attention, cfg, group):
    """The attention weights of this rank's heads on a serving mesh: its
    KV/P kv heads and the H/P query heads that read them (views of the
    replicated weights)."""
    p, m = C.size(group), C.rank(group)
    h, kv = cfg.n_heads // p, cfg.kv_heads // p
    w = types.SimpleNamespace(
        wq=attn.wq[:, m * h:(m + 1) * h], wk=attn.wk[:, m * kv:(m + 1) * kv],
        wv=attn.wv[:, m * kv:(m + 1) * kv], wo=attn.wo[m * h:(m + 1) * h])
    if cfg.qk_norm:
        w.q_norm, w.k_norm = attn.q_norm, attn.k_norm
    return w


def _layer_paged(layer: LMLayer, h, cfg, pk, pv, rot, flat, block_tables,
                 cache_len, q_offset, mask):
    """One layer of paged serving, decode or prefill chunk: the tokens'
    k/v rows land in the pool first, then the queries attend over each
    request's logical cache through its block table under ``mask``. On
    a serving mesh, over this rank's heads, the output projection's
    partial products summed over the model group (every head, and no
    sum, where the heads do not split)."""
    a = L.rmsnorm(layer.attn_norm, h, cfg.norm_eps)
    group = pax.model_group()
    if group is not None and not heads_split(cfg, C.size(group)):
        group = None            # every head on every rank
    w = layer.attn if group is None else _rank_heads(layer.attn, cfg, group)
    q, k, v = L.project_qkv(w, cfg, a, rot)
    _pool_scatter(pk, pv, k.flatten(0, 1), v.flatten(0, 1), flat)
    o = L.out_proj(w, kops.paged_attention(q, pk, pv, block_tables,
                                           cache_len, q_offset=q_offset,
                                           mask=mask))
    if group is not None:
        o = C.all_reduce_(o, group)
    h = h + o
    y, _ = ffn(layer, cfg, L.rmsnorm(layer.mlp_norm, h, cfg.norm_eps))
    return h + y


def lm_paged_decode_step(model: LMModel, pool: dict, tokens, pos,
                         block_tables, *, sparse: bool = False):
    """One serving decode step over the paged pool. tokens (B, 1) int;
    ``pos`` (B,) int64, each slot's cache length (slot b's new token is
    written at its logical position ``pos[b]``: no shared engine clock);
    ``block_tables`` (B, nmax) int64. Returns ``(logits (B, 1, V),
    pool)``, the pool written in place. Shapes are independent of every
    request's length, so the engine calls it with one signature."""
    cfg = model.cfg
    page, nmax = pool["layers"]["k"].shape[2], block_tables.shape[1]
    window, n_global = _sparse_mask(cfg, sparse)
    blk = block_tables.gather(1, (pos // page)[:, None])[:, 0]
    flat = blk * page + pos % page
    rot = _rotation(cfg, pos[:, None])
    cache_len = pos + 1
    mask = L.attention_mask(nmax * page, cache_len, window=window,
                            n_global=n_global, device=tokens.device)
    h = L.embed_tokens(model.embed, tokens, getattr(torch, cfg.dtype))
    for layer, pk, pv in _all_layers(model, pool):
        h = _layer_paged(layer, h, cfg, pk, pv, rot, flat, block_tables,
                         cache_len, None, mask)
    h = L.rmsnorm(model.final_norm, h, cfg.norm_eps)
    return L.logits_fn(model.embed, cfg, h), pool


def lm_prefill_chunk(model: LMModel, pool: dict, tokens, offset: int,
                     length: int, block_tables, *, sparse: bool = False):
    """One fixed-size chunk of a single prompt (B == 1) through the full
    forward, writing its k/v into the paged pool in place.

    tokens (1, C) int, the chunk, arbitrary-padded past ``length``;
    ``offset`` (host int) the logical position of ``tokens[0, 0]`` (0
    for a prompt's first chunk); ``length`` (host int, in [1, C]) the
    valid tokens; ``block_tables`` (1, nmax) int64. Padding rows park
    their k/v in scratch block 0, row 0. Returns ``(logits (1, 1, V)`` at
    the chunk's last valid position, ``pool)``. C and nmax are engine
    constants, so every chunk of every prompt has one signature."""
    cfg = model.cfg
    dev = tokens.device
    page, nmax = pool["layers"]["k"].shape[2], block_tables.shape[1]
    offset, length = int(offset), int(length)
    window, n_global = _sparse_mask(cfg, sparse)
    tpos = torch.arange(offset, offset + tokens.shape[1], device=dev)
    blk = block_tables[0][torch.clamp(tpos // page, max=nmax - 1)]
    flat = blk * page + tpos % page
    flat[length:] = 0
    cache_len = offset + length
    rot = _rotation(cfg, tpos[None])
    mask = L.attention_mask(nmax * page, cache_len, tpos[None],
                            window=window, n_global=n_global, device=dev)
    h = L.embed_tokens(model.embed, tokens, getattr(torch, cfg.dtype))
    for layer, pk, pv in _all_layers(model, pool):
        h = _layer_paged(layer, h, cfg, pk, pv, rot, flat, block_tables,
                         cache_len, offset, mask)
    h = L.rmsnorm(model.final_norm, h, cfg.norm_eps)
    last = h[:, max(length - 1, 0):max(length, 1)]
    return L.logits_fn(model.embed, cfg, last), pool
