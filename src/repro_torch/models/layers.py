"""Transformer layers of the graph models and the token LMs: RMSNorm,
the per-head qk-norm, RoPE, the attention projections, the SwiGLU MLP,
the token embedding and its tied unembedding, the chunked cross-entropy,
the dense chunked attention (the graph model's interleave step, the
LM's dense backend), the serving paths' masked attention over a KV cache
and the layer recomputation every family reads from ``cfg.remat`` — the
port's counterparts of ``repro.models.layers`` (``rmsnorm``,
``headnorm``, ``rope``, ``project_qkv``, ``out_proj``, ``mlp``,
``embed_tokens``, ``logits_fn``, ``chunked_softmax_xent``,
``chunked_attention``, ``decode_attention``) and of
``repro.models.lm._maybe_remat``.

Parameters keep the reference's shapes (``wq`` is ``(D, H, Dh)``, ``wo``
``(H, Dh, D)``, ``tok`` ``(vocab_padded, D)``), so a JAX parameter tree
loads as it is. Parameters are fp32; compute runs in the activations'
dtype, with fp32 inside the norms, RoPE, the SiLU and the loss, as the
reference does.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import fake
from repro_torch.convert import leaf_name
from repro_torch.parallel import collectives as C


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))


def rmsnorm(p: RMSNorm, x, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)


def headnorm(scale, x, eps: float = 1e-6):
    """Per-head RMSNorm over head_dim (qwen3 qk_norm). x: (..., H, Dh)."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_cos_sin(pos, d: int, theta: float):
    """The rotation of :func:`rope` for positions ``pos`` ((B, S) or (S,)
    int) and head dim ``d``: fp32 ``(cos, sin)``, each
    ``(B or 1, S, 1, d // 2)``. Computed once per forward and shared by
    every layer."""
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=pos.device) / half)
    if pos.dim() == 1:
        pos = pos[None, :]
    ang = pos.float()[:, :, None] * freq[None, None, :]      # (B, S, half)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rope(x, pos, theta: float):
    """Rotary embedding, llama split-half convention.

    x: (B, S, H, Dh); pos: (B, S) or (S,) int positions, or the
    ``(cos, sin)`` pair :func:`rope_cos_sin` made of them. theta==0 ->
    no-op (NoPE).
    """
    if not theta:
        return x
    half = x.shape[-1] // 2
    cos, sin = pos if isinstance(pos, tuple) else rope_cos_sin(
        pos, x.shape[-1], theta)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class Attention(nn.Module):
    """``wq`` ``(D, H, Dh)``, ``wk``/``wv`` ``(D, KV, Dh)``, ``wo``
    ``(H, Dh, D)``; with ``qk_norm`` also the per-head ``q_norm`` and
    ``k_norm`` scales ``(Dh,)``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
        self.wq = nn.Parameter(torch.empty(D, H, Dh, device=device))
        self.wk = nn.Parameter(torch.empty(D, KV, Dh, device=device))
        self.wv = nn.Parameter(torch.empty(D, KV, Dh, device=device))
        self.wo = nn.Parameter(torch.empty(H, Dh, D, device=device))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(Dh, device=device))
            self.k_norm = nn.Parameter(torch.ones(Dh, device=device))


def attention_defs(cfg, prefix: str) -> dict:
    """``{prefix + name: (shape, init)}`` of one attention block."""
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    defs = {"wq": ((D, H, Dh), "fan_in"), "wk": ((D, KV, Dh), "fan_in"),
            "wv": ((D, KV, Dh), "fan_in"), "wo": ((H, Dh, D), "fan_in")}
    if cfg.qk_norm:
        defs.update(q_norm=((Dh,), "ones"), k_norm=((Dh,), "ones"))
    return {prefix + k: v for k, v in defs.items()}


def mlp_defs(cfg, prefix: str, d_ff: int = 0) -> dict:
    """``{prefix + name: (shape, init)}`` of one SwiGLU MLP of width
    ``d_ff`` (default ``cfg.d_ff``)."""
    D, FF = cfg.d_model, d_ff or cfg.d_ff
    return {prefix + "w_gate": ((D, FF), "fan_in"),
            prefix + "w_up": ((D, FF), "fan_in"),
            prefix + "w_down": ((FF, D), "fan_in")}


def _proj(x, w):
    """x (B, S, D) @ w (D, ...) -> (B, S, ...) in x's dtype."""
    out = x @ w.to(x.dtype).reshape(w.shape[0], -1)
    return out.view(*x.shape[:-1], *w.shape[1:])


def project_qkv(p: Attention, cfg, x, pos):
    """x (B, S, D) -> q (B, S, H, Dh), k/v (B, S, KV, Dh), with qk_norm +
    rope. ``pos`` as :func:`rope` takes it (unused when
    ``cfg.rope_theta`` is 0)."""
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qk_norm:
        q = headnorm(p.q_norm, q, cfg.norm_eps)
        k = headnorm(p.k_norm, k, cfg.norm_eps)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def out_proj(p: Attention, x):
    """x (B, S, H, Dh) -> (B, S, D)."""
    H, Dh, D = p.wo.shape
    return x.reshape(*x.shape[:-2], H * Dh) @ p.wo.to(x.dtype).reshape(H * Dh,
                                                                       D)


class MLP(nn.Module):
    """SwiGLU weights of width ``d_ff`` (default ``cfg.d_ff``)."""

    def __init__(self, cfg, d_ff: int = 0, *, device=None):
        super().__init__()
        D, FF = cfg.d_model, d_ff or cfg.d_ff
        self.w_gate = nn.Parameter(torch.empty(D, FF, device=device))
        self.w_up = nn.Parameter(torch.empty(D, FF, device=device))
        self.w_down = nn.Parameter(torch.empty(FF, D, device=device))


def mlp(p: MLP, x):
    dt = x.dtype
    g = x @ p.w_gate.to(dt)
    u = x @ p.w_up.to(dt)
    h = F.silu(g.float()).to(dt) * u
    return h @ p.w_down.to(dt)


def _attend_q_chunk(qblk, kb, vb, q0: int, Sq: int, Sk: int, causal: bool,
                    q_offset: int, *bias_tiles):
    """Online softmax of one q-chunk ``(B, cq, KV, G, Dh)`` over every
    k-chunk of ``kb``/``vb`` ``(B, nk, ck, KV, Dh)``, with one bias tile
    per k-chunk (or none); returns ``(B, KV, G, cq, Dh)`` fp32. Scores and
    the PV product accumulate in fp32 from the inputs' values (the
    reference's ``preferred_element_type=F32``); the probabilities are
    rounded to v's dtype before the PV product, as in the reference.
    ``causal`` masks ``q_offset + qpos < kpos`` and skips the k-chunks it
    empties (they would add nothing)."""
    B, cq, KV, G, Dh = qblk.shape
    nk, ck = kb.shape[1], kb.shape[2]
    dev = qblk.device
    qf = qblk.float()
    qpos = q0 + torch.arange(cq, device=dev)
    m = torch.full((B, KV, G, cq), float("-inf"), device=dev)
    l = torch.zeros((B, KV, G, cq), device=dev)
    acc = torch.zeros((B, KV, G, cq, Dh), device=dev)
    for ki in range(nk):
        if causal and ki * ck > q_offset + q0 + cq - 1:
            break
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, kb[:, ki].float())
        s = s * Dh ** -0.5
        kpos = ki * ck + torch.arange(ck, device=dev)
        valid = (kpos < Sk)[None, :] & (qpos < Sq)[:, None]    # (cq, ck)
        if causal:
            valid = valid & (q_offset + qpos[:, None] >= kpos[None, :])
        if bias_tiles:
            # zero-padded at the ragged edges (the padding is masked below)
            bb = bias_tiles[ki]
            if bb.shape[-2:] != (cq, ck):
                bb = F.pad(bb, (0, ck - bb.shape[-1], 0, cq - bb.shape[-2]))
            s = s + bb.reshape(bb.shape[0], KV, G, cq, ck).float()
        s = s.masked_fill(~valid, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        # dead rows (all -inf so far) shift by 0: p and corr come out 0
        # without an inf - inf anywhere, in the forward or the backward
        m_safe = m_new.masked_fill(torch.isneginf(m_new), 0.0)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(m - m_safe)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(vb.dtype).float(),
                          vb[:, ki].float())
        acc = acc * corr[..., None] + pv
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


def chunked_attention(q, k, v, *, causal: bool = False, chunk_q: int = 2048,
                      chunk_k: int = 1024, bias=None, q_offset: int = 0):
    """Memory-bounded flash-style attention in plain PyTorch (the graph
    model's dense interleave step, and the LM's dense backend and short
    sequences; the reference computes it in jnp, outside any Pallas
    kernel). ``causal`` masks ``qpos < kpos``.

    q ``(B, Sq, H, Dh)``, k/v ``(B, Sk, KV, Dh)`` with ``H % KV == 0``
    (GQA; k/v are never repeated); ``bias`` an optional
    ``(B or 1, H, Sq, Sk)`` additive bias. Returns ``(B, Sq, H, Dh)`` in
    q's dtype. ``q_offset`` is the global position of q's first row
    (sequence-parallel callers: q a shard, k/v the whole sequence). Each
    q-chunk runs under ``torch.utils.checkpoint``: the
    backward recomputes its scores instead of keeping the chunk's
    ``(cq, Sk)`` score tensors alive (the reference's
    ``@jax.checkpoint``)."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    nq, nk = -(-Sq // cq), -(-Sk // ck)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * cq - Sq))
    kb = F.pad(k, (0, 0, 0, 0, 0, nk * ck - Sk)).view(B, nk, ck, KV, Dh)
    vb = F.pad(v, (0, 0, 0, 0, 0, nk * ck - Sk)).view(B, nk, ck, KV, Dh)
    qb = qp.view(B, nq, cq, KV, G, Dh)
    # the bias cut into (cq, ck) tiles by split, whose backward assembles
    # the tiles' gradients once; a slice per tile would allocate a
    # full-size zero gradient for each
    tiles = [[] for _ in range(nq)] if bias is None else \
        [t.split(ck, dim=3) for t in bias.split(cq, dim=2)]
    outs = [checkpoint(_attend_q_chunk, qb[:, i], kb, vb, i * cq, Sq, Sk,
                       causal, q_offset, *tiles[i], use_reentrant=False)
            for i in range(nq)]
    out = torch.stack(outs, 1)                    # (B, nq, KV, G, cq, Dh)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, nq * cq, H, Dh)[:, :Sq]
    return out.to(q.dtype)


def attention_mask(S: int, cache_len, q_pos=None, *, window: int = 0,
                   n_global: int = 0, device=None):
    """The serving paths' mask over ``S`` cache rows, ``(B or 1, 1, 1,
    Sq, S)`` bool, to broadcast against scores ``(B, KV, G, Sq, S)``:
    rows at or past ``cache_len`` (a host int, or ``(B,)`` int) and rows
    after the query (``kpos > qpos``) are masked out. ``q_pos`` ``(B or
    1, Sq)`` int holds the queries' positions; ``None`` means decode (one
    query at ``cache_len - 1``). ``window``/``n_global`` > 0 add the
    TorchGT cluster-sparse decode mask: only the ``window`` rows up to
    the query and the ``n_global`` leading sink rows stay. The
    reference's ``decode_attention`` and ``paged_attention_ref`` build
    it inline; the port's models build it once a step and share it
    across the layers."""
    kpos = torch.arange(S, device=device)[None, None, :]
    ln = cache_len.reshape(-1, 1, 1) if torch.is_tensor(cache_len) \
        else int(cache_len)
    qp = ln - 1 if q_pos is None else q_pos.reshape(
        q_pos.shape[0], -1, 1)
    valid = (kpos < ln) & (kpos <= qp)
    if window:
        valid = valid & ((kpos >= qp + 1 - window) | (kpos < n_global))
    return valid[:, None, None]


def masked_attention(q, k, v, valid):
    """Attention of q ``(B, Sq, H, Dh)`` over k/v ``(B, S, KV, Dh)``
    (GQA) under the mask ``valid`` of :func:`attention_mask`, as the
    reference's serving paths compute it: fp32 scores from the inputs'
    values, an fp32 softmax, the probabilities rounded to v's dtype before
    an fp32 PV product, the output in q's dtype."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, Dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * Dh ** -0.5
    p = torch.softmax(s.masked_fill(~valid, float("-inf")), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     n_global: int = 0):
    """Single-token attention over a contiguous KV cache.

    q ``(B, 1, H, Dh)``; caches ``(B, S, KV, Dh)``; ``cache_len`` a host
    int or ``(B,)`` int, the live rows. ``window``/``n_global`` > 0 ->
    the TorchGT cluster-sparse decode mask (local window + global sink
    tokens) instead of full-cache attention."""
    valid = attention_mask(k_cache.shape[1], cache_len, window=window,
                           n_global=n_global, device=q.device)
    return masked_attention(q, k_cache, v_cache, valid)


class Embedding(nn.Module):
    """``tok`` ``(vocab_padded, D)``, and ``unembed`` ``(D, vocab_padded)``
    when the embeddings are not tied."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        D, Vp = cfg.d_model, cfg.vocab_padded
        self.tok = nn.Parameter(torch.empty(Vp, D, device=device))
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(torch.empty(D, Vp, device=device))


def embed_tokens(p: Embedding, tokens, dtype, cfg=None):
    """tokens (B, S) int -> (B, S, D) in ``dtype``. With a ``cfg`` of the
    encoder-decoder family the embeddings are scaled by
    ``sqrt(d_model)`` after the cast, the scale rounded to ``dtype``
    first, as the reference multiplies by a weakly typed scalar."""
    out = F.embedding(tokens, p.tok).to(dtype)
    if cfg is not None and cfg.family == "encdec":
        out = out * torch.tensor(cfg.d_model ** 0.5, dtype=dtype).item()
    return out


def _unembed(p: Embedding, cfg, dtype):
    """The ``(D, vocab_padded)`` output projection in ``dtype``."""
    w = p.tok.t() if cfg.tie_embeddings else p.unembed
    return w.to(dtype)


def logits_fn(p: Embedding, cfg, h):
    """(B, S, D) -> (B, S, vocab_padded) logits in h's dtype."""
    return h @ _unembed(p, cfg, h.dtype)


def _xent_chunk(h, labels, w, vocab_size: int):
    """Summed cross-entropy and label count of one chunk: fp32 logits of
    ``h @ w``, the vocab padding masked to -1e30, labels -1 ignored."""
    logits = (h @ w).float()
    if w.shape[1] != vocab_size:    # mask vocab padding
        pad = torch.arange(w.shape[1], device=h.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((logz - ll) * mask).sum(), mask.sum()


def chunked_softmax_xent(p: Embedding, cfg, h, labels, chunk: int = 512,
                         group=None):
    """Cross-entropy without materializing full (B, S, V) logits: one
    sequence chunk at a time, each under ``torch.utils.checkpoint`` so the
    backward recomputes its logits instead of keeping them (the
    reference's ``@jax.checkpoint``). labels==-1 positions are masked
    out. Returns the mean loss (fp32); with ``group`` (the sequence's
    shards over a process group) the global mean over every shard."""
    w = _unembed(p, cfg, h.dtype)
    tot = cnt = 0.0
    for a in range(0, h.shape[1], chunk):
        t, c = checkpoint(_xent_chunk, h[:, a:a + chunk],
                          labels[:, a:a + chunk], w, cfg.vocab_size,
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    if group is not None:
        tot, cnt = C.SumAcross.apply(torch.stack([tot, cnt]), group)
    return tot / torch.clamp(cnt, min=1.0)


def _save_unbatched_products(ctx, op, *args, **kwargs):
    """The policy of ``remat="dots"``, the counterpart of
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the un-batched products. The projections, the MLP and the experts'
    products are ``(B, S, D) @ (D, N)``, which matmul folds into one
    ``mm``; the score products are ``bmm`` (or a kernel) and get
    recomputed. The router's logits are such a product, so the
    recomputation routes every token as the forward did."""
    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(fn, cfg, contexts=None):
    """``fn`` under the recomputation ``cfg.remat`` names, the port of the
    reference's ``_maybe_remat``: ``"none"`` -> ``fn`` itself; ``"dots"``
    -> a selective checkpoint that keeps the un-batched products' outputs;
    anything else -> a checkpoint of the whole of ``fn``, run under
    ``contexts`` (a checkpoint's ``context_fn``) where the caller gives
    one: a model with experts passes ``moe.routing_contexts``, so that
    the recomputation routes as the forward did. With grad disabled
    (serving, evaluation) there is nothing to keep, and ``fn`` runs as it
    is. Non-reentrant checkpoints, so the first pass runs with grad
    enabled and takes the ops' autograd branch, as the recomputation
    does. No layer draws random numbers, so the RNG state is not saved
    and restored around the recomputation."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_unbatched_products)
    elif contexts is not None:
        kw["context_fn"] = contexts
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False, **kw)


def _def_name(name: str) -> str:
    """``layers.3.attn.wq`` -> ``layers.attn.wq`` (and so for every
    stacked axis: the hybrid's ``periods``, the encoder-decoder's
    ``enc_layers`` and ``dec_layers``)."""
    return leaf_name(name)[0]


_DRAW = {"on_device": False}


@contextlib.contextmanager
def draw_on_device():
    """Inside, :func:`seeded_init` draws each parameter's numbers on the
    parameter's own device (a generator there, seeded the same): a large
    model's init then costs no host time, and its numbers are the
    device's stream, not the CPU's."""
    prev = _DRAW["on_device"]
    _DRAW["on_device"] = True
    try:
        yield
    finally:
        _DRAW["on_device"] = prev


@torch.no_grad()
def seeded_init(model: nn.Module, defs: dict, seed: int = 0) -> None:
    """Initialise ``model``'s parameters from ``defs`` (``{name: (shape,
    init)}``, per layer for the stacked names: ``layers.*``,
    ``periods.*``, ``enc_layers.*``, ``dec_layers.*``), drawn on the CPU
    in registration order so the
    weights do not depend on the device (under :func:`draw_on_device`,
    on the parameters' device). The
    init families are the reference's: ``fan_in`` is a normal scaled by
    ``shape[0] ** -0.5``, ``normal``/``embed`` a normal scaled by 0.02;
    a float ``init`` is a normal of that scale; the random numbers are
    the port's own. A stack holding part of its experts (its
    ``expert_part``) gets its rows of the whole stack's draw. Inside a
    fake mode (``repro_torch.fake``) nothing is drawn: a traced step
    needs the parameters' shapes, not their values."""
    if fake.active():
        return
    gens = {}
    for name, p in model.named_parameters():
        shape, init = defs[_def_name(name)]
        # a stack holding expert part m of P is rows [m n, (m+1) n) of
        # the whole one, drawn whole so the stream stays the same
        m, parts = getattr(p, "expert_part", (0, 1))
        n = shape[0] // parts
        assert tuple(p.shape) == (n, *shape[1:]), (name, p.shape, shape)
        if init == "zeros":
            p.zero_()
        elif init == "ones":
            p.fill_(1.0)
        else:
            scale = (shape[0] ** -0.5 if init == "fan_in" else
                     init if isinstance(init, float) else 0.02)
            dev = p.device if _DRAW["on_device"] else torch.device("cpu")
            if dev not in gens:
                gens[dev] = torch.Generator(device=dev).manual_seed(seed)
            p.copy_(torch.randn(shape, generator=gens[dev], device=dev)
                    [m * n:(m + 1) * n] * scale)
