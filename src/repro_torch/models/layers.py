"""Transformer layers the graph models use: RMSNorm, the attention
projections, the SwiGLU MLP and the dense chunked attention of the
interleave step — the port's counterparts of ``repro.models.layers``
(``rmsnorm``, ``project_qkv``, ``out_proj``, ``mlp``,
``chunked_attention``).

Parameters keep the reference's shapes (``wq`` is ``(D, H, Dh)``, ``wo``
``(H, Dh, D)``), so a JAX parameter tree loads as it is. Parameters are
fp32; compute runs in the activations' dtype, with fp32 inside the norm
and the SiLU, as the reference does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))


def rmsnorm(p: RMSNorm, x, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)


class Attention(nn.Module):
    """``wq`` ``(D, H, Dh)``, ``wk``/``wv`` ``(D, KV, Dh)``, ``wo``
    ``(H, Dh, D)``. RoPE and qk-norm are not ported: the graph configs run
    neither (``rope_theta=0``, ``qk_norm=False``)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        if cfg.qk_norm or cfg.rope_theta:
            raise NotImplementedError(
                f"{cfg.name}: qk_norm / RoPE are not ported yet")
        D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
        self.wq = nn.Parameter(torch.empty(D, H, Dh, device=device))
        self.wk = nn.Parameter(torch.empty(D, KV, Dh, device=device))
        self.wv = nn.Parameter(torch.empty(D, KV, Dh, device=device))
        self.wo = nn.Parameter(torch.empty(H, Dh, D, device=device))


def _proj(x, w):
    """x (B, S, D) @ w (D, ...) -> (B, S, ...) in x's dtype."""
    out = x @ w.to(x.dtype).reshape(w.shape[0], -1)
    return out.view(*x.shape[:-1], *w.shape[1:])


def project_qkv(p: Attention, x):
    """x (B, S, D) -> q (B, S, H, Dh), k/v (B, S, KV, Dh)."""
    return _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)


def out_proj(p: Attention, x):
    """x (B, S, H, Dh) -> (B, S, D)."""
    H, Dh, D = p.wo.shape
    return x.reshape(*x.shape[:-2], H * Dh) @ p.wo.to(x.dtype).reshape(H * Dh,
                                                                       D)


class MLP(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        D, FF = cfg.d_model, cfg.d_ff
        self.w_gate = nn.Parameter(torch.empty(D, FF, device=device))
        self.w_up = nn.Parameter(torch.empty(D, FF, device=device))
        self.w_down = nn.Parameter(torch.empty(FF, D, device=device))


def mlp(p: MLP, x):
    dt = x.dtype
    g = x @ p.w_gate.to(dt)
    u = x @ p.w_up.to(dt)
    h = F.silu(g.float()).to(dt) * u
    return h @ p.w_down.to(dt)


def _attend_q_chunk(qblk, kb, vb, q0: int, Sq: int, Sk: int, *bias_tiles):
    """Online softmax of one q-chunk ``(B, cq, KV, G, Dh)`` over every
    k-chunk of ``kb``/``vb`` ``(B, nk, ck, KV, Dh)``, with one bias tile
    per k-chunk (or none); returns ``(B, KV, G, cq, Dh)`` fp32. Scores and
    the PV product accumulate in fp32 from the inputs' values (the
    reference's ``preferred_element_type=F32``); the probabilities are
    rounded to v's dtype before the PV product, as in the reference."""
    B, cq, KV, G, Dh = qblk.shape
    nk, ck = kb.shape[1], kb.shape[2]
    dev = qblk.device
    qf = qblk.float()
    qpos = q0 + torch.arange(cq, device=dev)
    m = torch.full((B, KV, G, cq), float("-inf"), device=dev)
    l = torch.zeros((B, KV, G, cq), device=dev)
    acc = torch.zeros((B, KV, G, cq, Dh), device=dev)
    for ki in range(nk):
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, kb[:, ki].float())
        s = s * Dh ** -0.5
        kpos = ki * ck + torch.arange(ck, device=dev)
        valid = (kpos < Sk)[None, :] & (qpos < Sq)[:, None]    # (cq, ck)
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


def chunked_attention(q, k, v, *, chunk_q: int = 2048, chunk_k: int = 1024,
                      bias=None):
    """Memory-bounded flash-style attention in plain PyTorch, non-causal
    (the dense interleave step; the reference computes it in jnp, outside
    any Pallas kernel; its causal form waits for the LM slice).

    q ``(B, Sq, H, Dh)``, k/v ``(B, Sk, KV, Dh)`` with ``H % KV == 0``
    (GQA; k/v are never repeated); ``bias`` an optional
    ``(B or 1, H, Sq, Sk)`` additive bias. Returns ``(B, Sq, H, Dh)`` in
    q's dtype. Each q-chunk runs under ``torch.utils.checkpoint``: the
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
                       *tiles[i], use_reentrant=False) for i in range(nq)]
    out = torch.stack(outs, 1)                    # (B, nq, KV, G, cq, Dh)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, nq * cq, H, Dh)[:, :Sq]
    return out.to(q.dtype)
