"""Transformer layers the graph models use: RMSNorm, the attention
projections and the SwiGLU MLP — the port's counterparts of
``repro.models.layers`` (``rmsnorm``, ``project_qkv``, ``out_proj``,
``mlp``).

Parameters keep the reference's shapes (``wq`` is ``(D, H, Dh)``, ``wo``
``(H, Dh, D)``), so a JAX parameter tree loads as it is. Parameters are
fp32; compute runs in the activations' dtype, with fp32 inside the norm
and the SiLU, as the reference does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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
