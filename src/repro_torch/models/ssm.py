"""Mamba2 block — SSD (state-space duality, arXiv:2405.21060), in plain
PyTorch.

The port's counterpart of ``repro.models.ssm``, term for term:
``ssm_dims``, ``mamba_defs``, ``_causal_conv``, ``ssd_chunked``,
``ssd_decode_step``, ``_split_proj`` and ``mamba_apply``. Within a chunk
the recurrence is computed in its quadratic "attention-like" dual form;
across chunks a small scan carries the (B, H, dh, N) state. The block
calls the plain ``ssd_chunked``, as the reference's model calls its jnp
one (the SSD kernel, ``ops.ssd``, serves the autotuner). Decode
(``mamba_decode``) advances one token through the conv history and the
recurrence (``ssd_decode_step``), over the caches of
``mamba_cache_defs``.

Per-head layout: x (B,S,H,dh), dt (B,S,H), a (H,), b/c shared across heads
(single group): (B,S,N).

On a sequence shard (``mamba_apply_sharded``, the reference's "train"
recipe: the sequence whole inside the mixer, ``inner`` on "model"): the
residual's sequence is all-gathered; rank m takes its H/P SSM heads,
``in_proj``'s z, x and dt columns of them and B and C whole, the causal
conv over its channels, the plain ``ssd_chunked`` over its heads and the
gated RMSNorm with its sum of squares summed over the group (the norm
is over the whole ``d_inner``); ``out_proj``'s rows of its channels give
a partial product, reduce-scattered back to the rank's shard. Where the
heads do not split P ways every rank runs the whole mixer on the
gathered sequence and keeps its own rows (the ``fit_spec`` rule).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel import collectives as C

F32 = torch.float32


def ssm_dims(cfg):
    """``(d_inner, n_heads, head_dim, state)`` of the Mamba2 block."""
    d_inner = cfg.expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def mamba_defs(cfg) -> dict:
    """``{name: (shape, init)}`` of one Mamba2 block: the reference's
    ``mamba_defs`` names, shapes and init families (``conv_w`` a normal
    of scale 0.1)."""
    D = cfg.d_model
    d_inner, H, dh, N = ssm_dims(cfg)
    conv_dim = d_inner + 2 * N  # conv over x, B, C (mamba2 layout)
    return {
        "in_proj": ((D, 2 * d_inner + 2 * N + H), "fan_in"),
        "conv_w": ((cfg.conv_width, conv_dim), 0.1),
        "conv_b": ((conv_dim,), "zeros"),
        "a_log": ((H,), "zeros"),        # A = -exp(a_log)
        "dt_bias": ((H,), "zeros"),
        "d_skip": ((H,), "ones"),
        "norm": ((d_inner,), "ones"),
        "out_proj": ((d_inner, D), "fan_in"),
    }


class Mamba(nn.Module):
    """The parameters of :func:`mamba_defs`, under the same names."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        for name, (shape, _) in mamba_defs(cfg).items():
            setattr(self, name, nn.Parameter(torch.empty(shape,
                                                         device=device)))


def _causal_conv(x, w, b):
    """Depthwise causal conv. x (B,S,C), w (K,C)."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(K))
    return out + b[None, None, :]


def ssd_chunked(x, dt, a, b, c, chunk: int):
    """Chunked SSD scan, the plain version of the SSD kernel.

    x: (B,S,H,dh) values; dt: (B,S,H) >0; a: (H,) <0; b,c: (B,S,N).
    Returns y (B,S,H,dh) in x's dtype, final_state (B,H,dh,N) fp32.
    Differentiable by autograd."""
    B, S, H, dh = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} % chunk {Q}")
    nc = S // Q

    # decay exponents per position
    da = dt * a[None, None, :]                     # (B,S,H)  negative
    xr = x.reshape(B, nc, Q, H, dh)
    dar = da.reshape(B, nc, Q, H)
    dtr = dt.reshape(B, nc, Q, H)
    br = b.reshape(B, nc, Q, N)
    cr = c.reshape(B, nc, Q, N)

    cum = torch.cumsum(dar, dim=2)                 # (B,nc,Q,H) within-chunk
    total = cum[:, :, -1]                          # (B,nc,H)

    # --- intra-chunk (quadratic dual form) ---
    # L[q,t] = exp(cum_q - cum_t) for q >= t else 0. Valid entries have
    # seg <= 0, so clamping at 0 is exact — and keeps masked entries from
    # overflowing to inf (whose 0*inf backward would be NaN).
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.where(tri[None, None, :, :, None],
                    torch.exp(torch.clamp(seg, max=0.0)),
                    torch.zeros((), dtype=seg.dtype, device=x.device))
    cb = torch.einsum("bnqs,bnts->bnqt", cr.to(F32), br.to(F32))
    w = cb[..., None] * L                          # (B,nc,Q,Q,H)
    xdt = xr * dtr[..., None]                      # dt-weighted values
    y_intra = torch.einsum("bnqth,bnthp->bnqhp", w, xdt.to(F32))

    # --- chunk states ---
    # state_n = sum_t exp(total - cum_t) * dt_t * b_t x_t  : (B,nc,H,dh,N)
    decay_to_end = torch.exp(total[:, :, None, :] - cum)  # (B,nc,Q,H)
    sb = torch.einsum("bnth,bnthp,bnts->bnhps",
                      (decay_to_end * dtr).to(F32), xr.to(F32), br.to(F32))

    # --- inter-chunk scan: the state BEFORE each chunk ---
    state = torch.zeros((B, H, dh, N), dtype=F32, device=x.device)
    prev = []
    for n in range(nc):
        prev.append(state)
        state = state * torch.exp(total[:, n]).to(F32)[:, :, None, None] \
            + sb[:, n]
    prev_states = torch.stack(prev, dim=1)         # (B,nc,H,dh,N)

    # --- inter-chunk contribution: y += exp(cum) * C @ state_prev ---
    y_inter = torch.einsum("bnqs,bnhps,bnqh->bnqhp", cr.to(F32), prev_states,
                           torch.exp(cum).to(F32))
    y = (y_intra + y_inter).reshape(B, S, H, dh)
    return y.to(x.dtype), state


def ssd_decode_step(state, x, dt, a, b, c):
    """One-token recurrence. state (B,H,dh,N); x (B,H,dh); dt (B,H);
    b,c (B,N). Returns (y (B,H,dh), new_state)."""
    da = torch.exp(dt * a[None, :])[:, :, None, None]        # (B,H,1,1)
    upd = torch.einsum("bhp,bn,bh->bhpn", x.to(F32), b.to(F32),
                       dt.to(F32))
    state = state * da + upd
    y = torch.einsum("bhpn,bn->bhp", state, c.to(F32))
    return y.to(x.dtype), state


def _split_proj(cfg, zxbcdt):
    """The in-projection ``(B, S, 2 d_inner + 2N + H)`` -> ``z, x, b, c,
    dt``."""
    d_inner, H, dh, N = ssm_dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, N, N, H], dim=-1)


def mamba_apply(p: Mamba, cfg, h):
    """Full-sequence Mamba2 block (training): h (B,S,D) -> (out (B,S,D),
    final state (B,H,dh,N) fp32). Compute in h's dtype, fp32 in the SiLU,
    the softplus, the scan and the gated RMSNorm, as the reference."""
    B, S, D = h.shape
    d_inner, H, dh, N = ssm_dims(cfg)
    dt_ = h.dtype
    zxbcdt = h @ p.in_proj.to(dt_)
    z, xi, b, c, dtp = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xi, b, c], dim=-1)
    xbc = F.silu(_causal_conv(xbc, p.conv_w.to(dt_),
                              p.conv_b.to(dt_)).float()).to(dt_)
    xi, b, c = torch.split(xbc, [d_inner, N, N], dim=-1)
    dt = F.softplus(dtp.float() + p.dt_bias.float())       # (B,S,H)
    a = -torch.exp(p.a_log.float())
    xh = xi.reshape(B, S, H, dh)
    y, final = ssd_chunked(xh, dt, a, b, c, cfg.ssm_chunk)
    y = y + xh * p.d_skip.to(dt_)[None, None, :, None]
    y = y.reshape(B, S, d_inner)
    # gated RMSNorm (mamba2)
    y = y * F.silu(z.float()).to(dt_)
    y32 = y.float()
    y = (y32 * torch.rsqrt(y32.square().mean(-1, keepdim=True)
                           + cfg.norm_eps) * p.norm.float()).to(dt_)
    return y @ p.out_proj.to(dt_), final


def _mamba_heads(p: Mamba, cfg, h, m: int, parts: int, group):
    """Rank m's part of the Mamba2 block over the whole sequence h
    (B, S, D): its ``H / parts`` SSM heads and their ``d_inner / parts``
    channels, B and C whole; returns its partial output (B, S, D) (the
    sum over the ranks is :func:`mamba_apply`'s)."""
    d_inner, H, dh, N = ssm_dims(cfg)
    hl = H // parts
    dl = hl * dh
    h0, d0 = m * hl, m * dl
    dt_ = h.dtype
    w = p.in_proj
    cols = torch.cat([w[:, d0:d0 + dl],                       # z
                      w[:, d_inner + d0:d_inner + d0 + dl],   # x
                      w[:, 2 * d_inner:2 * d_inner + 2 * N],  # B, C
                      w[:, 2 * d_inner + 2 * N + h0:
                        2 * d_inner + 2 * N + h0 + hl]], 1)   # dt
    z, xi, b, c, dtp = torch.split(h @ cols.to(dt_), [dl, dl, N, N, hl],
                                   dim=-1)
    chans = lambda t: torch.cat([t[..., d0:d0 + dl],  # noqa: E731
                                 t[..., d_inner:]], -1)
    xbc = torch.cat([xi, b, c], dim=-1)
    xbc = F.silu(_causal_conv(xbc, chans(p.conv_w).to(dt_),
                              chans(p.conv_b).to(dt_)).float()).to(dt_)
    xi, b, c = torch.split(xbc, [dl, N, N], dim=-1)
    dt = F.softplus(dtp.float() + p.dt_bias[h0:h0 + hl].float())
    a = -torch.exp(p.a_log[h0:h0 + hl].float())
    B, S = h.shape[:2]
    xh = xi.reshape(B, S, hl, dh)
    y, _ = ssd_chunked(xh, dt, a, b, c, cfg.ssm_chunk)
    y = y + xh * p.d_skip[h0:h0 + hl].to(dt_)[None, None, :, None]
    y = y.reshape(B, S, dl) * F.silu(z.float()).to(dt_)
    y32 = y.float()
    # the gated RMSNorm normalises over the whole d_inner
    ss = C.AllReduce.apply(y32.square().sum(-1, keepdim=True), group)
    y = (y32 * torch.rsqrt(ss / d_inner + cfg.norm_eps)
         * p.norm[d0:d0 + dl].float()).to(dt_)
    return y @ p.out_proj[d0:d0 + dl].to(dt_)


def mamba_apply_sharded(p: Mamba, cfg, h, group):
    """The Mamba2 block on this rank's sequence shard h (B, S/P, D) of a
    sequence sharded over ``group``: -> this rank's shard of the output
    (B, S/P, D). The sequence is all-gathered (``GatherSeq``, whose
    backward reduce-scatters); with the SSM heads split P ways the rank
    runs its heads (:func:`_mamba_heads`) and the partial outputs are
    reduce-scattered (``ScatterSeq``), else it runs the whole block and
    keeps its rows."""
    parts, m = C.size(group), C.rank(group)
    hf = C.GatherSeq.apply(h, group)
    if ssm_dims(cfg)[1] % parts == 0:
        return C.ScatterSeq.apply(_mamba_heads(p, cfg, hf, m, parts, group),
                                  group)
    n = h.shape[1]
    return mamba_apply(p, cfg, hf)[0][:, m * n:(m + 1) * n]


def mamba_mixer(p: Mamba, cfg, h, group=None):
    """The block's output alone: :func:`mamba_apply`'s, or with ``group``
    (h this rank's shard of a sequence sharded over it)
    :func:`mamba_apply_sharded`'s."""
    if group is None:
        return mamba_apply(p, cfg, h)[0]
    return mamba_apply_sharded(p, cfg, h, group)


def mamba_decode(p: Mamba, cfg, h, cache: dict):
    """One-token decode. h (B, 1, D); ``cache`` ``{"conv": (B, K-1,
    conv_dim), "ssm": (B, H, dh, N) fp32}``. Returns ``(out (B, 1, D),
    new_cache)``, a new cache, as the reference's: the conv history takes
    the promoted dtype of the cache and the activations, so an fp32 model
    keeps it fp32 after its first step, as the reference does."""
    B = h.shape[0]
    d_inner, H, dh, N = ssm_dims(cfg)
    dt_ = h.dtype
    zxbcdt = h @ p.in_proj.to(dt_)
    z, xi, b, c, dtp = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xi, b, c], dim=-1)[:, 0]                # (B, conv_dim)
    hist = torch.promote_types(cache["conv"].dtype, dt_)
    conv_hist = torch.cat([cache["conv"].to(hist), xbc.to(hist)[:, None]],
                          dim=1)                               # (B, K, C)
    w = p.conv_w.to(dt_)                                       # (K, C)
    # the K-term product in fp32, rounded once (an einsum's accumulation)
    conv = (conv_hist.float() * w.float()[None]).sum(1).to(hist)
    conv_out = conv + p.conv_b.to(dt_)[None]
    xbc = F.silu(conv_out.float()).to(dt_)
    xi, b, c = torch.split(xbc, [d_inner, N, N], dim=-1)
    dt = F.softplus(dtp.float()[:, 0] + p.dt_bias.float())     # (B, H)
    a = -torch.exp(p.a_log.float())
    xh = xi.reshape(B, H, dh)
    y, new_state = ssd_decode_step(cache["ssm"], xh, dt, a, b, c)
    y = y + xh * p.d_skip.to(dt_)[None, :, None]
    y = y.reshape(B, d_inner)
    y = y * F.silu(z.float()[:, 0]).to(dt_)
    y32 = y.float()
    y = (y32 * torch.rsqrt(y32.square().mean(-1, keepdim=True)
                           + cfg.norm_eps) * p.norm.float()).to(dt_)
    out = (y @ p.out_proj.to(dt_))[:, None]
    return out, {"conv": conv_hist[:, 1:], "ssm": new_state}


def mamba_cache_defs(cfg, batch: int, *, device="cpu") -> dict:
    """Zeroed decode caches of one Mamba2 block on ``device``: the conv
    history ``(batch, K-1, conv_dim)`` bf16 and the SSM state ``(batch,
    H, dh, N)`` fp32, the reference's ``mamba_cache_defs``."""
    d_inner, H, dh, N = ssm_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, d_inner + 2 * N),
                            dtype=torch.bfloat16, device=device),
        "ssm": torch.zeros((batch, H, dh, N), dtype=F32, device=device),
    }
