"""Mamba2 SSD (state-space duality, arXiv:2405.21060): the chunked scan
and the one-token recurrence, in plain PyTorch.

The port's counterpart of ``repro.models.ssm.ssd_chunked`` and
``ssd_decode_step``, term for term. Within a chunk the recurrence is
computed in its quadratic "attention-like" dual form; across chunks a
small scan carries the (B, H, dh, N) state. The rest of the Mamba2 block
(projections, the causal convolution, the gate) is not ported yet.

Per-head layout: x (B,S,H,dh), dt (B,S,H), a (H,), b/c shared across heads
(single group): (B,S,N).
"""

from __future__ import annotations

import torch

F32 = torch.float32


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
