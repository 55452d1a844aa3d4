"""Plain PyTorch version of the cluster-sparse attention op.

The port's counterpart of ``repro.core.dual_attention.
cluster_sparse_attention``, in its conventions:

* q ``(B, S, H, Dh)``, k/v ``(B, S, KV, Dh)``; GQA maps head ``h`` to KV
  head ``h // (H // KV)``;
* ``block_idx`` ``(nq, mb)`` (one layout shared by the batch) or
  ``(B, nq, mb)`` (one per graph), -1 padded;
* ``buckets`` int8 ``(nq, mb, bq, bk)`` / ``(B, nq, mb, bq, bk)``, -1
  masked; ``bias_table`` ``(H, n_buckets)``;
* rows with no unmasked entry output 0 (and, with ``return_lse``, a
  logsumexp of 0, as the reference kernel's ``_finalize_row`` writes).

It follows the CUDA kernel's arithmetic rather than the reference
oracle's order: q/k/v are upcast to fp32, the score is
``(q . k) * Dh**-0.5 + bias``, and the probabilities stay fp32 through
the PV product (the JAX oracle rounds them to the input dtype first).

Work is organised by *active block*: every ``(graph, q-block, slot)``
with ``block_idx >= 0`` is gathered once, so memory and time scale with
the number of visited blocks, not with ``nq * mb``. That matters because
the global token's q-block visits almost every k-block while the other
rows visit a handful, which makes ``mb`` (the padded row width) far
larger than the mean row.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def _batched(block_idx, buckets, B):
    if block_idx.dim() == 2:
        block_idx = block_idx.unsqueeze(0).expand(B, -1, -1)
        if buckets is not None:
            buckets = buckets.unsqueeze(0).expand(B, -1, -1, -1, -1)
    return block_idx, buckets


def cluster_sparse_attention(q, k, v, block_idx, buckets=None,
                             bias_table=None, *, causal: bool = False,
                             return_lse: bool = False):
    """Returns O ``(B, S, H, Dh)`` in q's dtype and, with ``return_lse``,
    the per-row logsumexp ``(B*H, S)`` fp32 (the reference kernel's
    residual layout)."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    block_idx, buckets = _batched(block_idx, buckets, B)
    nq, mb = block_idx.shape[1:]
    bq = S // nq
    bk = buckets.shape[-1] if buckets is not None else bq
    nk = S // bk
    scale = Dh ** -0.5
    dev = q.device

    bb, ii, mm = torch.nonzero(block_idx >= 0, as_tuple=True)
    jj = block_idx[bb, ii, mm].long()
    A = bb.numel()
    qa = q.float().view(B, nq, bq, KV, G, Dh)[bb, ii]      # (A,bq,KV,G,Dh)
    ka = k.float().view(B, nk, bk, KV, Dh)[bb, jj]         # (A,bk,KV,Dh)
    va = v.float().view(B, nk, bk, KV, Dh)[bb, jj]
    s = torch.einsum("aqkgd,ackd->akgqc", qa, ka) * scale
    s = s.reshape(A, H, bq, bk)
    valid = None
    if buckets is not None:
        bkt = buckets[bb, ii, mm].long()                    # (A,bq,bk)
        valid = (bkt >= 0)[:, None]
        if bias_table is not None:
            nb = bias_table.shape[1]
            bias = bias_table.float()[:, bkt.clamp(0, nb - 1)]  # (H,A,bq,bk)
            s = s + bias.permute(1, 0, 2, 3)
    if causal:
        qpos = ii[:, None] * bq + torch.arange(bq, device=dev)
        kpos = jj[:, None] * bk + torch.arange(bk, device=dev)
        cm = (qpos[:, :, None] >= kpos[:, None, :])[:, None]
        valid = cm if valid is None else valid & cm
    if valid is not None:
        s = s.masked_fill(~valid, NEG_INF)

    # row statistics over every block the row visits
    row = bb * nq + ii                                      # (A,)
    bmax = s.amax(-1)                                       # (A,H,bq)
    m = torch.full((B * nq, H, bq), NEG_INF, device=dev)
    m.scatter_reduce_(0, row[:, None, None].expand_as(bmax), bmax, "amax")
    dead = torch.isneginf(m)
    m = m.masked_fill(dead, 0.0)
    p = torch.exp(s - m[row][..., None])                    # masked -> 0
    l = torch.zeros((B * nq, H, bq), device=dev)
    l.index_add_(0, row, p.sum(-1))
    pv = torch.einsum("akgqc,ackd->aqkgd",
                      p.view(A, KV, G, bq, bk), va).reshape(A, bq, H, Dh)
    acc = torch.zeros((B * nq, bq, H, Dh), device=dev)
    acc.index_add_(0, row, pv)
    out = acc / l.clamp_min(1e-30).permute(0, 2, 1)[..., None]
    out = out.view(B, S, H, Dh).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.zeros((), device=dev))
    lse = lse.view(B, nq, H, bq).permute(0, 2, 1, 3).reshape(B * H, S)
    return out, lse
