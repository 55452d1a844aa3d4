"""Dual-interleaved Attention (paper §III-B): the interleave schedule and
the dense step's structural bias — the port of ``use_dense_step``,
``dense_buckets_from_layout``, ``dense_bias_from_buckets`` and
``dense_bias_from_layout`` in ``repro.core.dual_attention``.

Sparse steps attend over the cluster-sparse layout (``kernels/ops.py``).
Every ``period`` steps, or always when the sparse pattern failed the
C1-C3 conditions, a dense step attends over all positions, biased where
the sparse pattern defines structure and unbiased elsewhere. The dense
bias's gradient is a sum by bucket (:func:`bucket_sums`), as is the
sparse op's in its plain backward (``kernels/ref.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def use_dense_step(step: int, period: int, conditions_ok: bool) -> bool:
    """Host-side schedule: dense every ``period`` steps; always dense if
    the sparse pattern failed the universality conditions (C1-C3)."""
    if not conditions_ok:
        return True
    if period <= 0:
        return False
    return step % period == 0


def bucket_sums(x, buckets, nb: int):
    """``(H, nb)`` fp32 sums of ``x`` ``(N, H, *r)`` by ``buckets``
    ``(N, *r)``: column ``j`` sums the entries whose bucket is ``j``, the
    last column also those above it (the kernels clip buckets to
    ``nb - 1``); entries with a negative bucket count nowhere. One
    reduction over ``x`` per bucket, deterministic, and no scatter of
    millions of values onto ``nb`` slots."""
    N, H = x.shape[:2]
    xf = x.reshape(N, H, -1).float()
    bf = buckets.reshape(N, -1)
    cols = [torch.einsum("nhr,nr->h", xf,
                         ((bf == j) if j < nb - 1 else (bf >= j)).float())
            for j in range(nb)]
    return torch.stack(cols, dim=1)


def dense_buckets_from_layout(layout) -> np.ndarray:
    """``(S, S)`` int8 bucket matrix scattered from the block layout (-1
    where the sparse pattern has no entry). Host-side numpy, equal byte
    for byte to the reference's."""
    S = layout.seq_len
    out = np.full((S, S), -1, np.int8)
    if layout.buckets is None:
        return out
    bq, bk = layout.bq, layout.bk
    ii, mm = np.nonzero(layout.block_idx >= 0)
    jj = layout.block_idx[ii, mm]
    # (q-block, k-block, row, col) view of the matrix; layouts list each
    # k-block at most once per row, so no write lands twice
    out.reshape(S // bq, bq, S // bk, bk).transpose(0, 2, 1, 3)[ii, jj] = \
        layout.buckets[ii, mm]
    return out


class _BucketGather(torch.autograd.Function):
    """``bias_table[h, bucket]`` where ``bucket >= 0``, 0 elsewhere. The
    backward sums the incoming ``(B, H, S, S)`` gradient per bucket
    (:func:`bucket_sums`): autograd's own backward of the gather
    scatters S*S values per head onto a handful of table entries, which
    serialises on the card."""

    @staticmethod
    def forward(ctx, table, buckets):
        vals = table.float()[:, buckets.clamp_min(0).long()].movedim(0, 1)
        ctx.save_for_backward(buckets)
        ctx.table_dtype, ctx.nb = table.dtype, table.shape[1]
        # in place: this fresh tensor is not needed by the backward
        return vals.masked_fill_((buckets < 0)[:, None], 0.0)

    @staticmethod
    def backward(ctx, grad):
        buckets, = ctx.saved_tensors
        return bucket_sums(grad, buckets, ctx.nb).to(ctx.table_dtype), None


def dense_bias_from_buckets(dense_buckets, bias_table, n_heads: int):
    """``(S, S)`` or ``(B, S, S)`` int8 bucket tensor -> ``(B, H, S, S)``
    fp32 additive bias for the dense step: ``bias_table[h, bucket]`` where
    the sparse pattern defines a bucket, 0 elsewhere (fully connected).
    Differentiable in ``bias_table``."""
    bk = dense_buckets if dense_buckets.dim() == 3 else dense_buckets[None]
    if bias_table is None:
        return torch.zeros((bk.shape[0], n_heads) + tuple(bk.shape[1:]),
                           dtype=torch.float32, device=bk.device)
    return _BucketGather.apply(bias_table, bk)


def dense_bias_from_layout(layout, bias_table, n_heads: int):
    """``(1, H, S, S)`` fp32 additive bias from a host-side
    ``ClusterLayout``: its bucket matrix (:func:`dense_buckets_from_layout`)
    built on the host and uploaded to the table's device, then gathered
    from ``bias_table`` (:func:`dense_bias_from_buckets`). Zeros (on the
    table's device, else the CPU) when the table or the layout's buckets
    are absent. A caller that biases many steps with one layout builds
    and uploads the bucket matrix once and calls
    :func:`dense_bias_from_buckets` each step."""
    device = "cpu" if bias_table is None else bias_table.device
    S = layout.seq_len
    if bias_table is None or layout.buckets is None:
        return torch.zeros((1, n_heads, S, S), dtype=torch.float32,
                           device=device)
    bk = torch.from_numpy(dense_buckets_from_layout(layout)).to(device)
    return dense_bias_from_buckets(bk, bias_table, n_heads)
