"""Sharded cluster-sparse attention: Cluster-aware Graph Parallelism
(paper §III-C) composed with the cluster-sparse kernels (§III-B/D), the
port of ``repro.parallel.cluster_parallel`` on ``torch.distributed``.

The cluster-reordered graph sequence is sharded over the model group
between layers (each rank holds S/P contiguous graph tokens). Inside
attention an all-to-all turns a rank's shard into the full sequence for
H/P heads, so the topology-induced block pattern applies unchanged: the
same ``block_idx``, ``buckets`` and ``block_idx_t`` drive each rank's
kernel call. A second all-to-all restores sequence sharding. A rank
moves O(S/P) bytes a tensor, while the sparse pattern keeps compute at
O(active blocks).

The attention body is the kernel dispatch layer,
``kernels/ops.cluster_attention``: on CUDA tensors the hand-written
kernels (and their backward kernels under autograd), on CPU tensors the
plain versions, ``impl="plain"`` for the plain versions anywhere.

``bias_table`` (H, n_buckets) is sharded by head: after the all-to-all,
rank i holds head chunk i, which is row chunk i of the table, so rank i
passes its (H/P, n_buckets) rows to the kernel. A whole table read by
H/P local heads would silently use head 0's rows. The rows' gradient
lands in this rank's slice; summed over the model group it is the whole
table's.

The reference audits the compiled program's collectives against
:func:`cluster_a2a_budget` (``REPRO_IR_AUDIT``, JAX only). The port
counts the bytes each call hands to its all-to-alls (``LAST_CALL``,
from ``collectives.BYTES``), which the tests hold to the budget.
"""

from __future__ import annotations

import math

from repro_torch.kernels import ops as kops
from repro_torch.parallel import collectives as C
from repro_torch.parallel.ulysses import (can_ulysses, head_to_seq_a2a,
                                          seq_to_head_a2a)

# the all-to-all bytes of this process's last sharded forward (the q, k,
# v and o all-to-alls), in the budget's unit
LAST_CALL = {"a2a_bytes": 0}


def cluster_a2a_budget(q_shape, k_shape, dtype_bytes: int, p: int,
                       *, slack: float = 2.0):
    """O(S/P) all-to-all budget for one sharded attention call, in
    per-device payload bytes. The path moves q, k, v in and o out through
    all-to-alls of sequence-sharded tensors, each a rank's local 1/p
    slice: (bytes(q) + bytes(k) + bytes(v) + bytes(o)) / p, global shapes.
    ``slack`` absorbs operand splitting; an all-gather of the sequence
    costs p times this."""
    qb = math.prod(q_shape) * dtype_bytes
    kb = math.prod(k_shape) * dtype_bytes
    ideal = (2 * qb + 2 * kb) / p       # q + o, k + v
    return int(slack * ideal)


def can_shard_cluster(n_heads: int, n_kv: int, seq: int, p: int,
                      bq: int, bk: int) -> bool:
    """True iff the cluster-sparse path can run sequence-sharded p ways:
    Ulysses head and sequence divisibility plus whole blocks over the
    full sequence (every rank holds the whole sequence after the
    all-to-all, so only S itself must tile)."""
    if not can_ulysses(n_heads, n_kv, seq, p):
        return False
    return seq % bq == 0 and seq % bk == 0


def sharded_cluster_attention(q, k, v, block_idx, buckets=None,
                              bias_table=None, block_idx_t=None, *,
                              group, bq: int, bk: int,
                              causal: bool = False, impl: str | None = None):
    """q (B, S/P, H, Dh), k/v (B, S/P, KV, Dh): this rank's sequence shard
    of the global (B, S, ...) tensors. block_idx (B|-, nq, mb) int32;
    buckets (B, nq, mb, bq, bk) int8 or None; bias_table (H, n_buckets),
    the whole table, or None; block_idx_t the transposed pattern for the
    dK/dV kernel, or None: all for the full sequence, the same on every
    rank. Returns this rank's (B, S/P, H, Dh) shard. Differentiable in
    q, k, v and ``bias_table``.

    Raises ValueError when the shapes cannot shard over the group (see
    :func:`can_shard_cluster`)."""
    p = C.size(group)
    B, Sl, H, Dh = q.shape
    KV = k.shape[2]
    S = Sl * p
    if not can_shard_cluster(H, KV, S, p, bq, bk):
        raise ValueError(
            f"cluster attention cannot shard: H={H} KV={KV} S={S} "
            f"bq={bq} bk={bk} over a {p}-way model group")
    r = max(1, -(-p // KV))
    before = C.BYTES["all_to_all"]
    qh, kh, vh = seq_to_head_a2a(q, k, v, group=group, r=r)
    table = None
    if bias_table is not None:
        hl = H // p
        i = C.rank(group)
        table = bias_table[i * hl:(i + 1) * hl]
    oh = kops.cluster_attention(qh, kh, vh, block_idx, buckets, table,
                                block_idx_t, causal=causal, impl=impl)
    out = head_to_seq_a2a(oh, group=group)
    LAST_CALL["a2a_bytes"] = C.BYTES["all_to_all"] - before
    return out
