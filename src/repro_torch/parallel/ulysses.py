"""Ulysses-style all-to-all sequence parallelism, the runtime half of the
paper's Cluster-aware Graph Parallelism (§III-C): the port of
``repro.parallel.ulysses`` on ``torch.distributed``.

The sequence (graph-token) dimension is sharded over the mesh's
``"model"`` group between layers: each rank holds S/P contiguous tokens.
Inside attention an all-to-all gathers the sequence and splits the heads,
so each rank sees the *full* (cluster-reordered) sequence for H/P heads,
the layout the topology-induced sparse pattern needs; a second all-to-all
restores sequence sharding. A rank moves O(S/P) bytes a tensor (4·S·d/P a
layer), against O(S) for all-gather schemes.

Where the reference runs ``shard_map`` over global arrays, the port runs
one process per rank (SPMD): every function here takes the rank's local
shards and the model group, and returns local shards.

GQA: when kv_heads < P, the kv heads are repeated ``r = ceil(P / KV)``
times before the all-to-all (DeepSpeed-Ulysses), which keeps each q-head
chunk with its kv heads.
"""

from __future__ import annotations

from repro_torch.parallel import collectives as C


def _fit_dp(dp_axes, mesh_shape: dict, batch: int):
    """Keep only the data-parallel axes that divide the batch dim (B=1
    graph batches shard nowhere). ``mesh_shape``: axis name -> size."""
    out = []
    prod = 1
    for a in dp_axes:
        if a in mesh_shape and batch % (prod * mesh_shape[a]) == 0:
            out.append(a)
            prod *= mesh_shape[a]
    return tuple(out)


def can_ulysses(n_heads: int, n_kv: int, seq: int, p: int) -> bool:
    if p <= 1 or n_heads % p or seq % p:
        return False
    r = max(1, -(-p // n_kv))
    kvr = n_kv * r
    if kvr % p:
        return False
    hp, kvp = n_heads // p, kvr // p
    return hp % max(kvp, 1) == 0


def _seq_to_head(x, group):
    """(B, S/P, H, Dh) -> (B, S, H/P, Dh): rank ``j`` receives head chunk
    ``j`` of every rank's sequence shard, in rank order."""
    p = C.size(group)
    B, Sl, H, Dh = x.shape
    parts = x.reshape(B, Sl, p, H // p, Dh).movedim(2, 0)
    got = C.AllToAll.apply(parts, group)           # (P, B, S/P, H/P, Dh)
    return got.movedim(0, 1).reshape(B, p * Sl, H // p, Dh)


def head_to_seq_a2a(o, *, group):
    """The inverse half: (B, S, H/P, Dh) -> (B, S/P, H, Dh)."""
    p = C.size(group)
    B, S, Hl, Dh = o.shape
    parts = o.reshape(B, p, S // p, Hl, Dh).movedim(1, 0)
    got = C.AllToAll.apply(parts, group)           # (P, B, S/P, H/P, Dh)
    return got.movedim(0, 2).reshape(B, S // p, p * Hl, Dh)


def seq_to_head_a2a(q, k, v, *, group, r: int = 1):
    """The rank-local half of the Ulysses sandwich: repeat the kv heads
    ``r`` times (GQA), then all-to-all (B, S/P, H, Dh) -> (B, S, H/P, Dh)
    each of q, k and v. Differentiable: the backward is the inverse
    all-to-all."""
    if r > 1:
        k = k.repeat_interleave(r, dim=2)
        v = v.repeat_interleave(r, dim=2)
    return _seq_to_head(q, group), _seq_to_head(k, group), \
        _seq_to_head(v, group)


def ulysses_attention(q, k, v, *, group, attn_fn):
    """q (B, S/P, H, Dh), k/v (B, S/P, KV, Dh): this rank's sequence shard.
    ``attn_fn(q, k, v)`` runs on the full-sequence, head-sharded tensors.
    Returns this rank's (B, S/P, H, Dh) shard of the output."""
    p = C.size(group)
    r = max(1, -(-p // k.shape[2]))
    qh, kh, vh = seq_to_head_a2a(q, k, v, group=group, r=r)
    return head_to_seq_a2a(attn_fn(qh, kh, vh), group=group)


def seqpar_attention(q, k, v, *, group, attn_fn):
    """Sequence-parallel attention for archs whose head counts cannot split
    over the group (e.g. SmolLM's 9 heads two ways): q stays this rank's
    shard; k and v are all-gathered along the sequence once a layer (the
    gather's backward is a reduce-scatter of their gradients), and the
    rank computes its S/P x S slice. ``attn_fn(q_loc, k_full, v_full,
    q_offset)`` must honor the q offset (the global position of q's
    first row) for causal masking."""
    kf = C.GatherSeq.apply(k, group)
    vf = C.GatherSeq.apply(v, group)
    return attn_fn(q, kf, vf, C.rank(group) * q.shape[1])
