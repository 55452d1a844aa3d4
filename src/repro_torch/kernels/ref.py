"""Plain PyTorch versions of the kernelled ops: the cluster-sparse
attention op and its backward, the dense flash attention forward and
backward (:func:`flash_fwd`, :func:`flash_bwd`) and the SSD scan
(:func:`ssd_ref`); and the serving path's paged attention
(:func:`paged_attention`), which has no kernel in either package.

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
with ``block_idx >= 0`` is gathered once, so time scales with the number
of visited blocks, not with ``nq * mb``. That matters because the global
token's q-block visits almost every k-block while the other rows visit a
handful, which makes ``mb`` (the padded row width) far larger than the
mean row. The active blocks are processed in chunks of at most
``MAX_CHUNK_ENTRIES`` score entries, so memory stays bounded however many
blocks a layout visits (a nearly dense layout of the 8192-node training
graph visits 64729).

The backward (:func:`cluster_attention_bwd`) recomputes the scores of
every visited block from q, k and the forward's logsumexp, as the CUDA
kernels do: dQ and the ``bias_table`` gradient over the forward layout,
dK and dV over the transposed one. Without buckets it is the unbiased
op's backward (the LM path), the positional causal mask included.

The forward and the backward take the schedule of the reference's
cluster kernels and oracle (``repro_torch.tune.schedule``):

* ``hoist_scale`` multiplies the fp32 q tile by ``Dh**-0.5`` before the
  product instead of every score after it (the backward rebuilds the
  scores the same way; its dK still contracts the unscaled q);
* ``fuse_bias`` looks the bias up in :func:`extend_bias_table`'s operand,
  whose trailing ``NEG_SENTINEL`` column the masked bucket -1 wraps onto,
  instead of clipping the bucket and masking with a select. The two
  agree on buckets in ``{-1} U [0, n_buckets)``, all that
  ``core/reformation.py`` emits; the bias gradient keeps the table's
  width;
* ``row_chunk`` cuts the work at q-block row chunks of the largest
  divisor of ``nq`` not above it (the reference oracle's rule): a pass
  takes whole row chunks, as many as fit under ``MAX_CHUNK_ENTRIES``,
  and a chunk above that bound is cut by it.
"""

from __future__ import annotations

import torch

from repro_torch.core.dual_attention import bucket_sums
from repro_torch.models.layers import (attention_mask, chunked_attention,
                                       masked_attention)
from repro_torch.models.ssm import ssd_chunked

NEG_INF = float("-inf")
# the reference kernels' finite mask value (``repro.kernels.policy``'s
# NEG_INF): the fused bias table's sentinel column
NEG_SENTINEL = -1e30
# fp32 score entries (blocks x heads x bq x bk) computed at once
MAX_CHUNK_ENTRIES = 1 << 26


def _chunks(n: int, per_block: int):
    """Slices of ``range(n)`` active blocks, each within the chunk bound."""
    step = max(1, MAX_CHUNK_ENTRIES // per_block)
    return [slice(a, min(a + step, n)) for a in range(0, n, step)]


def row_chunk_rows(nq: int, row_chunk: int) -> int:
    """The q-block rows of one ``row_chunk``: the largest divisor of
    ``nq`` not above it (the reference oracle's rule)."""
    rc = min(row_chunk, nq)
    while nq % rc:
        rc -= 1
    return rc


def _passes(rows, nq: int, row_chunk, per_block: int):
    """The passes over the active blocks whose flattened q-block rows
    (``b * nq + qi``) are ``rows``: ``(order, slices)``, the blocks to take
    in ``order`` (None: as they are) and cut at ``slices``. Without
    ``row_chunk`` the cuts fall at the entry bound alone; with it a pass
    takes whole chunks of :func:`row_chunk_rows` rows, as many as fit
    under the bound, and a chunk above the bound is cut by it."""
    if row_chunk is None:
        return None, _chunks(rows.numel(), per_block)
    key = rows // row_chunk_rows(nq, row_chunk)
    order = torch.argsort(key, stable=True)
    counts = torch.unique_consecutive(key[order],
                                      return_counts=True)[1].tolist()
    step = max(1, MAX_CHUNK_ENTRIES // per_block)
    out, a, start = [], 0, 0
    for n in counts:
        if a + n - start > step and a > start:
            out.append(slice(start, a))
            start = a
        a += n
        while a - start > step:
            out.append(slice(start, start + step))
            start += step
    if a > start:
        out.append(slice(start, a))
    return order, out


def _take(order, *xs):
    return xs if order is None else tuple(x[order] for x in xs)


def extend_bias_table(bias_table):
    """The ``fuse_bias`` rewrite's bias operand: the ``(H, n_buckets)``
    table in fp32 with one trailing ``NEG_SENTINEL`` column, onto which
    the masked bucket -1 wraps (the reference's ``extend_bias_table``).
    ``s + NEG_SENTINEL`` is ``NEG_SENTINEL`` in fp32 for every finite
    score the op produces."""
    bt = bias_table.float()
    return torch.cat([bt, bt.new_full((bt.shape[0], 1), NEG_SENTINEL)],
                     dim=1)


def _biased(s, bkt, bias_table, fuse_bias):
    """Scores ``s`` ``(A, H, bq, bk)`` plus the bias of buckets ``bkt``
    ``(A, bq, bk)``, masked where the bucket is negative: the sentinel
    column under ``fuse_bias`` (the bucket wraps onto it), else the
    bucket clipped to the table and ``NEG_INF`` by a select."""
    if fuse_bias:
        ext = extend_bias_table(bias_table)
        return s + ext[:, bkt.remainder(ext.shape[1])].permute(1, 0, 2, 3)
    nb = bias_table.shape[1]
    s = s + bias_table.float()[:, bkt.clamp(0, nb - 1)].permute(1, 0, 2, 3)
    return s.masked_fill((bkt < 0)[:, None], NEG_INF)


def _qk(qa, ka, scale, hoist_scale, eq):
    """The scaled dot products ``einsum(eq, qa, ka)``: q times ``scale``
    first under ``hoist_scale``, else the products times it."""
    if hoist_scale:
        return torch.einsum(eq, qa * scale, ka)
    return torch.einsum(eq, qa, ka) * scale


def _causal_keep(ii, jj, bq: int, bk: int):
    """``(A, bq, bk)`` bool: True where the q position of q-block ``ii``
    is at or after the k position of k-block ``jj`` (the positional
    causal mask, ``qpos >= kpos``)."""
    qpos = ii[:, None] * bq + torch.arange(bq, device=ii.device)
    kpos = jj[:, None] * bk + torch.arange(bk, device=jj.device)
    return qpos[:, :, None] >= kpos[:, None, :]


def _batched(block_idx, buckets, B):
    if block_idx.dim() == 2:
        block_idx = block_idx.unsqueeze(0).expand(B, -1, -1)
        if buckets is not None:
            buckets = buckets.unsqueeze(0).expand(B, -1, -1, -1, -1)
    return block_idx, buckets


def cluster_sparse_attention(q, k, v, block_idx, buckets=None,
                             bias_table=None, *, causal: bool = False,
                             return_lse: bool = False,
                             hoist_scale: bool = False,
                             fuse_bias: bool = False, row_chunk=None):
    """Returns O ``(B, S, H, Dh)`` in q's dtype and, with ``return_lse``,
    the per-row logsumexp ``(B*H, S)`` fp32 (the reference kernel's
    residual layout). ``hoist_scale``, ``fuse_bias`` and ``row_chunk``
    are the schedule's (module docstring); ``fuse_bias`` needs buckets
    and a table."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    block_idx, buckets = _batched(block_idx, buckets, B)
    nq = block_idx.shape[1]
    bq = S // nq
    bk = buckets.shape[-1] if buckets is not None else bq
    nk = S // bk
    scale = Dh ** -0.5
    dev = q.device

    bb, ii, mm = torch.nonzero(block_idx >= 0, as_tuple=True)
    order, chunks = _passes(bb * nq + ii, nq, row_chunk, H * bq * bk)
    bb, ii, mm = _take(order, bb, ii, mm)
    jj = block_idx[bb, ii, mm].long()
    row = bb * nq + ii                                      # (A,)
    qv = q.reshape(B, nq, bq, KV, G, Dh)
    kv_, vv = k.reshape(B, nk, bk, KV, Dh), v.reshape(B, nk, bk, KV, Dh)

    def scores(c):
        """Masked, biased scores ``(a, H, bq, bk)`` of the chunk ``c``."""
        b_, i_, j_ = bb[c], ii[c], jj[c]
        a = b_.numel()
        qa = qv[b_, i_].float()                             # (a,bq,KV,G,Dh)
        ka = kv_[b_, j_].float()                            # (a,bk,KV,Dh)
        s = _qk(qa, ka, scale, hoist_scale, "aqkgd,ackd->akgqc")
        s = s.reshape(a, H, bq, bk)
        if buckets is not None:
            bkt = buckets[b_, i_, mm[c]].long()             # (a,bq,bk)
            if bias_table is not None:
                s = _biased(s, bkt, bias_table, fuse_bias)
            else:
                s = s.masked_fill((bkt < 0)[:, None], NEG_INF)
        if causal:
            s = s.masked_fill(~_causal_keep(i_, j_, bq, bk)[:, None],
                              NEG_INF)
        return s

    # pass 1: row maxima over every block the row visits. The max only
    # shifts the softmax (its gradient cancels), so it carries none
    m = torch.full((B * nq, H, bq), NEG_INF, device=dev)
    with torch.no_grad():
        for c in chunks:
            bmax = scores(c).amax(-1)                       # (a,H,bq)
            m.scatter_reduce_(0, row[c, None, None].expand_as(bmax), bmax,
                              "amax")
    # a row with nothing unmasked: NEG_INF, or the fused sentinel
    dead = m <= NEG_SENTINEL
    m = m.masked_fill(dead, 0.0)
    # pass 2: the scores again, their exponentials, the PV products
    l = torch.zeros((B * nq, H, bq), device=dev)
    acc = torch.zeros((B * nq, bq, H, Dh), device=dev)
    for c in chunks:
        s = scores(c)
        a = s.shape[0]
        p = torch.exp(s - m[row[c]][..., None])             # masked -> 0
        l.index_add_(0, row[c], p.sum(-1))
        va = vv[bb[c], jj[c]].float()
        pv = torch.einsum("akgqc,ackd->aqkgd",
                          p.view(a, KV, G, bq, bk), va).reshape(a, bq, H, Dh)
        acc.index_add_(0, row[c], pv)
    out = acc / l.clamp_min(1e-30).permute(0, 2, 1)[..., None]
    out = out.view(B, S, H, Dh).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.zeros((), device=dev))
    lse = lse.view(B, nq, H, bq).permute(0, 2, 1, 3).reshape(B * H, S)
    return out, lse


def split_partials(q, k, v, block_idx, buckets, bias_table, pieces):
    """The partial slots the bf16 forward's split grid writes
    (``cluster_attention.split_plan``), in plain fp32: for each piece
    ``(b * nq + qi, v0, v1, slot >= 0)`` the base-2 scores of the row's
    visits v0..v1-1 (its non -1 slots in order), their max m (the
    sentinel -1e30 where nothing is unmasked), the sum l of p = exp2(s -
    m) and the unnormalized O = p V. Returns ``part_o`` (slots, H, bq,
    Dh) and ``part_ml`` (slots, H, 2, bq): m, then l."""
    B, S, H, Dh = q.shape
    nq = block_idx.shape[-2]
    bq, bk, nb = S // nq, buckets.shape[-1], bias_table.shape[1]
    rep = H // k.shape[2]
    bi, bu = _batched(block_idx, buckets, B)
    own = [p for p in pieces.tolist() if p[3] >= 0]
    slots = max((p[3] for p in own), default=-1) + 1
    part_o = torch.zeros((slots, H, bq, Dh), dtype=torch.float32)
    part_ml = torch.zeros((slots, H, 2, bq), dtype=torch.float32)
    log2e = 1.4426950408889634
    for row, v0, v1, slot in own:
        b, qi = divmod(row, nq)
        ms = torch.nonzero(bi[b, qi] >= 0).flatten()[v0:v1]
        kpos = (bi[b, qi, ms].long()[:, None] * bk
                + torch.arange(bk)).flatten()
        qs = q[b, qi * bq:(qi + 1) * bq].float()
        ks = k[b, kpos].float().repeat_interleave(rep, dim=1)
        vs = v[b, kpos].float().repeat_interleave(rep, dim=1)
        bkt = bu[b, qi, ms].long().permute(1, 0, 2).reshape(bq, -1)
        s = torch.einsum("qhd,khd->hqk", qs, ks) * Dh ** -0.5 \
            + bias_table.float()[:, bkt.clamp(0, nb - 1)]
        s = torch.where(bkt >= 0, s * log2e, torch.tensor(-1e30))
        m = s.amax(-1).clamp_min(-1e30)
        p = torch.where((m <= -1e30)[..., None], torch.zeros(()),
                        torch.exp2(s - m[..., None]))
        part_o[slot] = torch.einsum("hqk,khd->hqd", p, vs)
        part_ml[slot, :, 0] = m
        part_ml[slot, :, 1] = p.sum(-1)
    return part_o, part_ml


def cluster_sparse_attention_split(q, k, v, block_idx, buckets, bias_table,
                                   pieces, splits):
    """The bf16 forward's split grid in plain PyTorch, in fp32: whole rows
    as ``cluster_sparse_attention`` computes them; each split row
    ``(b * nq + qi, first slot, n, 0)`` merged from its pieces'
    ``split_partials`` in slot order, as the combine kernel merges them
    (O = sum_p O_p 2^(m_p - M) / max(L, 1e-30), L = sum_p l_p 2^(m_p -
    M), M the largest m_p; lse = (M + log2 L) ln 2, or 0 where L = 0).
    Returns O ``(B, S, H, Dh)`` fp32 and lse ``(B*H, S)``."""
    B, S, H, Dh = q.shape
    nq = block_idx.shape[-2]
    bq = S // nq
    out, lse = cluster_sparse_attention(q.float(), k.float(), v.float(),
                                        block_idx, buckets, bias_table,
                                        return_lse=True)
    lse = lse.view(B, H, S)
    part_o, part_ml = split_partials(q, k, v, block_idx, buckets,
                                     bias_table, pieces)
    for row, first, n, _ in splits.tolist():
        b, qi = divmod(row, nq)
        m, l = part_ml[first:first + n, :, 0], part_ml[first:first + n, :, 1]
        mx = m.amax(0)
        w = torch.exp2(m - mx)
        tot = (l * w).sum(0)
        o = (part_o[first:first + n] * w[..., None]).sum(0) \
            / tot.clamp_min(1e-30)[..., None]
        out[b, qi * bq:(qi + 1) * bq] = o.permute(1, 0, 2)
        lse[b, :, qi * bq:(qi + 1) * bq] = torch.where(
            tot > 0, (mx + torch.log2(tot.clamp_min(1e-30)))
            * 0.6931471805599453, torch.zeros(()))
    return out, lse.reshape(B * H, S)


def derive_block_idx_t(block_idx, nk: int):
    """Transposed layout at the dense bound ``mt = nq``: ``(nq, mb) ->
    (nk, nq, 2)`` (or ``(B, nq, mb) -> (B, nk, nq, 2)``) int32, -1
    padded; each k-block row lists the (q-row, forward slot) pairs that
    visit it, q-rows ascending. The torch twin of the reference's
    ``derive_block_idx_t`` (``core/reformation.transpose_block_idx``
    builds the same pairs with a tighter ``mt`` on the host).

    Precondition: no q-row lists the same k-block twice
    (``core/reformation.py`` never emits duplicates)."""
    shared = block_idx.dim() == 2
    bi = (block_idx[None] if shared else block_idx).long()
    G, nq, mb = bi.shape
    dev = bi.device
    valid = bi >= 0
    cols = torch.where(valid, bi, nk)                # pads land in col nk
    slots = torch.where(valid, torch.arange(mb, device=dev), -1)
    slot_of = torch.full((G, nq, nk + 1), -1, dtype=torch.long, device=dev)
    slot_of.scatter_(2, cols, slots)
    slot_of = slot_of[..., :nk].transpose(1, 2)      # (G, nk, nq)
    has = slot_of >= 0
    key = torch.where(has, torch.arange(nq, device=dev), nq)
    order = torch.argsort(key, dim=-1, stable=True)  # visiting rows first
    qrow = torch.where(has.gather(-1, order), order, -1)
    slot = torch.where(qrow >= 0, slot_of.gather(-1, order), -1)
    out = torch.stack([qrow, slot], dim=-1).to(torch.int32)
    return out[0] if shared else out


def row_delta(dout, out):
    """``rowsum(dO * O)`` in fp32, in the lse layout ``(B*H, S)``."""
    B, S, H, _ = out.shape
    d = (dout.float() * out.float()).sum(-1)                # (B, S, H)
    return d.permute(0, 2, 1).reshape(B * H, S).contiguous()


def group_sum(x, KV: int):
    """Per-q-head ``(B, S, H, Dh)`` gradients -> the ``KV`` heads they
    share (GQA), summed in fp32."""
    B, S, H, Dh = x.shape
    if H == KV:
        return x
    return x.float().view(B, S, KV, H // KV, Dh).sum(3)


def _block_terms(q, k, v, dout, lse, delta, bb, ii, mm, jj, nq, bk,
                 buckets, bias_table, causal, hoist_scale=False,
                 fuse_bias=False):
    """Recomputed ``p`` and ``ds`` ``(A, H, bq, bk)`` of the active blocks
    ``(graph bb, q-row ii, slot mm, k-block jj)``, with the gathered
    fp32 q (unscaled under ``hoist_scale`` too), dO, k tiles and the
    blocks' bucket tiles (None without buckets). The scores are rebuilt
    as the forward built them, under the same schedule flags."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    bq = S // nq
    nk = S // bk
    A = bb.numel()
    qa = q.reshape(B, nq, bq, KV, G, Dh)[bb, ii].float()   # (A,bq,KV,G,Dh)
    doa = dout.reshape(B, nq, bq, KV, G, Dh)[bb, ii].float()
    ka = k.reshape(B, nk, bk, KV, Dh)[bb, jj].float()       # (A,bk,KV,Dh)
    va = v.reshape(B, nk, bk, KV, Dh)[bb, jj].float()
    s = _qk(qa, ka, Dh ** -0.5, hoist_scale,
            "aqkgd,ackd->akgqc").reshape(A, H, bq, bk)
    bkt = None
    if buckets is not None:
        bkt = buckets[bb, ii, mm].long()                    # (A,bq,bk)
        s = _biased(s, bkt, bias_table, fuse_bias)
    if causal:
        s = s.masked_fill(~_causal_keep(ii, jj, bq, bk)[:, None], NEG_INF)
    rows = (bb, slice(None), ii)
    p = torch.exp(s - lse.view(B, H, nq, bq)[rows][..., None])
    dp = torch.einsum("aqkgd,ackd->akgqc", doa, va).reshape(A, H, bq, bk)
    ds = p * (dp - delta.view(B, H, nq, bq)[rows][..., None])
    return p, ds, qa, doa, ka, bkt


def block_dims(q, block_idx, buckets):
    """``(nq, bq, bk)`` implied by the shapes: ``bq = S // nq``, ``bk``
    from the buckets, or ``bk = bq`` without them."""
    nq = block_idx.shape[-2]
    bq = q.shape[1] // nq
    return nq, bq, (buckets.shape[-1] if buckets is not None else bq)


def bwd_dq(q, k, v, dout, lse, delta, block_idx, buckets, bias_table, *,
           causal: bool = False, hoist_scale: bool = False,
           fuse_bias: bool = False, row_chunk=None):
    """dq ``(B, S, H, Dh)`` fp32 and the ``(H, n_buckets)`` fp32 bias
    gradient (None without buckets), over the forward layout: the dQ
    kernels' function, under the schedule's flags (module docstring)."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    nq, bq, bk = block_dims(q, block_idx, buckets)
    bi, bu = _batched(block_idx, buckets, B)
    bb, ii, mm = torch.nonzero(bi >= 0, as_tuple=True)
    order, chunks = _passes(bb * nq + ii, nq, row_chunk, H * bq * bk)
    bb, ii, mm = _take(order, bb, ii, mm)
    jj = bi[bb, ii, mm].long()
    dq = torch.zeros((B * nq, bq, H, Dh), device=q.device)
    dbias = None
    if bu is not None:
        nb = bias_table.shape[1]
        dbias = torch.zeros((H, nb), device=q.device)
    for c in chunks:
        _, ds, _, _, ka, bkt = _block_terms(
            q, k, v, dout, lse, delta, bb[c], ii[c], mm[c], jj[c], nq, bk,
            bu, bias_table, causal, hoist_scale, fuse_bias)
        a = ds.shape[0]
        dqa = torch.einsum("akgqc,ackd->aqkgd",
                           ds.view(a, KV, H // KV, bq, bk), ka)
        dq.index_add_(0, bb[c] * nq + ii[c],
                      dqa.reshape(a, bq, H, Dh) * Dh ** -0.5)
        if dbias is not None:
            dbias += bucket_sums(ds, bkt, nb)
    return dq.view(B, S, H, Dh), dbias


def dq_partials(q, k, v, dout, lse, delta, block_idx, buckets, bias_table,
                pieces):
    """The partial slots the bf16 dQ kernel's split grid writes
    (``cluster_attention.split_plan``), in plain fp32: for each piece
    ``(b * nq + qi, v0, v1, slot >= 0)`` the Dh^-0.5-scaled dq of the
    row's visits v0..v1-1 (its non -1 slots in order) and their bucket
    sums of ds. Returns ``part_dq`` (slots, H, bq, Dh) and ``part_db``
    (slots, H, n_buckets)."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    nq, bq, bk = block_dims(q, block_idx, buckets)
    nb = bias_table.shape[1]
    bi, bu = _batched(block_idx, buckets, B)
    own = [p for p in pieces.tolist() if p[3] >= 0]
    slots = max((p[3] for p in own), default=-1) + 1
    part_dq = torch.zeros((slots, H, bq, Dh), dtype=torch.float32)
    part_db = torch.zeros((slots, H, nb), dtype=torch.float32)
    for row, v0, v1, slot in own:
        b, qi = divmod(row, nq)
        mm = torch.nonzero(bi[b, qi] >= 0).flatten()[v0:v1]
        bb, ii = torch.full_like(mm, b), torch.full_like(mm, qi)
        _, ds, _, _, ka, bkt = _block_terms(
            q, k, v, dout, lse, delta, bb, ii, mm, bi[b, qi, mm].long(), nq,
            bk, bu, bias_table, False)
        dqa = torch.einsum("akgqc,ackd->aqkgd",
                           ds.view(-1, KV, H // KV, bq, bk), ka)
        part_dq[slot] = (dqa.sum(0).reshape(bq, H, Dh)
                         * Dh ** -0.5).permute(1, 0, 2)
        part_db[slot] = bucket_sums(ds, bkt, nb)
    return part_dq, part_db


def bwd_dq_split(q, k, v, dout, lse, delta, block_idx, buckets, bias_table,
                 pieces, splits):
    """The bf16 dQ kernel's split grid in plain PyTorch, in fp32: whole
    rows as :func:`bwd_dq` computes them; each split row ``(b * nq + qi,
    first slot, n, 0)`` summed from its pieces' :func:`dq_partials` in
    slot order, as the combine kernel sums them. Returns dq ``(B, S, H,
    Dh)`` and the ``(H, n_buckets)`` bias gradient."""
    B, S, H, Dh = q.shape
    nq, bq, _ = block_dims(q, block_idx, buckets)
    bi, bu = _batched(block_idx, buckets, B)
    whole = bi.clone()
    for row, *_ in splits.tolist():
        whole[row // nq, row % nq] = -1
    dq, dbias = bwd_dq(q, k, v, dout, lse, delta, whole, bu, bias_table)
    part_dq, part_db = dq_partials(q, k, v, dout, lse, delta, block_idx,
                                   buckets, bias_table, pieces)
    for row, first, n, _ in splits.tolist():
        b, qi = divmod(row, nq)
        acc, db = part_dq[first].clone(), part_db[first].clone()
        for p in range(first + 1, first + n):
            acc += part_dq[p]
            db += part_db[p]
        dq[b, qi * bq:(qi + 1) * bq] = acc.permute(1, 0, 2)
        dbias += db
    return dq, dbias


def bwd_dkv(q, k, v, dout, lse, delta, block_idx, block_idx_t, buckets,
            bias_table, *, causal: bool = False, hoist_scale: bool = False,
            fuse_bias: bool = False, row_chunk=None):
    """Per-q-head dk and dv ``(B, S, H, Dh)`` fp32 over the transposed
    layout: the dK/dV kernels' function, under the schedule's flags
    (module docstring; ``row_chunk`` groups the visits by their q-rows)."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    nq, bq, bk = block_dims(q, block_idx, buckets)
    nk = S // bk
    _, bu = _batched(block_idx, buckets, B)
    bit = block_idx_t if block_idx_t.dim() == 4 else \
        block_idx_t.unsqueeze(0).expand(B, -1, -1, -1)
    bb, jj, tt = torch.nonzero(bit[..., 0] >= 0, as_tuple=True)
    ii = bit[bb, jj, tt, 0].long()
    mm = bit[bb, jj, tt, 1].long()
    order, chunks = _passes(bb * nq + ii, nq, row_chunk, H * bq * bk)
    bb, jj, ii, mm = _take(order, bb, jj, ii, mm)
    dkh = torch.zeros((B * nk, bk, H, Dh), device=q.device)
    dvh = torch.zeros((B * nk, bk, H, Dh), device=q.device)
    for c in chunks:
        p, ds, qa, doa, _, _ = _block_terms(
            q, k, v, dout, lse, delta, bb[c], ii[c], mm[c], jj[c], nq, bk,
            bu, bias_table, causal, hoist_scale, fuse_bias)
        a = p.shape[0]
        dva = torch.einsum("akgqc,aqkgd->ackgd", p.view(a, KV, G, bq, bk),
                           doa)
        dka = torch.einsum("akgqc,aqkgd->ackgd", ds.view(a, KV, G, bq, bk),
                           qa)
        dst = bb[c] * nk + jj[c]
        dkh.index_add_(0, dst, dka.reshape(a, bk, H, Dh) * Dh ** -0.5)
        dvh.index_add_(0, dst, dva.reshape(a, bk, H, Dh))
    return dkh.view(B, S, H, Dh), dvh.view(B, S, H, Dh)


def cluster_attention_bwd(q, k, v, dout, out, lse, block_idx, buckets,
                          bias_table, block_idx_t=None, *,
                          causal: bool = False, hoist_scale: bool = False,
                          fuse_bias: bool = False, row_chunk=None):
    """Gradients ``(dq, dk, dv, dbias)`` of the op, in the dtypes of q, k,
    v and ``bias_table`` (``dbias`` is None without buckets; ``causal``
    masks positionally, as the unbiased forward). ``out`` and ``lse`` are
    the forward's output and logsumexp, computed under the same schedule
    flags; ``block_idx_t`` is the transposed layout the dK/dV pass walks
    (derived at the dense bound when omitted). Rows the forward found
    dead carry ``lse = 0``, so their ``p`` underflows to 0, as in the
    kernels."""
    KV = k.shape[2]
    delta = row_delta(dout, out)
    sched = dict(causal=causal, hoist_scale=hoist_scale,
                 fuse_bias=fuse_bias, row_chunk=row_chunk)
    dq, dbias = bwd_dq(q, k, v, dout, lse, delta, block_idx, buckets,
                       bias_table, **sched)
    if block_idx_t is None:
        block_idx_t = derive_block_idx_t(
            block_idx, q.shape[1] // block_dims(q, block_idx, buckets)[2])
    dkh, dvh = bwd_dkv(q, k, v, dout, lse, delta, block_idx, block_idx_t,
                       buckets, bias_table, **sched)
    return (dq.to(q.dtype), group_sum(dkh, KV).to(k.dtype),
            group_sum(dvh, KV).to(v.dtype),
            None if dbias is None else dbias.to(bias_table.dtype))


# ------------------------------------------------------------------ flash

def flash_attention_ref(q, k, v, *, causal: bool = True):
    """The reference's oracle of the flash kernels
    (``repro.kernels.ref.flash_attention_ref``): ``chunked_attention`` at
    chunks of ``max(16, S // 4)``, differentiable by autograd."""
    return chunked_attention(q, k, v, causal=causal,
                             chunk_q=max(16, q.shape[1] // 4),
                             chunk_k=max(16, k.shape[1] // 4))


def _k_end(Sk: int, q1: int, causal: bool) -> int:
    """Keys a q-block ending before ``q1`` can see: the causal mask hides
    every key at or past ``q1``."""
    return min(Sk, q1) if causal else Sk


def _flash_scores(qs, kf, q0, k0, causal, scale):
    """fp32 scores ``(B, KV, G, cq, ck)`` of a q tile ``qs`` ``(B, cq, KV,
    G, Dh)`` (pre-scaled when ``scale`` is None) against a k tile ``kf``
    ``(B, ck, KV, Dh)``, -inf where ``qpos < kpos`` when causal."""
    s = torch.einsum("bqkgd,bckd->bkgqc", qs, kf)
    if scale is not None:
        s = s * scale
    cq, ck = s.shape[-2:]
    if causal and k0 + ck - 1 > q0:
        qpos = q0 + torch.arange(cq, device=s.device)
        kpos = k0 + torch.arange(ck, device=s.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    return s


def flash_fwd(q, k, v, *, causal: bool = True, block_q: int, block_k: int,
              hoist_scale: bool = False, return_lse: bool = False):
    """Dense attention forward, the plain version of the flash forward
    kernel: q ``(B, Sq, H, Dh)``, k/v ``(B, Sk, KV, Dh)`` (GQA: head ``h``
    reads KV head ``h // (H // KV)``). It follows the kernel's arithmetic:
    fp32 scores ``(q . k) * Dh**-0.5`` (``(q * Dh**-0.5) . k`` with
    ``hoist_scale``), an online softmax over k-blocks of ``block_k`` for
    each q-block of ``block_q``, the probabilities fp32 through the PV
    product. Returns O in q's dtype and, with ``return_lse``, the
    logsumexp ``(B*H, Sq)`` fp32 (0 on rows with no unmasked key)."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = Dh ** -0.5
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    lse = torch.zeros((B, KV, G, Sq), device=q.device)
    for q0 in range(0, Sq, block_q):
        q1 = min(q0 + block_q, Sq)
        qs = q[:, q0:q1].float().view(B, q1 - q0, KV, G, Dh)
        if hoist_scale:
            qs = qs * scale
        m = torch.full((B, KV, G, q1 - q0), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, q1 - q0), device=q.device)
        acc = torch.zeros((B, KV, G, q1 - q0, Dh), device=q.device)
        for k0 in range(0, _k_end(Sk, q1, causal), block_k):
            k1 = min(k0 + block_k, _k_end(Sk, q1, causal))
            s = _flash_scores(qs, kf[:, k0:k1], q0, k0, causal,
                              None if hoist_scale else scale)
            m_new = torch.maximum(m, s.amax(-1))
            # dead rows (all -inf so far) shift by 0: p and corr come out 0
            m_safe = m_new.masked_fill(torch.isneginf(m_new), 0.0)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(m - m_safe)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", p, vf[:, k0:k1])
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None]
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).reshape(
            B, q1 - q0, H, Dh).to(q.dtype)
        lse[..., q0:q1] = torch.where(
            l > 0, m.masked_fill(torch.isneginf(m), 0.0)
            + torch.log(l.clamp_min(1e-30)), torch.zeros((), device=q.device))
    lse = lse.reshape(B * H, Sq)
    return (out, lse) if return_lse else out


def _flash_bwd_tiles(q, k, v, dout, lse, delta, causal, block_q, block_k,
                     hoist_scale):
    """Every (q-block, k-block) tile with an unmasked entry, as the
    backward kernels rebuild it: yields ``(q0, q1, k0, k1, qf, dof, kf,
    p, ds)`` with fp32 ``(B, c, KV, G, Dh)`` q and dO tiles, the fp32
    ``(B, c, KV, Dh)`` k tile, and ``p = exp(s - lse)``, ``ds = p * (dO .
    v - delta)`` ``(B, KV, G, cq, ck)``."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = Dh ** -0.5
    kf, vf = k.float(), v.float()
    lse_v = lse.view(B, KV, G, Sq)
    dl = delta.view(B, KV, G, Sq)
    for q0 in range(0, Sq, block_q):
        q1 = min(q0 + block_q, Sq)
        qf = q[:, q0:q1].float().view(B, q1 - q0, KV, G, Dh)
        qs = qf * scale if hoist_scale else qf
        dof = dout[:, q0:q1].float().view(B, q1 - q0, KV, G, Dh)
        for k0 in range(0, _k_end(Sk, q1, causal), block_k):
            k1 = min(k0 + block_k, _k_end(Sk, q1, causal))
            s = _flash_scores(qs, kf[:, k0:k1], q0, k0, causal,
                              None if hoist_scale else scale)
            p = torch.exp(s - lse_v[..., q0:q1, None])
            dp = torch.einsum("bqkgd,bckd->bkgqc", dof, vf[:, k0:k1])
            yield (q0, q1, k0, k1, qf, dof, kf[:, k0:k1], p,
                   p * (dp - dl[..., q0:q1, None]))


def flash_bwd_dq(q, k, v, dout, lse, delta, *, causal: bool = True,
                 block_q: int, block_k: int, hoist_scale: bool = False):
    """dq ``(B, Sq, H, Dh)`` fp32 from the forward's ``lse`` and ``delta =
    rowsum(dO * O)`` (both ``(B*H, Sq)``): the dQ kernel's function."""
    B, Sq, H, Dh = q.shape
    dq = torch.zeros((B, Sq, k.shape[2], H // k.shape[2], Dh),
                     device=q.device)
    for q0, q1, _, _, _, _, kf, _, ds in _flash_bwd_tiles(
            q, k, v, dout, lse, delta, causal, block_q, block_k,
            hoist_scale):
        dq[:, q0:q1] += torch.einsum("bkgqc,bckd->bqkgd", ds, kf)
    return dq.view(B, Sq, H, Dh) * Dh ** -0.5


def flash_bwd_dkv(q, k, v, dout, lse, delta, *, causal: bool = True,
                  block_q: int, block_k: int, hoist_scale: bool = False):
    """Per-q-head dk and dv ``(B, Sk, H, Dh)`` fp32: the dK/dV kernel's
    function (the GQA group sum is the caller's)."""
    B, _, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dkh = torch.zeros((B, Sk, KV, H // KV, Dh), device=q.device)
    dvh = torch.zeros_like(dkh)
    for _, _, k0, k1, qf, dof, _, p, ds in _flash_bwd_tiles(
            q, k, v, dout, lse, delta, causal, block_q, block_k,
            hoist_scale):
        dkh[:, k0:k1] += torch.einsum("bkgqc,bqkgd->bckgd", ds, qf)
        dvh[:, k0:k1] += torch.einsum("bkgqc,bqkgd->bckgd", p, dof)
    return (dkh.view(B, Sk, H, Dh) * Dh ** -0.5, dvh.view(B, Sk, H, Dh))


def flash_bwd(q, k, v, dout, out, lse, *, causal: bool = True,
              block_q: int, block_k: int, hoist_scale: bool = False):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_fwd`, in the dtypes of q,
    k, v: the plain version of the dQ and dK/dV kernels. Every
    (q-block, k-block) tile's scores are rebuilt as the forward built
    them (:func:`flash_bwd_dq`, :func:`flash_bwd_dkv`: explicit
    gradients in fp32, not autograd through the forward), then the GQA
    group sum."""
    KV = k.shape[2]
    kw = {"causal": causal, "block_q": block_q, "block_k": block_k,
          "hoist_scale": hoist_scale}
    delta = row_delta(dout, out)
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dkh, dvh = flash_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    return (dq.to(q.dtype), group_sum(dkh, KV).to(k.dtype),
            group_sum(dvh, KV).to(v.dtype))


# -------------------------------------------------------------------- ssd

def ssd_ref(x, dt, a, b, c, chunk: int):
    """The SSD kernel's plain version (``repro.kernels.ref.ssd_ref``):
    :func:`repro_torch.models.ssm.ssd_chunked`."""
    return ssd_chunked(x, dt, a, b, c, chunk)


def paged_attention(q, k_pool, v_pool, block_tables, cache_len, *,
                    q_offset=None, window: int = 0, n_global: int = 0,
                    mask=None):
    """Attention over a paged (block) KV pool — the serving path's gather,
    the port of ``repro.kernels.ref.paged_attention_ref``.

    q            ``(B, Sq, H, Dh)``: Sq == 1 for decode, a chunk for prefill
    k/v_pool     ``(NB, page, KV, Dh)``: physical blocks shared by every
                 request
    block_tables ``(B, nmax)`` int64: logical block i of request b lives in
                 physical block ``block_tables[b, i]``
    cache_len    ``(B,)`` int or a host int: logical tokens live in each
                 request's cache, INCLUDING any tokens of q the caller has
                 already scattered into the pool
    q_offset     ``(B,)`` int or a host int: the logical position of
                 ``q[:, 0]``; None means decode (the one q row sits at
                 ``cache_len - 1``)
    window/n_global > 0 -> the TorchGT cluster-sparse decode mask (local
    window + leading global sink tokens), per q position.
    mask         the :func:`~repro_torch.models.layers.attention_mask` of
                 these arguments, when the caller shares one across layers.

    Each request's logical positions ``0..nmax*page-1`` map onto pool rows
    through its block table; rows at or past ``cache_len`` (and acausal
    rows) are masked out, so physical-block reuse never leaks. The gather
    materialises ``(B, nmax * page, KV, Dh)`` k and v, as the
    reference's does."""
    B, Sq, _, Dh = q.shape
    KV = k_pool.shape[2]
    k = k_pool[block_tables].reshape(B, -1, KV, Dh)
    v = v_pool[block_tables].reshape(B, -1, KV, Dh)
    if mask is None:
        q_pos = None
        if q_offset is not None:
            off = q_offset.reshape(-1, 1) if torch.is_tensor(q_offset) \
                else int(q_offset)
            q_pos = off + torch.arange(Sq, device=q.device)[None, :]
        mask = attention_mask(k.shape[1], cache_len, q_pos, window=window,
                              n_global=n_global, device=q.device)
    return masked_attention(q, k, v, mask)
