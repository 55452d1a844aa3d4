"""Elastic Computation Reformation (paper §III-D) — host-side layout builder.

Input: a cluster-reordered graph. Output: a *cluster-sparse* attention
layout at TPU block granularity:

* the (S/bq x S/bk) block grid is intersected with the k x k cluster grid;
* clusters whose sparsity beta_C >= beta_thre ("dense clusters", mostly the
  diagonal) keep their exact edge pattern, expressed as active (bq,bk)
  blocks + per-position bucket masks;
* clusters with beta_C < beta_thre ("sparse clusters") are REFORMED: their
  scattered edges are snapped into ceil(nnz/d_b^2) dense d_b x d_b
  sub-blocks (the densest tiles win; leftover edges are dropped, tile
  interiors are filled) — trading graph fidelity for regular memory access,
  exactly the paper's elastic transfer. beta_thre is supplied per-epoch by
  the Auto Tuner.

The layout feeds both the plain blocked attention (kernels/ref.py) and
the CUDA cluster kernel (kernels/cluster_attention.py). This is the
port's copy of ``repro.core.reformation``: the same arrays, byte for
byte.

Bias buckets (int8): -1 masked, 0 self, 1 real edge, 2 reform-fill; in SPD
mode buckets 0..max_spd are shortest-path distances (computed separately)
and bucket max_spd+1 is the virtual distance of any pair involving a
global token (Graphormer's virtual-node bias) — the SPD matrix is indexed
in *node* space, so augmented positions are shifted back by n_global.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import Graph

BUCKET_MASKED = -1
BUCKET_SELF = 0
BUCKET_EDGE = 1
BUCKET_FILL = 2
N_BUCKETS_ADJ = 3


@dataclasses.dataclass
class ClusterLayout:
    seq_len: int          # padded sequence length
    bq: int
    bk: int
    block_idx: np.ndarray  # (nq, mb) int32, -1 padded
    buckets: np.ndarray | None  # (nq, mb, bq, bk) int8
    n_buckets: int
    stats: dict
    # transposed pattern for the dK/dV backward kernel: per k-block row,
    # the (q-block row, forward slot) pairs that visit it — (nk, mt, 2)
    # int32, -1 padded (see kernels/cluster_attention_bwd.py)
    block_idx_t: np.ndarray | None = None

    @property
    def nq(self) -> int:
        return self.block_idx.shape[0]

    @property
    def mb(self) -> int:
        return self.block_idx.shape[1]

    @property
    def mt(self) -> int:
        """Capacity of the transposed pattern's visiting-q-block axis."""
        return 0 if self.block_idx_t is None else self.block_idx_t.shape[1]


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def transpose_block_idx(block_idx: np.ndarray, nk: int) -> np.ndarray:
    """Transposed block pattern for the dK/dV backward kernel: for each
    k-block ``j``, the list of ``(q-block row i, forward slot m)`` pairs
    with ``block_idx[i, m] == j``. Returns ``(nk, mt, 2)`` int32, -1
    padded, ``mt`` padded to a multiple of 4 (same convention as the
    forward ``mb`` axis) so elastic re-reformation pads both layouts the
    same way."""
    nq, mb = block_idx.shape
    ii, mm = np.nonzero(block_idx >= 0)
    jj = block_idx[ii, mm]
    order = np.lexsort((ii, jj))       # group by k-block, q-rows ascending
    ii, mm, jj = ii[order], mm[order], jj[order]
    counts = np.bincount(jj, minlength=nk)
    mt = max(4, _pad_to(int(counts.max()) if counts.size else 1, 4))
    out = np.full((nk, mt, 2), -1, np.int32)
    slot = np.arange(jj.size) - np.concatenate(
        [[0], np.cumsum(counts)[:-1]])[jj]
    out[jj, slot, 0] = ii
    out[jj, slot, 1] = mm
    return out


def augment_edges(g: Graph, n_global: int, chain: bool):
    """Position-space edge list with global tokens prepended, self loops and
    the sequential chain added (constructive C1/C2/C3)."""
    N = g.n
    S = N + n_global
    r = [g.src.astype(np.int64) + n_global]
    c = [g.dst.astype(np.int64) + n_global]
    ar = np.arange(S, dtype=np.int64)
    r.append(ar)          # self loops (C1)
    c.append(ar)
    if chain and S > 1:   # Hamiltonian chain (C2)
        r.append(ar[:-1])
        c.append(ar[1:])
        r.append(ar[1:])
        c.append(ar[:-1])
    if n_global:
        gn = np.arange(n_global, dtype=np.int64)
        nodes = np.arange(S, dtype=np.int64)
        r.append(np.repeat(gn, S))       # global attends to all (C3)
        c.append(np.tile(nodes, n_global))
        r.append(np.tile(nodes, n_global))
        c.append(np.repeat(gn, S))
    rr, cc = np.concatenate(r), np.concatenate(c)
    key = rr * (S + 1) + cc
    _, idx = np.unique(key, return_index=True)
    return rr[idx], cc[idx], S


def build_layout(g: Graph, *, bq: int = 128, bk: int = 128,
                 k_clusters: int = 8, d_b: int = 16,
                 beta_thre: float | None = None, n_global: int = 1,
                 chain: bool = True, buckets: bool = True,
                 spd: np.ndarray | None = None,
                 max_spd: int = 16) -> ClusterLayout:
    r, c, S0 = augment_edges(g, n_global, chain)
    S = _pad_to(S0, max(bq, bk))
    nq, nk = S // bq, S // bk
    beta_g = (g.e + S0) / float(S0) ** 2
    if beta_thre is None:
        beta_thre = 5 * beta_g  # paper's suggested default (Table VIII)

    cs = _pad_to(-(-S // k_clusters), max(bq, bk))  # cluster side, aligned
    kk = -(-S // cs)
    cr, cc_ = r // cs, c // cs
    cid = cr * kk + cc_
    nnz = np.bincount(cid, minlength=kk * kk).astype(np.int64)
    beta_c = nnz / float(cs) ** 2
    is_sparse_cluster = (beta_c < beta_thre) & (nnz > 0)

    sparse_mask = is_sparse_cluster[cid]
    n_transferred = int(is_sparse_cluster.sum())

    # ---- reform sparse clusters: snap edges to d_b tiles ----
    kept_r, kept_c = [r[~sparse_mask]], [c[~sparse_mask]]
    fill_blocks = []  # (tile_r, tile_c) in d_b units, to be densified
    if sparse_mask.any():
        rs, cs2 = r[sparse_mask], c[sparse_mask]
        cids = cid[sparse_mask]
        tile = (rs // d_b) * (S // d_b + 1) + (cs2 // d_b)
        # per-cluster budget: ceil(nnz_c / d_b^2) tiles
        order = np.lexsort((tile, cids))
        tile_sorted, cid_sorted = tile[order], cids[order]
        # count edges per (cluster, tile)
        boundary = np.concatenate([[True], (tile_sorted[1:] != tile_sorted[:-1])
                                   | (cid_sorted[1:] != cid_sorted[:-1])])
        tile_ids = tile_sorted[boundary]
        tile_cl = cid_sorted[boundary]
        counts = np.diff(np.concatenate([np.flatnonzero(boundary),
                                         [tile_sorted.size]]))
        # budget per cluster
        budget = -(-nnz // (d_b * d_b))
        # rank tiles within cluster by count (desc)
        rank_order = np.lexsort((-counts, tile_cl))
        tc, cnt, tid = tile_cl[rank_order], counts[rank_order], \
            tile_ids[rank_order]
        pos_in_cluster = np.arange(tc.size) - np.concatenate(
            [[0], np.cumsum(np.bincount(tc, minlength=kk * kk))[:-1]])[tc]
        keep_tile = pos_in_cluster < budget[tc]
        fill_blocks.append(tid[keep_tile])
        edges_in_kept_tiles = int(cnt[keep_tile].sum())
        edges_dropped = int(rs.size) - edges_in_kept_tiles
    else:
        edges_dropped = 0
    kept_r = np.concatenate(kept_r)
    kept_c = np.concatenate(kept_c)

    # ---- active (bq, bk) blocks ----
    br, bc = kept_r // bq, kept_c // bk
    active = set(zip(br.tolist(), bc.tolist()))
    tiles_per_brow = bq // d_b
    if fill_blocks and fill_blocks[0].size:
        tid = fill_blocks[0]
        tr, tcl = tid // (S // d_b + 1), tid % (S // d_b + 1)
        fbr, fbc = tr * d_b // bq, tcl * d_b // bk
        active |= set(zip(fbr.tolist(), fbc.tolist()))

    # C1 guarantee: the diagonal block of every row survives reformation
    # (a large beta_thre can otherwise reform the diagonal cluster and its
    # tile budget may drop some self-loop tiles — found by hypothesis).
    for i in range(nq):
        active.add((i, (i * bq) // bk))

    rows = [[] for _ in range(nq)]
    for (i, j) in active:
        rows[int(i)].append(int(j))
    mb = max(4, _pad_to(max((len(x) for x in rows), default=1), 4))
    block_idx = np.full((nq, mb), -1, np.int32)
    for i, js in enumerate(rows):
        js = sorted(js)
        block_idx[i, :len(js)] = js

    # ---- bucket masks (vectorized; edge counts reach millions) ----
    bucket_arr = None
    if buckets:
        bucket_arr = np.full((nq, mb, bq, bk), BUCKET_MASKED, np.int8)
        # m_of[i, j] = slot of k-block j in row i (-1 if absent)
        m_of = np.full((nq, nk), -1, np.int32)
        rows_i = np.repeat(np.arange(nq), mb)
        cols_j = block_idx.reshape(-1)
        sel = cols_j >= 0
        m_of[rows_i[sel], cols_j[sel]] = np.tile(np.arange(mb), nq)[sel]
        # exact edges
        if spd is not None:
            # spd is (N, N) in node space; positions carry n_global
            # prepended global tokens, so node rows sit at p - n_global.
            N = spd.shape[0]
            nr = np.clip(kept_r - n_global, 0, N - 1)
            nc = np.clip(kept_c - n_global, 0, N - 1)
            vals = np.minimum(spd[nr, nc], max_spd).astype(np.int8)
            glob = (kept_r < n_global) | (kept_c < n_global)
            vals = np.where(glob, np.int8(max_spd + 1), vals)
            vals = np.where(glob & (kept_r == kept_c),
                            np.int8(BUCKET_SELF), vals).astype(np.int8)
        else:
            vals = np.where(kept_r == kept_c, BUCKET_SELF,
                            BUCKET_EDGE).astype(np.int8)
        br_, bc_ = kept_r // bq, kept_c // bk
        mm = m_of[br_, bc_]
        ok = mm >= 0
        bucket_arr[br_[ok], mm[ok], kept_r[ok] % bq, kept_c[ok] % bk] = \
            vals[ok]
        # C1: self positions always attend (bucket SELF)
        pr = np.arange(S0)
        mself = m_of[pr // bq, pr // bk]
        oks = mself >= 0
        cur = bucket_arr[pr[oks] // bq, mself[oks], pr[oks] % bq,
                         pr[oks] % bk]
        bucket_arr[pr[oks] // bq, mself[oks], pr[oks] % bq, pr[oks] % bk] \
            = np.where(cur == BUCKET_MASKED, BUCKET_SELF, cur)
        # reformed tiles: densify (vectorized over d_b x d_b offsets)
        if fill_blocks and fill_blocks[0].size:
            t = fill_blocks[0]
            tr = (t // (S // d_b + 1)).astype(np.int64) * d_b
            tcl = (t % (S // d_b + 1)).astype(np.int64) * d_b
            mt = m_of[tr // bq, tcl // bk]
            okt = mt >= 0
            tr, tcl, mt = tr[okt], tcl[okt], mt[okt]
            off = np.arange(d_b)
            rr = (tr[:, None, None] % bq) + off[None, :, None]  # (T,db,db)
            cc = (tcl[:, None, None] % bk) + off[None, None, :]
            bi_t = np.broadcast_to((tr // bq)[:, None, None], rr.shape)
            mi_t = np.broadcast_to(mt[:, None, None], rr.shape)
            cur = bucket_arr[bi_t, mi_t, rr, cc]
            bucket_arr[bi_t, mi_t, rr, cc] = np.where(
                cur == BUCKET_MASKED, BUCKET_FILL, cur)

    # SPD: distances 0..max_spd plus the global-pair virtual bucket
    n_buckets = (max_spd + 2) if spd is not None else N_BUCKETS_ADJ
    active_blocks = int((block_idx >= 0).sum())
    stats = {
        "beta_g": beta_g,
        "beta_thre": beta_thre,
        "clusters_transferred": n_transferred,
        "clusters_total": int((nnz > 0).sum()),
        "active_blocks": active_blocks,
        "density": active_blocks * bq * bk / float(S) ** 2,
        "edges_kept": int(kept_r.size),
        "edges_dropped": edges_dropped,
    }
    return ClusterLayout(S, bq, bk, block_idx, bucket_arr, n_buckets, stats,
                         block_idx_t=transpose_block_idx(block_idx, nk))
