"""Graph containers + generators (host-side, numpy): the port's copy of
``repro.core.graph``.

Graphs are stored as COO edge lists over contiguous int32 node ids.
Generators cover the paper's regimes: SBM (strong clusters — the
"community" property §III-C exploits) and power-law (skewed degrees —
the irregularity §III-D fixes).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    n: int
    src: np.ndarray  # (E,) int32
    dst: np.ndarray  # (E,) int32
    feat: np.ndarray | None = None   # (N, F) float32
    labels: np.ndarray | None = None  # (N,) int32

    @property
    def e(self) -> int:
        return int(self.src.shape[0])

    @property
    def sparsity(self) -> float:
        """beta_G: proportion of nonzero elements in the adjacency (paper)."""
        return self.e / float(self.n) ** 2

    def degrees(self):
        ind = np.bincount(self.dst, minlength=self.n)
        outd = np.bincount(self.src, minlength=self.n)
        return ind.astype(np.int32), outd.astype(np.int32)

    def with_self_loops(self) -> "Graph":
        """C1: every node attends to itself."""
        loop = np.arange(self.n, dtype=np.int32)
        has = self.src == self.dst
        src = np.concatenate([self.src[~has], self.src[has], loop])
        dst = np.concatenate([self.dst[~has], self.dst[has], loop])
        # dedup
        key = src.astype(np.int64) * self.n + dst
        _, idx = np.unique(key, return_index=True)
        return Graph(self.n, src[idx], dst[idx], self.feat, self.labels)

    def symmetrized(self) -> "Graph":
        src = np.concatenate([self.src, self.dst])
        dst = np.concatenate([self.dst, self.src])
        key = src.astype(np.int64) * self.n + dst
        _, idx = np.unique(key, return_index=True)
        return Graph(self.n, src[idx].astype(np.int32),
                     dst[idx].astype(np.int32), self.feat, self.labels)

    def permuted(self, perm: np.ndarray) -> "Graph":
        """Relabel nodes: new_id = inv_perm[old_id]; perm[i] = old id at
        position i."""
        inv = np.empty(self.n, np.int64)
        inv[perm] = np.arange(self.n)
        feat = self.feat[perm] if self.feat is not None else None
        labels = self.labels[perm] if self.labels is not None else None
        return Graph(self.n, inv[self.src].astype(np.int32),
                     inv[self.dst].astype(np.int32), feat, labels)

    def csr(self):
        order = np.argsort(self.src, kind="stable")
        dst = self.dst[order]
        indptr = np.zeros(self.n + 1, np.int64)
        np.add.at(indptr, self.src + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, dst


def sbm_graph(n: int, n_clusters: int, p_in: float, p_out: float,
              feat_dim: int = 0, n_classes: int = 0, seed: int = 0,
              shuffle: bool = True) -> Graph:
    """Stochastic block model with expected intra/inter degrees. Edges are
    sampled sparsely (never materializes N^2)."""
    rng = np.random.default_rng(seed)
    sizes = np.full(n_clusters, n // n_clusters)
    sizes[: n % n_clusters] += 1
    comm = np.repeat(np.arange(n_clusters), sizes)
    starts = np.concatenate([[0], np.cumsum(sizes)])

    srcs, dsts = [], []
    # intra-cluster edges
    for c in range(n_clusters):
        s, sz = starts[c], sizes[c]
        m = rng.poisson(p_in * sz * sz)
        if m:
            srcs.append(rng.integers(s, s + sz, m))
            dsts.append(rng.integers(s, s + sz, m))
    # inter-cluster edges
    m = rng.poisson(p_out * n * n)
    if m:
        srcs.append(rng.integers(0, n, m))
        dsts.append(rng.integers(0, n, m))
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]

    feat = labels = None
    if feat_dim:
        centers = rng.normal(0, 1, (n_clusters, feat_dim)).astype(np.float32)
        feat = centers[comm] + rng.normal(0, 1.0, (n, feat_dim)).astype(
            np.float32)
    if n_classes:
        labels = (comm % n_classes).astype(np.int32)

    g = Graph(n, src, dst, feat, labels).symmetrized()
    if shuffle:  # hide the cluster structure (reorder must re-find it)
        perm = rng.permutation(n)
        g = g.permuted(perm.astype(np.int64))
    return g


def powerlaw_graph(n: int, m_per_node: int = 4, feat_dim: int = 0,
                   n_classes: int = 0, seed: int = 0) -> Graph:
    """Barabasi-Albert-style preferential attachment (skewed degrees)."""
    rng = np.random.default_rng(seed)
    src = np.arange(m_per_node, n, dtype=np.int64)
    src = np.repeat(src, m_per_node)
    # preferential attachment approximated by sampling previous endpoints
    dst = np.empty_like(src)
    targets = list(range(m_per_node))
    pool = list(range(m_per_node))
    k = 0
    for v in range(m_per_node, n):
        picks = rng.choice(len(pool), m_per_node, replace=True)
        for j in range(m_per_node):
            dst[k] = pool[picks[j]]
            k += 1
        pool.extend([v] * m_per_node)
        pool.extend(dst[k - m_per_node:k].tolist())
    feat = rng.normal(0, 1, (n, feat_dim)).astype(np.float32) \
        if feat_dim else None
    labels = rng.integers(0, n_classes, n).astype(np.int32) \
        if n_classes else None
    return Graph(n, src.astype(np.int32), dst.astype(np.int32),
                 feat, labels).symmetrized()
