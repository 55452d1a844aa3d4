"""Cluster-aware node reordering (paper §III-C, "Utilization of Graph
Cluster").

METIS stand-in: a multilevel-flavoured lightweight partitioner —
BFS-grown balanced clusters over the CSR adjacency, followed by a
boundary-refinement sweep (Kernighan-Lin flavoured, single pass). Output is
a permutation placing each cluster contiguously, so the attention layout
becomes block-clustered (Figure 5(b)) without changing connectivity.

Quality is measured by ``cut_ratio`` (fraction of edges crossing clusters);
tests assert it recovers planted SBM clusters. The port's copy of
``repro.core.reorder``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph


def bfs_cluster(g: Graph, n_clusters: int, seed: int = 0):
    """Greedy balanced BFS growth: pick an unvisited seed (highest degree
    first), BFS until the cluster reaches its budget, repeat."""
    n = g.n
    indptr, adj = g.csr()
    target = -(-n // n_clusters)
    assign = np.full(n, -1, np.int64)
    deg = np.diff(indptr)
    order = np.argsort(-deg)  # high-degree seeds first
    cur = 0
    oi = 0
    from collections import deque
    for c in range(n_clusters):
        # find next unassigned seed
        while oi < n and assign[order[oi]] >= 0:
            oi += 1
        if oi >= n:
            break
        q = deque([order[oi]])
        size = 0
        while q and size < target:
            v = q.popleft()
            if assign[v] >= 0:
                continue
            assign[v] = c
            size += 1
            for u in adj[indptr[v]:indptr[v + 1]]:
                if assign[u] < 0:
                    q.append(u)
        cur = c
    # leftovers -> smallest clusters
    left = np.flatnonzero(assign < 0)
    if left.size:
        sizes = np.bincount(assign[assign >= 0], minlength=n_clusters)
        for v in left:
            c = int(np.argmin(sizes))
            assign[v] = c
            sizes[c] += 1
    return assign


def refine(g: Graph, assign: np.ndarray, n_clusters: int, rounds: int = 1):
    """One KL-style sweep: move boundary nodes to the neighbouring cluster
    with the most connections, respecting a loose balance cap."""
    n = g.n
    indptr, adj = g.csr()
    cap = int(1.15 * -(-n // n_clusters))
    sizes = np.bincount(assign, minlength=n_clusters)
    for _ in range(rounds):
        for v in range(n):
            nb = adj[indptr[v]:indptr[v + 1]]
            if nb.size == 0:
                continue
            cnt = np.bincount(assign[nb], minlength=n_clusters)
            best = int(np.argmax(cnt))
            cur = assign[v]
            if best != cur and cnt[best] > cnt[cur] and sizes[best] < cap:
                sizes[cur] -= 1
                sizes[best] += 1
                assign[v] = best
    return assign


def cluster_reorder(g: Graph, n_clusters: int, refine_rounds: int = 1,
                    seed: int = 0):
    """-> (perm, assign): ``perm[i]`` = old node id placed at position i.
    Clusters are laid out contiguously in ascending cluster id."""
    assign = bfs_cluster(g, n_clusters, seed)
    if refine_rounds:
        assign = refine(g, assign, n_clusters, refine_rounds)
    perm = np.argsort(assign, kind="stable").astype(np.int64)
    return perm, assign


def cut_ratio(g: Graph, assign: np.ndarray) -> float:
    """Fraction of edges crossing cluster boundaries (lower = better)."""
    cross = assign[g.src] != assign[g.dst]
    return float(cross.mean()) if g.e else 0.0
