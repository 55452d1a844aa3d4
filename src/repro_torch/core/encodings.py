"""Graph structural encodings (paper §II-A, Eq. 2-3): the port's copy of
``repro.core.encodings``.

* degree encodings: learnable embeddings indexed by in/out degree
  (Graphormer Eq. 2),
* SPD buckets: shortest-path-distance matrix for the attention bias
  (Graphormer Eq. 3) — BFS per node, capped; small graphs only (O(N*E)),
* Laplacian positional encodings (GT model).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph


def spd_matrix(g: Graph, max_spd: int = 16) -> np.ndarray:
    """(N, N) int8 shortest-path hop counts, capped at max_spd (which also
    stands for 'unreachable'). Dense — small graphs only."""
    indptr, adj = g.csr()
    n = g.n
    out = np.full((n, n), max_spd, np.int8)
    for s in range(n):
        dist = out[s]
        dist[s] = 0
        frontier = [s]
        d = 0
        seen = np.zeros(n, bool)
        seen[s] = True
        while frontier and d < max_spd - 1:
            d += 1
            nxt = []
            for v in frontier:
                for u in adj[indptr[v]:indptr[v + 1]]:
                    if not seen[u]:
                        seen[u] = True
                        dist[u] = d
                        nxt.append(u)
            frontier = nxt
    return out


def lap_pe(g: Graph, k: int = 8) -> np.ndarray:
    """First k non-trivial eigenvectors of the symmetric normalized
    Laplacian (GT positional encodings). Dense eigh — small graphs only."""
    n = g.n
    a = np.zeros((n, n), np.float64)
    a[g.src, g.dst] = 1.0
    a = np.maximum(a, a.T)
    d = a.sum(1)
    dinv = 1.0 / np.sqrt(np.maximum(d, 1e-9))
    lap = np.eye(n) - (a * dinv[None, :]) * dinv[:, None]
    w, v = np.linalg.eigh(lap)
    pe = v[:, 1:k + 1]
    if pe.shape[1] < k:
        pe = np.pad(pe, ((0, 0), (0, k - pe.shape[1])))
    return pe.astype(np.float32)


def degree_clip(deg: np.ndarray, max_degree: int) -> np.ndarray:
    return np.minimum(deg, max_degree - 1).astype(np.int32)
