"""Graph structural encodings (paper §II-A, Eq. 2-3): the port's copy of
``repro.core.encodings``.

* degree encodings: learnable embeddings indexed by in/out degree
  (Graphormer Eq. 2),
* SPD buckets: shortest-path-distance matrix for the attention bias
  (Graphormer Eq. 3) — BFS per node, capped; small graphs only (O(N*E)).
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


def degree_clip(deg: np.ndarray, max_degree: int) -> np.ndarray:
    return np.minimum(deg, max_degree - 1).astype(np.int32)
