"""Dual-interleaved attention conditions C1-C3 (paper §III-B).

The sparse (topology-induced) pattern may be used only if:
  C1: every node attends to itself,
  C2: the pattern contains a Hamiltonian path,
  C3: all node pairs reachable within L attention layers.

Checks are heuristic and cheap, as in the paper (Dirac's theorem for C2;
the layout builder *augments* the pattern with self-loops, a sequential
chain and global-token edges, which makes C1/C2 constructive and bounds
the C3 diameter by 2 via the global token — the checker verifies instead
of trusting). The port's copy of ``repro.core.conditions``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import Graph


@dataclasses.dataclass(frozen=True)
class ConditionReport:
    c1_self_loops: bool
    c2_hamiltonian: bool
    c3_reachable: bool
    est_diameter: int

    @property
    def ok(self) -> bool:
        return self.c1_self_loops and self.c2_hamiltonian and self.c3_reachable


def has_self_loops(g: Graph) -> bool:
    loops = np.count_nonzero(g.src == g.dst)
    return loops >= g.n


def has_chain(g: Graph) -> bool:
    """Sequential chain i -> i+1 present for all i (a Hamiltonian path in
    position order — what the layout augmentation guarantees)."""
    chain = g.src + 1 == g.dst
    return np.unique(g.src[chain]).size >= g.n - 1


def dirac_hamiltonian(g: Graph) -> bool:
    """Dirac's theorem (sufficient): min degree >= N/2 -> Hamiltonian."""
    ind, outd = g.degrees()
    return bool(np.minimum(ind, outd).min() >= g.n / 2)


def bfs_eccentricity(g: Graph, sources: np.ndarray) -> int:
    indptr, adj = g.csr()
    worst = 0
    for s in sources:
        dist = np.full(g.n, -1, np.int32)
        dist[s] = 0
        frontier = np.array([s])
        d = 0
        while frontier.size:
            d += 1
            nxt = []
            for v in frontier:
                nb = adj[indptr[v]:indptr[v + 1]]
                nb = nb[dist[nb] < 0]
                dist[nb] = d
                nxt.append(nb)
            frontier = np.unique(np.concatenate(nxt)) if nxt else np.array([])
        if (dist < 0).any():
            return 10 ** 9  # disconnected
        worst = max(worst, int(dist.max()))
    return worst


def check_conditions(g: Graph, n_layers: int, sample: int = 4,
                     seed: int = 0) -> ConditionReport:
    c1 = has_self_loops(g)
    c2 = has_chain(g) or dirac_hamiltonian(g)
    rng = np.random.default_rng(seed)
    srcs = rng.integers(0, g.n, size=min(sample, g.n))
    diam = bfs_eccentricity(g, srcs)
    # each attention layer propagates one hop along pattern edges
    c3 = diam <= n_layers
    return ConditionReport(c1, c2, c3, diam)
