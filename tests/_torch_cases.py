"""Shared inputs for the port's equivalence tests: seeded numpy arrays that
go through the JAX package and through ``repro_torch`` alike."""

import numpy as np
import torch

from repro_torch.core.graph import sbm_graph
from repro_torch.core.reformation import build_layout


def graph_layout(n=200, clusters=4, seed=1, bq=32, d_b=8):
    g = sbm_graph(n, clusters, 0.06, 0.004, seed=seed)
    return build_layout(g, bq=bq, bk=bq, k_clusters=clusters, d_b=d_b,
                        n_global=1)


def per_graph_layout(seeds=(1, 2), **kw):
    """(B, nq, mb) block_idx and (B, nq, mb, bq, bk) buckets of one graph
    per batch row, padded to a common mb with masked slots."""
    lays = [graph_layout(seed=s, **kw) for s in seeds]
    mb = max(lay.mb for lay in lays)
    bi = np.stack([np.pad(lay.block_idx, ((0, 0), (0, mb - lay.mb)),
                          constant_values=-1) for lay in lays])
    bu = np.stack([np.pad(lay.buckets,
                          ((0, 0), (0, mb - lay.mb), (0, 0), (0, 0)),
                          constant_values=-1) for lay in lays])
    return lays[0].seq_len, bi, bu, lays[0].n_buckets


def qkv(B, S, H, KV, Dh, seed=0, n_buckets=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, Dh)).astype(np.float32)
    bias = (rng.standard_normal((H, n_buckets)) * 0.5).astype(np.float32)
    return q, k, v, bias


def t(x, dtype=None):
    """Writable copy of a numpy array as a CPU tensor."""
    out = torch.from_numpy(np.array(x, copy=True))
    return out.to(dtype) if dtype is not None else out
