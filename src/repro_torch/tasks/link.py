"""Link-prediction task: edge scoring with negative sampling — the port
of ``repro.tasks.link``.

The graph transformer encodes the (cluster-reordered) node sequence
exactly as the node task does — elastic ladder and dual interleave
included — and the loss scores node pairs by the scaled dot product of
their final hidden states, binary cross-entropy against sampled
positives (real edges) vs negatives (uniform random pairs).

Pair sampling is pure in ``step`` (seeded by ``(seed, step)``), so a
restart replays the exact pair stream, and the pair arrays have a fixed
shape ``(n_pairs,)``. A held-out edge set (``eval_frac``, split on
*undirected* pairs so the symmetrized reverse edge cannot leak into
training) is excluded from the per-step positive sampling and scored by
``eval(model)`` against fresh negatives.

On a mesh the node sequence is sharded over "model", and a pair's two
positions may live on other ranks: ``link_loss`` all-gathers ``h``
(``GatherSeq``), each model rank scores its own 1/P of the pairs, and
the numerator and the count are summed over the mesh (``SumAcross``),
so the loss is the global mean. Were every rank to score every pair,
the gather's backward (a reduce-scatter) would sum P copies of each
gradient. The pair stream is the same on every rank and on every mesh.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.graph_model import graph_forward, with_dense_bias
from repro_torch.parallel import axes as pax
from repro_torch.parallel import collectives as C
from repro_torch.tasks.node import NodeTask


def link_loss(model, batch: dict, *, dense: bool = False,
              impl: str | None = None):
    """Dot-product edge scoring over the task's pair arrays:
    ``pair_src``/``pair_dst`` are sequence positions (node order already
    shifted by ``n_global``), ``pair_y`` in {0, 1}. ``(loss, {"xent",
    "acc"})`` on fp32 scores; on a mesh the mean over every rank's share
    of the pairs."""
    h = graph_forward(model, batch, dense=dense, impl=impl)
    src, dst, y = batch["pair_src"], batch["pair_dst"], batch["pair_y"]
    group = pax.seq_group()
    if group is not None:   # the whole sequence, this rank's 1/P pairs
        h = C.GatherSeq.apply(h, group)
        part = lambda t: t.tensor_split(C.size(group))[  # noqa: E731
            C.rank(group)]
        src, dst, y = part(src), part(dst), part(y)
    hn = h[0].float()                           # (S, D); link graphs are B=1
    logits = (hn[src] * hn[dst]).sum(-1) / np.sqrt(hn.shape[-1])
    y = y.float()
    sums = torch.stack([(F.softplus(logits) - y * logits).sum(),  # BCE
                        torch.tensor(float(y.numel()), device=y.device),
                        ((logits > 0) == (y > 0.5)).float().sum()])
    mesh = pax.mesh_group()
    if mesh is not None:
        sums = C.SumAcross.apply(sums, mesh)
    loss, acc = sums[0] / sums[1], sums[2] / sums[1]
    return loss, {"xent": loss, "acc": acc}


class LinkTask(NodeTask):
    """Edge scoring with negative sampling on a single graph.

    Reuses the node task's elastic ladder prep wholesale (the encoder
    input is identical); only the loss head and the per-step pair stream
    differ."""

    name = "link"

    def __init__(self, g, cfg, *, n_pairs: int = 256,
                 eval_frac: float = 0.1, bq: int = 32, bk: int = 32,
                 d_b: int = 8, delta: int = 10, seed: int = 0,
                 device="cuda"):
        super().__init__(g, cfg, bq=bq, bk=bk, d_b=d_b, delta=delta,
                         seed=seed, device=device)
        self.n_pairs = int(n_pairs)
        self.seed = seed
        ng = cfg.n_global
        inv = np.empty(g.n, np.int64)
        inv[self.prep.perm] = np.arange(g.n)
        pos_src = (inv[g.src] + ng).astype(np.int32)
        pos_dst = (inv[g.dst] + ng).astype(np.int32)
        # split on UNDIRECTED pairs: the graphs are symmetrized and the
        # dot-product score is symmetric, so holding out (u, v) while
        # training on (v, u) would leak every eval edge into training
        rng = np.random.default_rng(seed)
        lo = np.minimum(pos_src, pos_dst).astype(np.int64)
        hi = np.maximum(pos_src, pos_dst).astype(np.int64)
        key = lo * (ng + g.n + 1) + hi
        uniq, first = np.unique(key, return_index=True)
        perm_u = rng.permutation(len(uniq))
        n_eval = max(1, int(len(uniq) * eval_frac))
        held = perm_u[:n_eval]
        is_eval = np.isin(key, uniq[held])
        if is_eval.all():
            raise ValueError("eval_frac leaves no training edges")
        self._train_edges = (pos_src[~is_eval], pos_dst[~is_eval])
        # one representative direction per held-out undirected pair
        rep = first[held]
        self._eval_edges = (pos_src[rep], pos_dst[rep])
        self._node_lo, self._node_hi = ng, ng + g.n

    # ------------------------------------------------------------ data

    def _sample_pairs(self, rng, es, ed, k: int):
        """k positives from the edge list + k uniform-random negatives."""
        idx = rng.integers(0, len(es), k)
        neg_s = rng.integers(self._node_lo, self._node_hi, k)
        neg_d = rng.integers(self._node_lo, self._node_hi, k)
        src = np.concatenate([es[idx], neg_s]).astype(np.int32)
        dst = np.concatenate([ed[idx], neg_d]).astype(np.int32)
        y = np.concatenate([np.ones(k, np.int32), np.zeros(k, np.int32)])
        return src, dst, y

    def _with_pairs(self, batch: dict, src, dst, y) -> dict:
        """A copy of the cached device batch with the pair arrays added
        (the cache itself is never written)."""
        b = dict(batch)
        for key, arr in (("pair_src", src), ("pair_dst", dst),
                         ("pair_y", y)):
            b[key] = torch.from_numpy(arr).to(device=self.device,
                                              dtype=torch.long)
        return b

    def batches(self, step: int) -> dict:
        rng = np.random.default_rng([self.seed, step])  # pure in step
        return self._with_pairs(super().batches(step), *self._sample_pairs(
            rng, *self._train_edges, self.n_pairs // 2))

    # ------------------------------------------------------------ losses

    @property
    def loss_variants(self):
        return {
            "sparse": lambda m, b: link_loss(m, b),
            "dense": lambda m, b: link_loss(m, with_dense_bias(m, b),
                                            dense=True),
        }

    # -------------------------------------------------------------- eval

    @torch.no_grad()
    def eval(self, model) -> dict:
        """BCE/accuracy on the held-out edges vs fresh negatives."""
        rng = np.random.default_rng([self.seed + 1, 0])
        es, ed = self._eval_edges
        k = len(es)
        neg_s = rng.integers(self._node_lo, self._node_hi, k)
        neg_d = rng.integers(self._node_lo, self._node_hi, k)
        b = self._with_pairs(
            super().batches(0),
            np.concatenate([es, neg_s]).astype(np.int32),
            np.concatenate([ed, neg_d]).astype(np.int32),
            np.concatenate([np.ones(k, np.int32), np.zeros(k, np.int32)]))
        with self.context():
            _, metrics = self.loss_variants["sparse"](model, b)
        return {k_: float(v) for k_, v in metrics.items()}
