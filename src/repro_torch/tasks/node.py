"""Node-level task: single-graph node classification with the elastic
layout ladder — the port of ``repro.tasks.node.NodeTask``.

One sequence of all nodes (B=1), global tokens prepended, masked
cross-entropy over labelled positions. Every ladder rung's layout is
built once through ``prepare_node_task_ladder`` (with the dense step's
bucket matrix) and padded to the ladder's largest ``mb`` and ``mt``, so
a ladder move swaps array contents only.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.graph_pipeline import (pad_layout_mb,
                                             prepare_node_task_ladder)
from repro_torch.tasks.base import shard_rows
from repro_torch.tasks.elastic import ElasticTask


class NodeTask(ElasticTask):
    """Single-graph node classification with an elastic layout.

    ``train_mask`` hides non-train labels from the loss; ``eval(model)``
    then reports the sparse variant's metrics over the held-out
    (non-train) nodes, or over all labelled nodes without a mask.
    Batches live on ``device`` (the card unless the caller asks for the
    CPU)."""

    name = "node"
    shardable = True

    def __init__(self, g, cfg, *, train_mask=None, bq: int = 32,
                 bk: int = 32, d_b: int = 8, delta: int = 10,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.g = g
        betas = self._init_ladder(g.sparsity, delta, device)
        preps = dict(zip(betas, prepare_node_task_ladder(
            g, cfg, betas, bq=bq, bk=bk, d_b=d_b, train_mask=train_mask,
            with_dense_buckets=True, seed=seed)))
        seqs = {p.layout.seq_len for p in preps.values()}
        if len(seqs) != 1:  # deterministic prep => can't happen; be loud
            raise AssertionError(f"re-layout changed seq_len: {seqs}")
        mb_cap = max(p.layout.mb for p in preps.values())
        mt_cap = max(p.layout.mt for p in preps.values())
        self._set_rungs({bt: [pad_layout_mb(p, mb_cap, mt_cap)]
                         for bt, p in preps.items()})
        # held-out labels: the permuted full label vector, train positions
        # masked out when a train_mask was given
        ng = cfg.n_global
        S = next(iter(seqs))
        ev = np.full((1, S), -1, np.int32)
        if g.labels is not None:
            lab = g.labels[self.prep.perm]
            if train_mask is not None:
                lab = np.where(train_mask[self.prep.perm], -1, lab)
            ev[0, ng:ng + g.n] = lab
        self._eval_labels = ev

    @torch.no_grad()
    def eval(self, model) -> dict:
        """Metrics of the sparse variant on the eval label set (on a mesh:
        over every rank's shard, the same on every rank)."""
        b = dict(self.batches(0))
        b["labels"] = torch.from_numpy(shard_rows(
            self._eval_labels, self.mesh, seq_dim=self.seq_sharded).copy()
        ).to(device=self.device, dtype=torch.long)
        with self.context():
            _, metrics = model.loss_variants["sparse"](model, b)
        return {k: float(v) for k, v in metrics.items()}
