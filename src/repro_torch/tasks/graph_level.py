"""Graph-level task: batched mini-graph classification (the paper's
MalNet/ZINC setting) with the elastic layout ladder — the port of
``repro.tasks.graph_level``.

Each sequence is one (small) graph; the label lives on the global token
(position 0). ``prepare_graph_task_ladder`` packs every mini-batch at
every AutoTuner rung, and all of them are padded to one shape budget
(``pad_graph_batch``): the largest sequence, selected-k-block count and
visiting-q-block count across (mini-batch x rung). Cycling ragged
mini-batches and re-forming the layout both swap array contents, never
shapes. The packed graphs use 16 x 16 blocks by default, as the
reference does, and the bf16 biased kernels take them.

On a mesh the graphs split over "data" (their per-graph layouts, dense
buckets and labels with them) and each graph's sequence over "model"
(``_sharded_sparse`` in ``core/graph_model.py``). The label sits on the
global token at position 0, on model-rank 0's shard: the other model
ranks add nothing to the loss's count, and ``graph_loss`` sums the
numerator and the count over the mesh (``SumAcross``), so the loss is
the global mean.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.graph_pipeline import (pad_graph_batch,
                                             prepare_graph_task_ladder)
from repro_torch.tasks.elastic import ElasticTask


class GraphLevelTask(ElasticTask):
    """Batched mini-graph classification with an elastic layout.

    ``graphs`` are split into mini-batches of ``batch_graphs`` (default:
    one batch of everything); ``batches(step)`` cycles them. Pass
    ``eval_graphs`` for ``eval(model)`` to report held-out accuracy.
    Batches live on ``device`` (the card unless the caller asks for the
    CPU)."""

    name = "graph_level"
    shardable = True

    def __init__(self, graphs, cfg, *, eval_graphs=None,
                 batch_graphs: int | None = None, bq: int = 16,
                 bk: int = 16, d_b: int = 8, delta: int = 10,
                 seed: int = 0, device="cuda"):
        if not graphs:
            raise ValueError("need at least one training graph")
        self.cfg = cfg
        beta_g = float(np.mean([g.sparsity for g in graphs]))
        betas = self._init_ladder(beta_g, delta, device)
        nb = batch_graphs or len(graphs)
        if len(graphs) % nb:
            raise ValueError(
                f"batch_graphs {nb} does not divide {len(graphs)} graphs: "
                f"the batch dim must stay constant across steps")
        splits = [graphs[i:i + nb] for i in range(0, len(graphs), nb)]
        # one ladder of preps per mini-batch, then one shape budget over
        # everything (rungs AND mini-batches): ladder moves and batch
        # cycling both swap contents only
        per_batch = [prepare_graph_task_ladder(
            gs, cfg, betas, bq=bq, bk=bk, d_b=d_b,
            with_dense_buckets=True, seed=seed) for gs in splits]
        seq_cap = max(p.layout.seq_len for ps in per_batch for p in ps)
        mb_cap = max(p.layout.mb for ps in per_batch for p in ps)
        mt_cap = max(p.layout.mt for ps in per_batch for p in ps)
        # one _shared cache per mini-batch so its rung-invariant arrays
        # stay aliased across rungs through the pad (upload-deduped)
        padded = []
        for ps in per_batch:
            shared: dict = {}
            padded.append([pad_graph_batch(p, seq_cap, mb_cap, mt_cap,
                                           _shared=shared) for p in ps])
        self._set_rungs({bt: [ps[i] for ps in padded]
                         for i, bt in enumerate(betas)})
        self._eval_prep = None
        if eval_graphs:
            # held-out graphs use the paper-default layout (beta_thre=None
            # -> build_layout's 5*beta_g), independent of where the ladder
            # happens to sit — eval measures the model, not the rung
            self._eval_prep = prepare_graph_task_ladder(
                eval_graphs, cfg, [None], bq=bq, bk=bk, d_b=d_b,
                seed=seed)[0]

    @torch.no_grad()
    def eval(self, model) -> dict:
        """Sparse-variant metrics (graph-label accuracy) on the held-out
        graphs (on a mesh: over every rank's shard, the same on every
        rank); {} when the task was built without ``eval_graphs``."""
        if self._eval_prep is None:
            return {}
        b = self._upload(self._eval_prep.batch)
        with self.context():
            _, metrics = self.loss_variants["sparse"](model, b)
        return {k: float(v) for k, v in metrics.items()}


def synthetic_graph_level_dataset(n_graphs: int, cfg, *, seed: int = 0,
                                  n_lo: int = 60, n_hi: int = 120):
    """Synthetic classification set: each graph's class is its number of
    planted SBM clusters (1..n_classes), with a degree signal mixed into
    the features. Shared by ``launch/train.py --task graph`` and
    ``chip_smoke.py``."""
    from repro_torch.core.graph import sbm_graph

    rng = np.random.default_rng(seed)
    graphs = []
    for i in range(n_graphs):
        c = int(rng.integers(1, cfg.n_classes + 1))
        n = int(rng.integers(n_lo, n_hi))
        g = sbm_graph(n, c, p_in=0.25, p_out=0.01, feat_dim=cfg.feat_dim,
                      n_classes=0, seed=seed * 1000 + i, shuffle=True)
        g.labels = np.full(g.n, c - 1, np.int32)
        feat = rng.normal(0, 0.3, (g.n, cfg.feat_dim)).astype(np.float32)
        ind, _ = g.degrees()
        feat[:, 0] = ind / 20.0  # degree signal (scales with cluster size)
        g.feat = feat
        graphs.append(g)
    return graphs
