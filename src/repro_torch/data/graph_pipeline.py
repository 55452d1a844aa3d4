"""Graph data pipeline: graph -> cluster reorder -> condition check ->
elastic reformation layout -> batch of numpy arrays.

The port's copy of the node-task half of ``repro.data.graph_pipeline``:
the same arrays, byte for byte, the dense step's bucket matrix included.
The multi-graph packer and Laplacian positional encodings wait for the
slices that use them.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.auto_tuner import choose_cluster_dim
from repro_torch.core.conditions import ConditionReport, check_conditions
from repro_torch.core.dual_attention import dense_buckets_from_layout
from repro_torch.core.encodings import degree_clip, spd_matrix
from repro_torch.core.graph import Graph
from repro_torch.core.reformation import (BUCKET_MASKED, ClusterLayout,
                                          augment_edges, build_layout)
from repro_torch.core.reorder import cluster_reorder, cut_ratio


@dataclasses.dataclass
class PreparedGraph:
    batch: dict                 # numpy arrays
    layout: ClusterLayout
    report: ConditionReport
    cut: float
    prep_seconds: float
    # cluster-reorder permutation (perm[i] = original node id at sequence
    # position i - n_global). Serving maps original ids to sequence
    # positions through this.
    perm: np.ndarray | None = None


def prepare_node_task(g: Graph, cfg, *, beta_thre: float | None = None,
                      bq: int = 128, bk: int = 128, d_b: int = 16,
                      k_clusters: int | None = None,
                      train_mask: np.ndarray | None = None,
                      with_buckets: bool = True,
                      with_dense_buckets: bool = False,
                      mb_pad: int | None = None,
                      mt_pad: int | None = None,
                      seed: int = 0) -> PreparedGraph:
    """Single-graph node classification: one sequence of all nodes
    (B=1), global tokens prepended.

    ``mb_pad`` / ``mt_pad`` pad the layout's selected-k-block axis and
    the transposed pattern's visiting-q-block axis to fixed capacities
    (see :func:`pad_layout_mb`). ``with_dense_buckets`` adds the scattered
    (1, S, S) int8 bucket matrix the dense interleave step biases with."""
    prep = prepare_node_task_ladder(
        g, cfg, [beta_thre], bq=bq, bk=bk, d_b=d_b, k_clusters=k_clusters,
        train_mask=train_mask, with_buckets=with_buckets,
        with_dense_buckets=with_dense_buckets, seed=seed)[0]
    if mb_pad is not None or mt_pad is not None:
        prep = pad_layout_mb(prep, mb_pad or prep.layout.mb, mt_pad)
    return prep


def prepare_node_task_ladder(g: Graph, cfg, beta_thres,
                             *, bq: int = 128, bk: int = 128,
                             d_b: int = 16, k_clusters: int | None = None,
                             train_mask: np.ndarray | None = None,
                             with_buckets: bool = True,
                             with_dense_buckets: bool = False,
                             seed: int = 0) -> list[PreparedGraph]:
    """One PreparedGraph per ``beta_thre`` in ``beta_thres``, sharing all
    rung-invariant work — cluster reorder, condition check, SPD encodings
    and the feature/degree/label arrays — so probing a whole AutoTuner
    ladder costs one prep plus a layout per rung (only ``block_idx``,
    ``block_idx_t``, ``buckets`` and ``dense_buckets`` depend on the
    threshold). The shared batch arrays are aliased across rungs (treat
    as read-only)."""
    t0 = time.perf_counter()
    while bq > 8 and (g.n + cfg.n_global) < 4 * bq:
        bq //= 2
        bk //= 2
    k_clusters = k_clusters or choose_cluster_dim(g.n, cfg.d_model, bq)
    perm, assign = cluster_reorder(g, k_clusters, seed=seed)
    gp = g.permuted(perm)
    # conditions are checked on the AUGMENTED pattern the layout actually
    # uses (self loops C1, chain C2, global-token edges C3)
    ar, ac, s0 = augment_edges(gp, cfg.n_global, chain=True)
    gaug = Graph(s0, ar.astype(np.int32), ac.astype(np.int32))
    report = check_conditions(gaug, cfg.n_layers)

    spd = None
    if cfg.graph_bias == "spd":
        spd = spd_matrix(gp.with_self_loops(), cfg.max_spd)
    layouts = [build_layout(
        gp, bq=bq, bk=bk, k_clusters=k_clusters, d_b=d_b,
        beta_thre=bt, n_global=cfg.n_global, chain=True,
        buckets=with_buckets, spd=spd, max_spd=cfg.max_spd)
        for bt in beta_thres]

    S = layouts[0].seq_len
    ng = cfg.n_global
    feat = np.zeros((1, S, cfg.feat_dim), np.float32)
    feat[0, ng:ng + g.n] = gp.feat
    ind, outd = gp.degrees()
    in_deg = np.zeros((1, S), np.int32)
    out_deg = np.zeros((1, S), np.int32)
    in_deg[0, ng:ng + g.n] = degree_clip(ind, cfg.max_degree)
    out_deg[0, ng:ng + g.n] = degree_clip(outd, cfg.max_degree)
    labels = np.full((1, S), -1, np.int32)
    if gp.labels is not None:  # label-less graphs (link tasks) stay masked
        lab = gp.labels.copy()
        if train_mask is not None:
            tm = train_mask[perm]
            lab = np.where(tm, lab, -1)
        labels[0, ng:ng + g.n] = lab
    cut = cut_ratio(gp, assign[perm])

    out = []
    t_prev = t0
    for layout in layouts:
        batch = {
            "feat": feat,
            "in_deg": in_deg,
            "out_deg": out_deg,
            "labels": labels,
            "block_idx": layout.block_idx[None],
        }
        if layout.block_idx_t is not None:
            # transposed pattern for the dK/dV backward kernel
            batch["block_idx_t"] = layout.block_idx_t[None]
        if layout.buckets is not None:
            batch["buckets"] = layout.buckets[None]
        if with_dense_buckets:
            batch["dense_buckets"] = dense_buckets_from_layout(layout)[None]
        now = time.perf_counter()
        out.append(PreparedGraph(batch, layout, report, cut, now - t_prev,
                                 perm=perm))
        t_prev = now
    return out


def pad_layout_mb(prep: PreparedGraph, mb: int,
                  mt: int | None = None) -> PreparedGraph:
    """Pad the mb (selected-k-block) axis of ``block_idx``/``buckets`` —
    and the mt (visiting-q-block) axis of the transposed ``block_idx_t``
    — to fixed capacities. Padding slots are -1 / BUCKET_MASKED, i.e.
    fully masked — numerically a no-op."""
    lay = prep.layout
    if mb < lay.mb:
        raise ValueError(f"mb_pad {mb} < layout mb {lay.mb}")
    if mt is not None and lay.block_idx_t is not None and mt < lay.mt:
        raise ValueError(f"mt_pad {mt} < layout mt {lay.mt}")
    if mb == lay.mb and (mt is None or lay.block_idx_t is None
                         or mt == lay.mt):
        return prep
    extra = mb - lay.mb
    block_idx = np.pad(lay.block_idx, ((0, 0), (0, extra)),
                       constant_values=-1)
    buckets = None
    if lay.buckets is not None:
        buckets = np.pad(lay.buckets,
                         ((0, 0), (0, extra), (0, 0), (0, 0)),
                         constant_values=BUCKET_MASKED)
    block_idx_t = lay.block_idx_t
    if block_idx_t is not None and mt is not None and mt > lay.mt:
        block_idx_t = np.pad(block_idx_t,
                             ((0, 0), (0, mt - lay.mt), (0, 0)),
                             constant_values=-1)
    batch = dict(prep.batch)
    batch["block_idx"] = block_idx[None]
    if buckets is not None and "buckets" in batch:
        batch["buckets"] = buckets[None]
    if block_idx_t is not None and "block_idx_t" in batch:
        batch["block_idx_t"] = block_idx_t[None]
    layout = ClusterLayout(lay.seq_len, lay.bq, lay.bk, block_idx, buckets,
                           lay.n_buckets, lay.stats,
                           block_idx_t=block_idx_t)
    return PreparedGraph(batch, layout, prep.report, prep.cut,
                         prep.prep_seconds, perm=prep.perm)
