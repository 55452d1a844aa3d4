"""Graph data pipeline: graph -> cluster reorder -> condition check ->
elastic reformation layout -> batch of numpy arrays.

The port's copy of ``repro.data.graph_pipeline``: the same arrays, byte
for byte, the dense step's bucket matrix and GT's Laplacian positional
encodings included — the node task's single graph
(:func:`prepare_node_task_ladder`) and the graph-level task's packed
mini-graphs (:func:`prepare_graph_task_ladder`, :func:`pad_graph_batch`).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.auto_tuner import choose_cluster_dim
from repro_torch.core.conditions import ConditionReport, check_conditions
from repro_torch.core.dual_attention import dense_buckets_from_layout
from repro_torch.core.encodings import degree_clip, lap_pe, spd_matrix
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
    # position i - n_global); None for multi-graph batches. Serving and
    # the link task map original ids to sequence positions through this.
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
    rung-invariant work — cluster reorder, condition check, SPD/LapPE
    encodings and the feature/degree/label arrays — so probing a whole
    AutoTuner ladder costs one prep plus a layout per rung (only
    ``block_idx``, ``block_idx_t``, ``buckets`` and ``dense_buckets``
    depend on the threshold). The shared batch arrays are aliased across
    rungs (treat as read-only)."""
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
    pe = None
    if cfg.name.startswith("gt"):
        pe = np.zeros((1, S, 8), np.float32)
        pe[0, ng:ng + g.n] = lap_pe(gp)
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
        if pe is not None:
            batch["lap_pe"] = pe
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


def prepare_graph_task(graphs: list[Graph], cfg, *, bq: int = 32,
                       bk: int = 32, d_b: int = 8,
                       beta_thre: float | None = None,
                       with_dense_buckets: bool = False,
                       seq_pad: int | None = None,
                       mb_pad: int | None = None,
                       seed: int = 0) -> PreparedGraph:
    """Graph-level classification: each sequence is one (small) graph,
    label sits on the global token (position 0). Stats, cut ratio and the
    condition report are aggregated over the whole batch, not read off
    graph 0. ``seq_pad``/``mb_pad`` force a fixed shape budget (see
    :func:`pad_graph_batch`) so mini-batches of differently-sized graphs
    stay shape-identical across training steps and ladder rungs."""
    return prepare_graph_task_ladder(
        graphs, cfg, [beta_thre], bq=bq, bk=bk, d_b=d_b,
        with_dense_buckets=with_dense_buckets, seq_pad=seq_pad,
        mb_pad=mb_pad, seed=seed)[0]


def prepare_graph_task_ladder(graphs: list[Graph], cfg, beta_thres,
                              *, bq: int = 32, bk: int = 32, d_b: int = 8,
                              with_dense_buckets: bool = False,
                              seq_pad: int | None = None,
                              mb_pad: int | None = None,
                              seed: int = 0) -> list[PreparedGraph]:
    """One PreparedGraph per ``beta_thre``, sharing the rung-invariant
    per-graph work (cluster reorder, condition check, SPD, features)
    exactly like :func:`prepare_node_task_ladder` does for single-graph
    tasks — probing an AutoTuner ladder costs one reorder pass plus a
    layout per (graph, rung)."""
    t0 = time.perf_counter()
    invariant = []   # (gp, k_clusters, spd) per graph
    cuts = []
    reports = []
    for gr in graphs:
        k = max(1, min(4, gr.n // (2 * bq) or 1))
        perm, assign = cluster_reorder(gr, k, seed=seed)
        gp = gr.permuted(perm)
        cuts.append(cut_ratio(gp, assign[perm]))
        ar, ac, s0 = augment_edges(gp, cfg.n_global, chain=True)
        reports.append(check_conditions(
            Graph(s0, ar.astype(np.int32), ac.astype(np.int32)),
            cfg.n_layers))
        spd = spd_matrix(gp.with_self_loops(), cfg.max_spd) \
            if cfg.graph_bias == "spd" else None
        invariant.append((gp, k, spd))
    report = ConditionReport(
        all(r.c1_self_loops for r in reports),
        all(r.c2_hamiltonian for r in reports),
        all(r.c3_reachable for r in reports),
        max(r.est_diameter for r in reports))
    cut = float(np.mean(cuts))

    # only block_idx/buckets/dense_buckets depend on the rung; everything
    # else (feat, degrees, labels, lap_pe) is packed ONCE and ALIASED
    # across rungs (same guarantee as prepare_node_task_ladder — the
    # elastic upload dedup relies on the shared identity)
    per_rung = [[build_layout(
        gp, bq=bq, bk=bk, k_clusters=k, d_b=d_b, beta_thre=bt,
        n_global=cfg.n_global, chain=True, buckets=True, spd=spd,
        max_spd=cfg.max_spd) for gp, k, spd in invariant]
        for bt in beta_thres]
    S = max(lay.seq_len for lay in per_rung[0])  # seq is rung-invariant
    S = -(-S // max(bq, bk)) * max(bq, bk)
    gps = [gp for gp, _, _ in invariant]
    inv_batch = _pack_graph_invariant(gps, cfg, S)
    out = []
    t_prev = t0
    for layouts in per_rung:
        p = _pack_graph_rung(gps, layouts, inv_batch, cfg, bq, bk,
                             S, report, cut, 0.0,
                             with_dense_buckets=with_dense_buckets)
        now = time.perf_counter()
        p.prep_seconds = now - t_prev  # rung 0 carries the shared prep
        t_prev = now
        out.append(p)
    if seq_pad is None:
        seq_pad = max(p.layout.seq_len for p in out)
    if mb_pad is None:
        mb_pad = max(p.layout.mb for p in out)
    mt_pad = max(p.layout.mt for p in out)
    shared: dict = {}  # keep invariant arrays aliased through the pad
    out = [pad_graph_batch(p, seq_pad, mb_pad, mt_pad, _shared=shared)
           for p in out]
    out[-1].prep_seconds += time.perf_counter() - t_prev  # the pad pass
    return out


def _pack_graph_invariant(gps, cfg, S):
    """The rung-invariant half of a packed graph batch: features, clipped
    degrees, global-token labels and (GT) lap-PE."""
    B = len(gps)
    ng = cfg.n_global
    feat = np.zeros((B, S, cfg.feat_dim), np.float32)
    in_deg = np.zeros((B, S), np.int32)
    out_deg = np.zeros((B, S), np.int32)
    labels = np.full((B, S), -1, np.int32)
    pe = np.zeros((B, S, 8), np.float32) if cfg.name.startswith("gt") \
        else None
    for i, gp in enumerate(gps):
        feat[i, ng:ng + gp.n] = gp.feat
        ind, outd = gp.degrees()
        in_deg[i, ng:ng + gp.n] = degree_clip(ind, cfg.max_degree)
        out_deg[i, ng:ng + gp.n] = degree_clip(outd, cfg.max_degree)
        labels[i, 0] = gp.labels[0]  # graph label (stored on node 0)
        if pe is not None and gp.n > 1:
            pe[i, ng:ng + gp.n] = lap_pe(gp)
    batch = {"feat": feat, "in_deg": in_deg, "out_deg": out_deg,
             "labels": labels}
    if pe is not None:
        batch["lap_pe"] = pe
    return batch


def _pack_graph_rung(gps, layouts, inv_batch, cfg, bq, bk, S, report, cut,
                     prep_seconds, *, with_dense_buckets: bool):
    """One rung's PreparedGraph: the rung-dependent pattern arrays packed
    around the shared (aliased, treat as read-only) invariant batch."""
    B = len(gps)
    mb = max(lay.mb for lay in layouts)
    mt = max((lay.mt for lay in layouts), default=4)
    block_idx = np.full((B, S // bq, mb), -1, np.int32)
    block_idx_t = np.full((B, S // bk, mt, 2), -1, np.int32)
    buckets = np.full((B, S // bq, mb, bq, bk), BUCKET_MASKED, np.int8)
    dense_buckets = np.full((B, S, S), -1, np.int8) \
        if with_dense_buckets else None
    for i, lay in enumerate(layouts):
        nq_i = lay.block_idx.shape[0]
        block_idx[i, :nq_i, :lay.mb] = lay.block_idx
        if lay.block_idx_t is not None:
            block_idx_t[i, :lay.block_idx_t.shape[0], :lay.mt] = \
                lay.block_idx_t
        if lay.buckets is not None:
            buckets[i, :nq_i, :lay.mb] = lay.buckets
        if dense_buckets is not None:
            si = lay.seq_len
            dense_buckets[i, :si, :si] = dense_buckets_from_layout(lay)
    batch = dict(inv_batch)
    batch["block_idx"] = block_idx
    batch["block_idx_t"] = block_idx_t
    batch["buckets"] = buckets
    if dense_buckets is not None:
        batch["dense_buckets"] = dense_buckets
    # batch-level aggregates: counts sum, ratios average, conditions must
    # hold for every graph (one failing graph forces the dense step)
    per = [lay.stats for lay in layouts]
    stats = {"graphs": len(layouts)}
    for key in ("beta_g", "beta_thre", "density"):
        stats[key] = float(np.mean([s[key] for s in per]))
    for key in ("clusters_transferred", "clusters_total", "active_blocks",
                "edges_kept", "edges_dropped"):
        stats[key] = int(sum(s[key] for s in per))
    layout = ClusterLayout(S, bq, bk, block_idx[0], buckets[0],
                           layouts[0].n_buckets, stats,
                           block_idx_t=block_idx_t[0])
    return PreparedGraph(batch, layout, report, cut, prep_seconds)


def pad_graph_batch(prep: PreparedGraph, seq: int, mb: int,
                    mt: int | None = None,
                    *, _shared: dict | None = None) -> PreparedGraph:
    """Pad a multi-graph batch to a fixed (seq, mb[, mt]) shape budget.
    Padding is fully masked (feat 0, labels -1, block_idx/block_idx_t -1,
    buckets BUCKET_MASKED, dense_buckets -1) — numerically a no-op for
    the sparse step and label-masked for the dense one — so every
    mini-batch and every ladder rung of a graph-level task is
    shape-identical, re-layouts and ragged batches included.

    Arrays that need no padding keep their identity, and ``_shared``
    (an id(original) -> padded cache, one dict per ladder) lets arrays
    aliased across rungs stay aliased after padding — the elastic upload
    dedup depends on it."""
    lay = prep.layout
    if mt is None:
        mt = lay.mt
    if seq < lay.seq_len or mb < lay.mb or \
            (lay.block_idx_t is not None and mt < lay.mt):
        raise ValueError(f"pad budget ({seq}, {mb}, {mt}) < layout "
                         f"({lay.seq_len}, {lay.mb}, {lay.mt})")
    if seq % lay.bq or seq % lay.bk:
        raise ValueError(f"seq_pad {seq} not divisible by blocks "
                         f"({lay.bq}, {lay.bk})")
    if seq == lay.seq_len and mb == lay.mb and mt == lay.mt:
        return prep
    ds, dq = seq - lay.seq_len, seq // lay.bq - lay.nq
    dm = mb - lay.mb
    dkb = seq // lay.bk - (lay.seq_len // lay.bk)
    dmt = mt - lay.mt

    def pad(arr, widths, cv=0):
        if not any(w for _, w in widths):
            return arr
        if _shared is not None and id(arr) in _shared:
            return _shared[id(arr)]
        out = np.pad(arr, widths, constant_values=cv)
        if _shared is not None:
            _shared[id(arr)] = out
        return out

    b = prep.batch
    batch = dict(b)
    batch["feat"] = pad(b["feat"], ((0, 0), (0, ds), (0, 0)))
    batch["in_deg"] = pad(b["in_deg"], ((0, 0), (0, ds)))
    batch["out_deg"] = pad(b["out_deg"], ((0, 0), (0, ds)))
    batch["labels"] = pad(b["labels"], ((0, 0), (0, ds)), cv=-1)
    batch["block_idx"] = pad(b["block_idx"],
                             ((0, 0), (0, dq), (0, dm)), cv=-1)
    if "block_idx_t" in b:
        batch["block_idx_t"] = pad(
            b["block_idx_t"], ((0, 0), (0, dkb), (0, dmt), (0, 0)), cv=-1)
    if "buckets" in b:
        batch["buckets"] = pad(
            b["buckets"], ((0, 0), (0, dq), (0, dm), (0, 0), (0, 0)),
            cv=BUCKET_MASKED)
    if "lap_pe" in b:
        batch["lap_pe"] = pad(b["lap_pe"], ((0, 0), (0, ds), (0, 0)))
    if "dense_buckets" in b:
        batch["dense_buckets"] = pad(
            b["dense_buckets"], ((0, 0), (0, ds), (0, ds)), cv=-1)
    layout = ClusterLayout(seq, lay.bq, lay.bk, batch["block_idx"][0],
                           batch.get("buckets", [None])[0], lay.n_buckets,
                           lay.stats,
                           block_idx_t=batch.get("block_idx_t",
                                                 [None])[0])
    return PreparedGraph(batch, layout, prep.report, prep.cut,
                         prep.prep_seconds)
