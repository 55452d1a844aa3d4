"""The port's host-side modules (numpy copies of the JAX package's) give
the same arrays, byte for byte, as the reference: SBM generation, cluster
reorder, condition checks, encodings, the reformation layout and the
node-task batch."""

import numpy as np
import pytest

import repro.configs as jcfgs
from repro.core import auto_tuner as j_tuner
from repro.core import conditions as j_cond
from repro.core import encodings as j_enc
from repro.core import graph as j_graph
from repro.core import reformation as j_ref
from repro.data import graph_pipeline as j_pipe
from repro_torch.configs import get_smoke_config
from repro_torch.core import auto_tuner, conditions, encodings, graph
from repro_torch.core import reformation
from repro_torch.data import graph_pipeline

BATCH_KEYS = ("block_idx", "block_idx_t", "buckets", "feat", "in_deg",
              "out_deg", "labels")


def _graphs(n, clusters, seed):
    cfg = get_smoke_config("graphormer_slim")
    kw = dict(feat_dim=cfg.feat_dim, n_classes=cfg.n_classes, seed=seed)
    return (graph.sbm_graph(n, clusters, 0.08, 0.004, **kw),
            j_graph.sbm_graph(n, clusters, 0.08, 0.004, **kw))


def _same_array(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_prep(a, b):
    for key in BATCH_KEYS:
        _same_array(a.batch[key], b.batch[key])
    _same_array(a.perm, b.perm)
    assert set(a.batch) == set(b.batch)
    assert a.layout.stats == b.layout.stats
    assert (a.layout.seq_len, a.layout.bq, a.layout.bk,
            a.layout.n_buckets) == (b.layout.seq_len, b.layout.bq,
                                    b.layout.bk, b.layout.n_buckets)
    assert a.cut == b.cut
    assert vars(a.report) == vars(b.report)


@pytest.mark.parametrize("bq,bk,d_b", [(32, 32, 8), (64, 64, 16)])
@pytest.mark.parametrize("n,clusters,seed", [(96, 4, 0), (200, 4, 1),
                                             (448, 8, 2)])
def test_prepare_node_task_byte_identical(n, clusters, seed, bq, bk, d_b):
    g, jg = _graphs(n, clusters, seed)
    for x, y in ((g.src, jg.src), (g.dst, jg.dst), (g.feat, jg.feat),
                 (g.labels, jg.labels)):
        _same_array(x, y)
    cfg = get_smoke_config("graphormer_large")
    jcfg = jcfgs.get_smoke_config("graphormer_large")
    _same_prep(graph_pipeline.prepare_node_task(g, cfg, bq=bq, bk=bk,
                                                d_b=d_b),
               j_pipe.prepare_node_task(jg, jcfg, bq=bq, bk=bk, d_b=d_b))


def test_ladder_train_mask_and_padding_identical():
    g, jg = _graphs(200, 4, 3)
    cfg = get_smoke_config("graphormer_slim")
    jcfg = jcfgs.get_smoke_config("graphormer_slim")
    mask = np.random.default_rng(0).random(g.n) < 0.5
    ladder = [None, 0.0, 0.05, 1.0]
    mine = graph_pipeline.prepare_node_task_ladder(
        g, cfg, ladder, bq=32, bk=32, d_b=8, train_mask=mask)
    ref = j_pipe.prepare_node_task_ladder(
        jg, jcfg, ladder, bq=32, bk=32, d_b=8, train_mask=mask)
    for a, b in zip(mine, ref, strict=True):
        _same_prep(a, b)
        mb, mt = a.layout.mb + 4, a.layout.mt + 8
        _same_prep(graph_pipeline.pad_layout_mb(a, mb, mt),
                   j_pipe.pad_layout_mb(b, mb, mt))


def test_spd_buckets_identical():
    g, jg = _graphs(96, 4, 4)
    cfg = get_smoke_config("graphormer_slim").replace(graph_bias="spd")
    jcfg = jcfgs.get_smoke_config("graphormer_slim").replace(
        graph_bias="spd")
    _same_array(encodings.spd_matrix(g, 6), j_enc.spd_matrix(jg, 6))
    _same_prep(graph_pipeline.prepare_node_task(g, cfg, bq=32, bk=32,
                                                d_b=8),
               j_pipe.prepare_node_task(jg, jcfg, bq=32, bk=32, d_b=8))


def test_layout_helpers_identical():
    g, jg = _graphs(200, 4, 5)
    a = reformation.build_layout(g, bq=32, bk=32, k_clusters=4, d_b=8,
                                 beta_thre=0.02)
    b = j_ref.build_layout(jg, bq=32, bk=32, k_clusters=4, d_b=8,
                           beta_thre=0.02)
    _same_array(a.block_idx, b.block_idx)
    _same_array(a.buckets, b.buckets)
    _same_array(reformation.transpose_block_idx(a.block_idx, a.nq),
                j_ref.transpose_block_idx(b.block_idx, b.nq))
    ra, ca, sa = reformation.augment_edges(g, 2, True)
    rb, cb, sb = j_ref.augment_edges(jg, 2, True)
    _same_array(ra, rb)
    _same_array(ca, cb)
    assert sa == sb
    assert (reformation.BUCKET_MASKED, reformation.BUCKET_SELF,
            reformation.BUCKET_EDGE, reformation.BUCKET_FILL,
            reformation.N_BUCKETS_ADJ) == (
        j_ref.BUCKET_MASKED, j_ref.BUCKET_SELF, j_ref.BUCKET_EDGE,
        j_ref.BUCKET_FILL, j_ref.N_BUCKETS_ADJ)
    assert vars(conditions.check_conditions(g, 2)) == \
        vars(j_cond.check_conditions(jg, 2))
    _same_array(encodings.degree_clip(np.arange(20), 7),
                j_enc.degree_clip(np.arange(20), 7))


@pytest.mark.parametrize("bq", [8, 32, 128])
def test_choose_cluster_dim_identical(bq):
    for seq in (96, 1000, 32769, 10 ** 6):
        for d_model in (32, 64, 768):
            assert auto_tuner.choose_cluster_dim(seq, d_model, bq) == \
                j_tuner.choose_cluster_dim(seq, d_model, bq)


@pytest.mark.parametrize("n,m,seed", [(60, 2, 0), (200, 4, 1)])
def test_powerlaw_graph_identical(n, m, seed):
    a = graph.powerlaw_graph(n, m, feat_dim=8, n_classes=3, seed=seed)
    b = j_graph.powerlaw_graph(n, m, feat_dim=8, n_classes=3, seed=seed)
    assert a.n == b.n
    for x, y in ((a.src, b.src), (a.dst, b.dst), (a.feat, b.feat),
                 (a.labels, b.labels)):
        _same_array(x, y)


@pytest.mark.parametrize("kind", ["sbm", "powerlaw", "tiny"])
def test_lap_pe_identical(kind):
    """GT's Laplacian eigenvectors, the port's copy against the
    reference's on this machine's LAPACK (eigenvector signs are the
    library's); ``tiny`` has fewer than 8 non-trivial eigenvectors, so
    the encoding is zero-padded."""
    if kind == "sbm":
        g, jg = _graphs(96, 4, 6)
    elif kind == "powerlaw":
        g, jg = (graph.powerlaw_graph(80, 3, seed=2),
                 j_graph.powerlaw_graph(80, 3, seed=2))
    else:
        g, jg = (graph.powerlaw_graph(5, 1, seed=3),
                 j_graph.powerlaw_graph(5, 1, seed=3))
    pe = encodings.lap_pe(g)
    assert pe.shape == (g.n, 8)
    _same_array(pe, j_enc.lap_pe(jg))


@pytest.mark.parametrize("n,clusters,seed", [(96, 4, 0), (200, 4, 1)])
def test_gt_node_prep_lap_pe_identical(n, clusters, seed):
    """The GT branch of the node prep adds the Laplacian encodings at the
    node positions (zeros at the global token and the padding), shared by
    every rung, byte for byte as the reference."""
    g, jg = _graphs(n, clusters, seed)
    cfg = get_smoke_config("gt")
    jcfg = jcfgs.get_smoke_config("gt")
    ladder = [None, 0.0, 1.0]
    mine = graph_pipeline.prepare_node_task_ladder(g, cfg, ladder, bq=32,
                                                   bk=32, d_b=8)
    ref = j_pipe.prepare_node_task_ladder(jg, jcfg, ladder, bq=32, bk=32,
                                          d_b=8)
    for a, b in zip(mine, ref, strict=True):
        _same_prep(a, b)
        _same_array(a.batch["lap_pe"], b.batch["lap_pe"])
        assert a.batch["lap_pe"] is mine[0].batch["lap_pe"]
    pe = mine[0].batch["lap_pe"][0]
    assert not pe[:cfg.n_global].any() and not pe[cfg.n_global + g.n:].any()
    assert "lap_pe" not in graph_pipeline.prepare_node_task(
        g, get_smoke_config("graphormer_slim"), bq=32, bk=32).batch
