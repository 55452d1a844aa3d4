"""The cluster op's schedule in the port, on the CPU: the two dataflow
rewrites of the reference's cluster kernels (``hoist_scale``,
``fuse_bias``) and its oracle's q-row chunking (``row_chunk``), as
``kernels/ops.cluster_attention`` resolves them from the winner table.

* For each of the reference's three rewrite schedules
  (``tests/test_tune.py``'s) and each ``row_chunk`` in {4, 8, 16}, the
  port's plain op against the reference's ``ops.cluster_attention`` under
  the same installed schedule: with the Pallas kernels in interpret mode
  (they apply the rewrites; the reference's kernel path does not read
  ``row_chunk``), and in its jnp-reference mode (which applies
  ``row_chunk``). Output and the gradients of q, k, v and ``bias_table``
  in fp32 within ``atol = rtol = 1e-5`` elementwise (sums in other
  orders). The layouts carry every bucket of the table, the global
  token's virtual distance ``max_spd + 1`` included, and masked entries;
  one has a q-block row whose every entry is masked, which must stay
  dead (O = 0) under the fused sentinel as under the select.
* The unbiased causal op (the LM's) under ``hoist_scale``, the same way.
* Dispatch: an installed table's winner reaches the forward and the
  backward; ``fuse_bias`` only where there are buckets.
* The sharded op on two gloo ranks with both rewrites resolved in every
  rank, against the unsharded plain op without them.
* The enumerator's cluster candidates equal the reference's on the
  reference's default case.

The mesh test's ranks import this module by name, so the JAX package is
imported inside the functions that use it (:func:`_jax`), never at the
top: the ranks never load JAX.
"""

import types
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core.encodings import spd_matrix
from repro_torch.core.graph import sbm_graph
from repro_torch.core.reformation import (build_layout,
                                          lm_local_global_layout,
                                          transpose_block_idx)
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.tune import runtime as rt
from repro_torch.tune import search
from repro_torch.tune.schedule import (Schedule, enumerate_schedules,
                                       shape_bucket)
from repro_torch.tune.table import WinnerTable

from _torch_cases import qkv, t

TOL = 1e-5
NAMES = ("o", "dq", "dk", "dv", "dbias")
# the reference's three rewrite schedules (tests/test_tune.py)
REWRITES = {"hoist": dict(hoist_scale=True), "fuse": dict(fuse_bias=True),
            "both": dict(hoist_scale=True, fuse_bias=True)}
ROW_CHUNKS = (4, 8, 16)


def _jax():
    """The JAX package's modules these tests use."""
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops
    from repro.tune import runtime, schedule, search as jsearch
    from repro.tune.table import WinnerTable as JWinnerTable
    return types.SimpleNamespace(jax=jax, jnp=jnp, ops=ops, rt=runtime,
                                 schedule=schedule, search=jsearch,
                                 WinnerTable=JWinnerTable)


@pytest.fixture
def jax_mode():
    """Sets the JAX dispatch mode of cluster_attention; restores auto."""
    jops = _jax().ops

    def set_mode(mode):
        jops.set_mode(mode, "cluster_attention")
    yield set_mode
    jops.set_mode("auto", "cluster_attention")


def _installed(sched: Schedule, bucket: str):
    """The one-entry winner tables of both packages for ``bucket``."""
    J = _jax()
    mine = WinnerTable(backend="cpu")
    mine.put(bucket, sched, source="test")
    theirs = J.WinnerTable(backend="cpu")
    theirs.put(bucket, J.schedule.Schedule.from_json(sched.to_json()),
               source="test")
    return rt.use_table(mine), J.rt.use_table(theirs)


def _spd_layout():
    """A 190-node SBM graph in SPD bucket mode (distances 0..3, 4 the
    global token's virtual distance) with every edge kept exactly: 12
    q-block rows of 16 (row chunks of 4, 6 and 12 rows), 140 of 144
    blocks visited."""
    g = sbm_graph(190, 4, 0.03, 0.002, seed=1)
    return build_layout(g, bq=16, bk=16, k_clusters=4, d_b=8, n_global=1,
                        beta_thre=0.0, spd=spd_matrix(g, max_spd=3),
                        max_spd=3)


def _biased_case(dead_row: bool):
    """:func:`_spd_layout` over B = 2 copies, GQA 4 over 2 heads, Dh = 8
    (a scale no power of two), a bias table over every bucket; with
    ``dead_row`` one q-block row masked entirely."""
    lay = _spd_layout()
    bu = lay.buckets.copy()
    if dead_row:
        bu[5] = -1
    nb = lay.n_buckets
    q, k, v, bias = qkv(2, lay.seq_len, 4, 2, 8, seed=7, n_buckets=nb)
    g = np.random.default_rng(8).standard_normal(q.shape).astype(
        np.float32)
    return lay, bu, q, k, v, bias, g


def test_the_cases_carry_every_bucket_and_a_dead_row():
    lay, bu, *_ = _biased_case(True)
    seen = set(np.unique(lay.buckets[lay.block_idx >= 0]).tolist())
    assert lay.nq == 12 and (lay.block_idx < 0).any()
    assert seen == {-1, *range(lay.n_buckets)}, (seen, lay.n_buckets)
    assert lay.n_buckets - 1 in seen            # max_spd + 1, the global
    assert (bu[5][lay.block_idx[5] >= 0] == -1).all()


def _jax_out_grads(q, k, v, bias, bi, bu, bit, g, *, causal=False):
    J = _jax()
    jax, jnp, jops = J.jax, J.jnp, J.ops
    bi_, bit_ = jnp.asarray(bi), jnp.asarray(bit)
    bu_ = None if bu is None else jnp.asarray(bu)

    def loss(q, k, v, b):
        o = jops.cluster_attention(q, k, v, bi_, bu_, b, bit_,
                                   causal=causal)
        return (o * g).sum(), o
    args = [jnp.asarray(x) for x in (q, k, v)]
    argnums = (0, 1, 2)
    if bu is not None:
        args.append(jnp.asarray(bias))
        argnums = (0, 1, 2, 3)
    else:
        args.append(None)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        (_, o), grads = jax.value_and_grad(loss, argnums=argnums,
                                           has_aux=True)(*args)
    fell_back = [w for w in rec if "falling back" in str(w.message)]
    assert not fell_back, fell_back[0].message
    return [np.asarray(o)] + [np.asarray(x) for x in grads]


def _port_out_grads(q, k, v, bias, bi, bu, bit, g, *, causal=False):
    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    table = None
    if bu is not None:
        table = t(bias).requires_grad_()
        leaves.append(table)
    o = tops.cluster_attention(*leaves[:3], t(bi),
                               None if bu is None else t(bu), table,
                               t(bit), causal=causal)
    (o * t(g)).sum().backward()
    return [o.detach().numpy()] + [x.grad.numpy() for x in leaves]


def _close(got, want, tol=TOL):
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("mode", ["interpret", "ref"])
@pytest.mark.parametrize("row_chunk", ROW_CHUNKS)
@pytest.mark.parametrize("rewrite", sorted(REWRITES))
def test_plain_op_matches_reference_under_each_schedule(
        jax_mode, rewrite, row_chunk, mode):
    """The biased op, every rewrite schedule at every row chunk, against
    the reference's op under the same installed schedule: the Pallas
    kernels in interpret mode, or the jnp reference."""
    lay, bu, q, k, v, bias, g = _biased_case(dead_row=False)
    sched = Schedule("cluster_attention", row_chunk=row_chunk,
                     **REWRITES[rewrite])
    bucket = shape_bucket("cluster_attention", seq_len=lay.seq_len,
                          heads=4, d_head=8, dtype="float32")
    mine, theirs = _installed(sched, bucket)
    jax_mode(mode)
    with mine, theirs:
        want = _jax_out_grads(q, k, v, bias, lay.block_idx, bu,
                              lay.block_idx_t, g)
        got = _port_out_grads(q, k, v, bias, lay.block_idx, bu,
                              lay.block_idx_t, g)
    _close(got, want)


@pytest.mark.parametrize("fuse", [False, True])
def test_a_dead_row_stays_dead_under_each_bias_lookup(jax_mode, fuse):
    """A q-block row with every entry masked writes O = 0 and no
    gradient, through the sentinel column as through the select, and
    equals the reference's Pallas kernels under the same schedule."""
    lay, bu, q, k, v, bias, g = _biased_case(dead_row=True)
    sched = Schedule("cluster_attention", row_chunk=4, hoist_scale=True,
                     fuse_bias=fuse)
    bucket = shape_bucket("cluster_attention", seq_len=lay.seq_len,
                          heads=4, d_head=8, dtype="float32")
    mine, theirs = _installed(sched, bucket)
    jax_mode("interpret")
    with mine, theirs:
        want = _jax_out_grads(q, k, v, bias, lay.block_idx, bu,
                              lay.block_idx_t, g)
        got = _port_out_grads(q, k, v, bias, lay.block_idx, bu,
                              lay.block_idx_t, g)
    _close(got, want)
    rows = slice(5 * lay.bq, 6 * lay.bq)
    assert not got[0][:, rows].any() and not got[1][:, rows].any()
    with torch.no_grad():
        o, lse = tref.cluster_sparse_attention(
            t(q), t(k), t(v), t(lay.block_idx), t(bu), t(bias),
            return_lse=True, fuse_bias=fuse, hoist_scale=True, row_chunk=4)
    assert not lse.view(2, 4, -1)[:, :, rows].any()


@pytest.mark.parametrize("row_chunk", ROW_CHUNKS)
def test_unbiased_causal_op_matches_reference_under_hoist_scale(
        jax_mode, row_chunk):
    """The LM's unbiased causal op (rows 2, 5, 6) under ``hoist_scale``
    and each row chunk, against the reference's Pallas kernels in
    interpret mode under the same schedule (a table that asks for
    ``fuse_bias`` too: the unbiased op has no table, so neither package
    applies it)."""
    lay = lm_local_global_layout(256, bq=32, bk=32, window=64, n_global=32)
    q, k, v, _ = qkv(2, lay.seq_len, 4, 2, 8, seed=4)
    g = np.random.default_rng(5).standard_normal(q.shape).astype(
        np.float32)
    sched = Schedule("cluster_attention", row_chunk=row_chunk,
                     hoist_scale=True, fuse_bias=True)
    bucket = shape_bucket("cluster_attention", seq_len=lay.seq_len,
                          heads=4, d_head=8, dtype="float32")
    mine, theirs = _installed(sched, bucket)
    jax_mode("interpret")
    with mine, theirs:
        want = _jax_out_grads(q, k, v, None, lay.block_idx, None,
                              lay.block_idx_t, g, causal=True)
        got = _port_out_grads(q, k, v, None, lay.block_idx, None,
                              lay.block_idx_t, g, causal=True)
    _close(got, want)


def test_row_chunk_rows_is_the_largest_divisor():
    assert [tref.row_chunk_rows(12, rc) for rc in (4, 8, 16)] == [4, 6, 12]
    assert [tref.row_chunk_rows(7, rc) for rc in (4, 8, 16)] == [1, 7, 7]


def test_passes_take_whole_row_chunks_under_the_entry_bound(monkeypatch):
    """A pass takes whole row chunks while they fit under the entry bound
    and cuts a chunk above it; every active block lands in one pass, in
    row order."""
    rows = torch.tensor([0, 0, 1, 2, 2, 2, 3, 5, 5, 4, 4, 4, 4, 4, 4])
    monkeypatch.setattr(tref, "MAX_CHUNK_ENTRIES", 4)
    order, passes = tref._passes(rows, 6, 2, 1)
    key = (rows[order] // 2).tolist()
    assert key == sorted(key)
    sizes = [s.stop - s.start for s in passes]
    assert sum(sizes) == rows.numel() and max(sizes) <= 4
    for s in passes:           # a pass is one chunk, or whole chunks
        ks = key[s]
        if len(set(ks)) > 1:
            assert s.start == 0 or key[s.start - 1] != ks[0]
            assert s.stop == len(key) or key[s.stop] != ks[-1]
    assert tref._passes(rows, 6, None, 1)[0] is None


# -------------------------------------------------------------- dispatch

def _spy(monkeypatch):
    """Records the schedule keywords of the plain forward and backward."""
    seen = {"fwd": [], "bwd": []}
    fwd, bwd = tref.cluster_sparse_attention, tref.cluster_attention_bwd

    def f(*a, **kw):
        seen["fwd"].append((kw["hoist_scale"], kw["fuse_bias"],
                            kw["row_chunk"]))
        return fwd(*a, **kw)

    def b(*a, **kw):
        seen["bwd"].append((kw["hoist_scale"], kw["fuse_bias"],
                            kw["row_chunk"]))
        return bwd(*a, **kw)
    monkeypatch.setattr(tref, "cluster_sparse_attention", f)
    monkeypatch.setattr(tref, "cluster_attention_bwd", b)
    return seen


def test_an_installed_winner_reaches_forward_and_backward(monkeypatch):
    lay, bu, q, k, v, bias, g = _biased_case(dead_row=False)
    seen = _spy(monkeypatch)
    bucket = shape_bucket("cluster_attention", seq_len=lay.seq_len,
                          heads=4, d_head=8, dtype="float32")
    win = Schedule("cluster_attention", row_chunk=4, hoist_scale=True,
                   fuse_bias=True)
    mine, _ = _installed(win, bucket)
    with mine:
        _port_out_grads(q, k, v, bias, lay.block_idx, bu, lay.block_idx_t,
                        g)
        with torch.no_grad():       # the forward-only path
            tops.cluster_attention(t(q), t(k), t(v), t(lay.block_idx),
                                   t(bu), t(bias))
    _port_out_grads(q, k, v, bias, lay.block_idx, bu, lay.block_idx_t, g)
    assert seen["fwd"] == [(True, True, 4), (True, True, 4),
                           (False, False, 8)]
    assert seen["bwd"] == [(True, True, 4), (False, False, 8)]


def test_fuse_bias_needs_buckets(monkeypatch):
    lay = lm_local_global_layout(256, bq=32, bk=32, window=64, n_global=32)
    q, k, v, _ = qkv(1, lay.seq_len, 4, 2, 8, seed=1)
    seen = _spy(monkeypatch)
    bucket = shape_bucket("cluster_attention", seq_len=lay.seq_len,
                          heads=4, d_head=8, dtype="float32")
    mine, _ = _installed(Schedule("cluster_attention", row_chunk=8,
                                  hoist_scale=True, fuse_bias=True), bucket)
    with mine, torch.no_grad():
        tops.cluster_attention(t(q), t(k), t(v), t(lay.block_idx),
                               causal=True)
    assert seen["fwd"] == [(True, False, 8)]


def test_the_schedule_is_resolved_once_per_shape(monkeypatch):
    """The winner-table lookup is memoised per shape, device and
    generation: repeated calls on one shape look the table up once."""
    lay, bu, q, k, v, bias, _ = _biased_case(dead_row=False)
    calls = []
    lookup = rt.lookup
    monkeypatch.setattr(rt, "lookup",
                        lambda *a, **kw: calls.append(a) or lookup(*a, **kw))
    with rt.use_table(None), torch.no_grad():
        for _ in range(3):
            tops.cluster_attention(t(q), t(k), t(v), t(lay.block_idx),
                                   t(bu), t(bias))
    assert len(calls) == 1


# ------------------------------------------------------------ the mesh

def _child(rank, world, tmp, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    try:
        out = _sharded_rank(rank, world, *args)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _mesh_case():
    lay = _spd_layout()
    q, k, v, bias = qkv(1, lay.seq_len, 4, 4, 8, seed=9,
                        n_buckets=lay.n_buckets)
    g = np.random.default_rng(10).standard_normal(q.shape).astype(
        np.float32)
    bit = transpose_block_idx(lay.block_idx, lay.seq_len // lay.bk)
    return lay, q, k, v, bias, bit, g


def _sharded_rank(rank, world):
    """Both rewrites resolved in this rank (the op default of this
    process); returns this rank's output and gradient shards and the
    schedules the plain forward and backward ran under."""
    from repro_torch.parallel import cluster_parallel as tcp
    from repro_torch.tune import schedule as ts

    ts.DEFAULT_SCHEDULES["cluster_attention"] = ts.Schedule(
        "cluster_attention", row_chunk=8, hoist_scale=True, fuse_bias=True)
    seen = {"fwd": [], "bwd": []}
    fwd, bwd = tref.cluster_sparse_attention, tref.cluster_attention_bwd
    tref.cluster_sparse_attention = lambda *a, **kw: (
        seen["fwd"].append((kw["hoist_scale"], kw["fuse_bias"]))
        or fwd(*a, **kw))
    tref.cluster_attention_bwd = lambda *a, **kw: (
        seen["bwd"].append((kw["hoist_scale"], kw["fuse_bias"]))
        or bwd(*a, **kw))
    lay, q, k, v, bias, bit, g = _mesh_case()
    n = q.shape[1] // world
    local = [torch.from_numpy(x).narrow(1, rank * n, n).clone()
             .requires_grad_() for x in (q, k, v)]
    table = torch.from_numpy(bias).requires_grad_()
    o = tcp.sharded_cluster_attention(
        *local, torch.from_numpy(lay.block_idx),
        torch.from_numpy(lay.buckets), table, torch.from_numpy(bit),
        group=dist.group.WORLD, bq=lay.bq, bk=lay.bk)
    (o * torch.from_numpy(g).narrow(1, rank * n, n)).sum().backward()
    return {"out": [o.detach()] + [x.grad for x in local] + [table.grad],
            "seen": seen}


def test_sharded_op_with_both_rewrites_matches_unsharded_plain(tmp_path):
    """Two gloo ranks, ``hoist_scale`` and ``fuse_bias`` resolved in each:
    the gathered output and gradients (the table's summed over the ranks)
    equal the unsharded plain op's without either rewrite."""
    import torch.multiprocessing as mp

    world = 2
    mp.spawn(_child, args=(world, str(tmp_path), ()), nprocs=world,
             join=True)
    ranks = [torch.load(f"{tmp_path}/rank{r}.pt") for r in range(world)]
    for r in ranks:
        assert r["seen"]["fwd"] and set(r["seen"]["fwd"]) == {(True, True)}
        assert r["seen"]["bwd"] and set(r["seen"]["bwd"]) == {(True, True)}
    got = [torch.cat([r["out"][i] for r in ranks], dim=1).numpy()
           for i in range(4)]
    got.append(sum(r["out"][4] for r in ranks).numpy())
    lay, q, k, v, bias, bit, g = _mesh_case()
    with rt.use_table(None):
        want = _port_out_grads(q, k, v, bias, lay.block_idx, lay.buckets,
                               bit, g)
    _close(got, want)


# ------------------------------------------------------------ the tuner

def test_enumerator_matches_reference_on_its_default_case():
    J = _jax()
    ref_case = J.search.default_case("cluster_attention")
    our_case = search.default_case("cluster_attention", device="cpu")
    theirs = [c.to_json() for c in J.schedule.enumerate_schedules(
        "cluster_attention", ref_case)]
    ours = [c.to_json() for c in enumerate_schedules("cluster_attention",
                                                     our_case)]
    assert len(ours) == 12
    assert ours == theirs
