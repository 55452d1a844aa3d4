"""The port's Cluster-aware Graph Parallelism (``repro_torch.parallel``)
against the JAX package, on the CPU.

* The pure functions (``can_ulysses``, ``can_shard_cluster``, ``_fit_dp``,
  ``recipe_for``, ``cluster_a2a_budget``) equal the reference's over a
  grid, in this process.
* The collectives run in ranks spawned with ``torch.multiprocessing``
  over gloo (a ``file://`` rendezvous under the test's temporary
  directory; each rank on one thread), one world of 2 and one of 4 for
  the whole module. Their local shards are held, in this process, to the
  reference's *single-device* functions on the same numpy inputs, as the
  reference's own sharded tests hold its shard_map paths to its
  single-device oracle: the all-to-all round-trips exactly;
  ``ulysses_attention`` (P = 2, and P = 4 with GQA r = 2) and
  ``seqpar_attention`` (causal, with the query offset) equal
  ``repro.models.layers.chunked_attention``, forward and gradients, fp32
  within 2e-5 (the reference's bound, ``tests/test_distributed.py``);
  ``sharded_cluster_attention`` (per-graph layouts, buckets, a nonzero
  ``bias_table`` sharded by head, ``block_idx_t``) equals
  ``repro.kernels.ops.cluster_attention`` in its reference mode on the
  whole tensors, the output and the gradients of q, k, v and
  ``bias_table`` (summed over the ranks) within 1e-5; its all-to-all
  bytes stay within ``cluster_a2a_budget`` while an all-gather of the
  same tensors (P = 4) exceeds it; shapes that cannot shard raise.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeConfig
from repro_torch.core.reformation import transpose_block_idx
from repro_torch.parallel import cluster_parallel as tcp
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as tsh
from repro_torch.parallel import ulysses as tu

from _torch_cases import graph_layout, per_graph_layout, qkv

TOL_ATTN = 2e-5     # ulysses / seqpar vs chunked_attention (the reference's)
TOL_CLUSTER = 1e-5  # sharded cluster attention vs the reference op


# ------------------------------------------------------------ spawning

def _child(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, world, tmp, *args) -> list:
    """``fn(rank, world, *args)`` in ``world`` gloo ranks; returns each
    rank's returned dict, in rank order."""
    import torch.multiprocessing as mp

    mp.spawn(_child, args=(fn, world, str(tmp), args), nprocs=world,
             join=True)
    return [torch.load(f"{tmp}/rank{r}.pt") for r in range(world)]


def shard(x, rank, world, dim=1):
    n = x.shape[dim] // world
    return x.narrow(dim, rank * n, n)


# ------------------------------------------------------------ the cases

def _attn_case(B, S, H, KV, Dh, seed):
    q, k, v, _ = qkv(B, S, H, KV, Dh, seed=seed)
    g = np.random.default_rng(seed + 7).standard_normal(q.shape).astype(
        np.float32)
    return q, k, v, g


ULYSSES_CASES = {2: (2, 64, 4, 2, 16), 4: (2, 64, 8, 2, 16)}  # P=4: r = 2
SEQPAR_CASE = (2, 64, 3, 3, 16)        # 3 heads: no split two ways


def _cluster_case():
    S, bi, bu, nb = per_graph_layout()
    lays = [graph_layout(seed=s) for s in (1, 2)]
    bits = [transpose_block_idx(x.block_idx, S // x.bk) for x in lays]
    mt = max(b.shape[1] for b in bits)
    bit = np.stack([np.pad(b, ((0, 0), (0, mt - b.shape[1]), (0, 0)),
                           constant_values=-1) for b in bits])
    q, k, v, bias = qkv(2, S, 4, 4, 8, seed=5, n_buckets=nb)
    g = np.random.default_rng(11).standard_normal(q.shape).astype(
        np.float32)
    return q, k, v, bias, bi, bu, bit, g, lays[0].bq


def _local_attn(x, rank, world):
    return shard(torch.from_numpy(x), rank, world).clone().requires_grad_()


def _attn_chunked(causal):
    from repro_torch.models import layers as L
    return lambda a, b, c, off=0: L.chunked_attention(
        a, b, c, causal=causal, chunk_q=16, chunk_k=16, q_offset=off)


def _worker(rank, world):
    """Every collective case of one world; returns this rank's shards."""
    group = dist.group.WORLD
    out = {}
    # the all-to-all and its inverse round-trip exactly
    x = torch.arange(2 * 16 * world * 4 * 3, dtype=torch.float32).reshape(
        2, 16, world * 4, 3) + 1000 * rank
    back = tu.head_to_seq_a2a(tu._seq_to_head(x, group), group=group)
    out["roundtrip"] = bool(torch.equal(back, x))

    q, k, v, g = _attn_case(*ULYSSES_CASES[world], seed=world)
    ql, kl, vl = (_local_attn(a, rank, world) for a in (q, k, v))
    o = tu.ulysses_attention(ql, kl, vl, group=group,
                             attn_fn=_attn_chunked(True))
    (o * shard(torch.from_numpy(g), rank, world)).sum().backward()
    out["ulysses"] = [o.detach(), ql.grad, kl.grad, vl.grad]

    if world == 2:
        q, k, v, g = _attn_case(*SEQPAR_CASE, seed=3)
        ql, kl, vl = (_local_attn(a, rank, world) for a in (q, k, v))
        o = tu.seqpar_attention(ql, kl, vl, group=group,
                                attn_fn=_attn_chunked(True))
        (o * shard(torch.from_numpy(g), rank, world)).sum().backward()
        out["seqpar"] = [o.detach(), ql.grad, kl.grad, vl.grad]

    q, k, v, bias, bi, bu, bit, g, bq = _cluster_case()
    ql, kl, vl = (_local_attn(a, rank, world) for a in (q, k, v))
    table = torch.from_numpy(bias).requires_grad_()
    kw = dict(group=group, bq=bq, bk=bq)
    lay = [torch.from_numpy(a) for a in (bi, bu)]
    o = tcp.sharded_cluster_attention(ql, kl, vl, *lay, table,
                                      torch.from_numpy(bit), **kw)
    (o * shard(torch.from_numpy(g), rank, world)).sum().backward()
    out["cluster"] = [o.detach(), ql.grad, kl.grad, vl.grad, table.grad]
    with torch.no_grad():
        tcp.sharded_cluster_attention(ql, kl, vl, *lay, table, None, **kw)
        out["a2a_bytes"] = tcp.LAST_CALL["a2a_bytes"]
        C.reset_bytes()
        for a in (ql, kl, vl, o):
            C.GatherSeq.apply(a, group)
        out["gather_bytes"] = C.BYTES["all_gather"]
    # a shape that cannot shard raises, naming the shapes
    try:
        tcp.sharded_cluster_attention(ql[:, :-1], kl[:, :-1], vl[:, :-1],
                                      *lay, table, None, **kw)
        out["raised"] = ""
    except ValueError as e:
        out["raised"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each world's ranks' results: ``{2: [...], 4: [...]}``."""
    return {w: spawn(_worker, w, tmp_path_factory.mktemp(f"p{w}"))
            for w in (2, 4)}


# ------------------------------------------------------------ references

def _jax_attn(q, k, v, g, causal=True):
    """The reference's single-device chunked attention and its grads."""
    import jax
    import jax.numpy as jnp

    from repro.models.layers import chunked_attention

    def f(q, k, v):
        o = chunked_attention(q, k, v, causal=causal, chunk_q=16,
                              chunk_k=16)
        return (o * g).sum(), o
    (_, o), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(x) for x in (o, *grads)]


def _jax_cluster(q, k, v, bias, bi, bu, bit, g):
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    def f(q, k, v, b):
        o = jops.cluster_attention(q, k, v, jnp.asarray(bi), jnp.asarray(bu),
                                   b, jnp.asarray(bit), causal=False)
        return (o * g).sum(), o
    (_, o), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                       has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    return [np.asarray(x) for x in (o, *grads)]


def _gathered(results, key, n_seq):
    """The first ``n_seq`` entries of each rank's ``key`` concatenated along
    the sequence (dim 1) in rank order; the rest summed over the ranks."""
    per = [r[key] for r in results]
    out = [np.concatenate([p[i].numpy() for p in per], 1)
           for i in range(n_seq)]
    out += [sum(p[i] for p in per).numpy() for i in range(n_seq, len(per[0]))]
    return out


def _close(got, want, tol, names):
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = np.abs(a - b).max()
        assert err <= tol * max(np.abs(b).max(), 1.0), (name, err)


# ------------------------------------------------------------ pure functions

GRID = [(H, KV, S, p) for H in (3, 4, 8, 9, 16, 32) for KV in (1, 2, 3, 8)
        if H % KV == 0 for S in (224, 256) for p in (1, 2, 4)]


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_shard_predicates_match_reference(p):
    """can_ulysses and can_shard_cluster (bq = bk = 32 and 128) over the
    grid of heads, kv heads and lengths."""
    from repro.parallel import cluster_parallel as jcp
    from repro.parallel import ulysses as jul

    for H, KV, S, _ in GRID:
        assert tu.can_ulysses(H, KV, S, p) == jul.can_ulysses(H, KV, S, p)
        for b in (32, 128):
            assert tcp.can_shard_cluster(H, KV, S, p, b, b) == \
                jcp.can_shard_cluster(H, KV, S, p, b, b), (H, KV, S, p, b)


@pytest.mark.parametrize("shape", [{"data": 2, "model": 4},
                                   {"pod": 2, "data": 2, "model": 2}])
def test_fit_dp_matches_reference(shape):
    from repro.parallel.ulysses import _fit_dp as jfit

    class Mesh:   # the reference reads only mesh.shape
        pass
    m = Mesh()
    m.shape = shape
    for dp in (("data",), ("data", "pod"), ("pod", "data"), ()):
        for b in (1, 2, 3, 4, 8):
            assert tu._fit_dp(dp, shape, b) == jfit(dp, m, b)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("kind,batch", [("train", 8), ("prefill", 8),
                                        ("decode", 8), ("decode", 1)])
def test_recipe_for_matches_reference(kind, batch, multi_pod):
    from repro.configs.base import ShapeConfig as JShape
    from repro.parallel import sharding as jsh

    class Mesh:
        pass
    m = Mesh()
    m.shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}
    for ul in (None, True, False):
        got = tsh.recipe_for(ShapeConfig("s", kind, 4096, batch), m.shape,
                             ulysses=ul)
        want = jsh.recipe_for(JShape("s", kind, 4096, batch), m, ulysses=ul)
        assert (got.name, dict(got.params), dict(got.acts), got.ulysses,
                got.pp_stages) == (want.name, dict(want.params),
                                   dict(want.acts), want.ulysses,
                                   want.pp_stages)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_cluster_a2a_budget_matches_reference(p):
    from repro.parallel.cluster_parallel import cluster_a2a_budget as jb

    for q_shape, k_shape in (((1, 8192, 32, 24), (1, 8192, 32, 24)),
                             ((2, 16384, 16, 128), (2, 16384, 8, 128))):
        for nbytes in (2, 4):
            for slack in (1.0, 2.0):
                assert tcp.cluster_a2a_budget(
                    q_shape, k_shape, nbytes, p, slack=slack) == \
                    jb(q_shape, k_shape, nbytes, p, slack=slack)


# ------------------------------------------------------------ collectives

@pytest.mark.parametrize("world", [2, 4])
def test_all_to_all_round_trips(ranks, world):
    assert all(r["roundtrip"] for r in ranks[world])


@pytest.mark.parametrize("world", [2, 4])
def test_ulysses_attention_matches_chunked_attention(ranks, world):
    """P = 2 (MHA-grouped: 4 heads over 2) and P = 4 (8 heads over 2: the
    kv heads repeated twice before the all-to-all): the output and the
    gradients of q, k, v."""
    q, k, v, g = _attn_case(*ULYSSES_CASES[world], seed=world)
    _close(_gathered(ranks[world], "ulysses", 4), _jax_attn(q, k, v, g),
           TOL_ATTN, ("o", "dq", "dk", "dv"))


def test_seqpar_attention_matches_chunked_attention(ranks):
    """Causal, each rank's queries at their global offset, against the
    all-gathered keys: the output and the gradients (k and v through the
    gather's reduce-scatter)."""
    q, k, v, g = _attn_case(*SEQPAR_CASE, seed=3)
    _close(_gathered(ranks[2], "seqpar", 4), _jax_attn(q, k, v, g),
           TOL_ATTN, ("o", "dq", "dk", "dv"))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_cluster_attention_matches_reference(ranks, world):
    """Per-graph layouts (B = 2), buckets, a nonzero bias table sharded by
    head and the transposed layout: the output and the gradients of q,
    k, v and the whole table (each rank's rows, summed)."""
    q, k, v, bias, bi, bu, bit, g, _ = _cluster_case()
    _close(_gathered(ranks[world], "cluster", 4),
           _jax_cluster(q, k, v, bias, bi, bu, bit, g), TOL_CLUSTER,
           ("o", "dq", "dk", "dv", "dbias"))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_cluster_a2a_bytes_within_budget(ranks, world):
    """A forward hands its all-to-alls at most ``cluster_a2a_budget``
    bytes; at P = 4 an all-gather of the same q, k, v and o exceeds it."""
    q, k, *_ = _cluster_case()
    budget = tcp.cluster_a2a_budget(q.shape, k.shape, 4, world)
    for r in ranks[world]:
        assert 0 < r["a2a_bytes"] <= budget, (r["a2a_bytes"], budget)
        if world == 4:
            assert r["gather_bytes"] > budget, (r["gather_bytes"], budget)


def test_sharded_cluster_attention_refuses_unshardable_shapes(ranks):
    for r in ranks[2]:
        assert "cannot shard" in r["raised"] and "S=222" in r["raised"], \
            r["raised"]


def test_axis_rules_reach_other_threads():
    """The context is process-wide: on the card autograd runs the backward
    (and a checkpointed layer's recomputation) on its device thread."""
    import threading

    from repro_torch.parallel import axes as tax

    seen = []
    with tax.axis_rules("recipe", {"data": 1, "model": 2}):
        th = threading.Thread(target=lambda: seen.append(tax.current()))
        th.start()
        th.join()
    assert seen == [("recipe", {"data": 1, "model": 2})]
    assert tax.current() is None


@pytest.mark.parametrize("multi_pod", [False, True])
def test_mesh_axis_size_matches_reference(multi_pod):
    from repro.configs.base import ShapeConfig as JShape
    from repro.parallel import axes as jax_axes
    from repro.parallel import sharding as jsh
    from repro_torch.parallel import axes as tax

    class Mesh:
        pass
    m = Mesh()
    m.shape = {"pod": 2, "data": 4, "model": 8} if multi_pod else \
        {"data": 4, "model": 8}
    for kind, batch in (("train", 8), ("prefill", 8), ("decode", 1)):
        want_recipe = jsh.recipe_for(JShape("s", kind, 4096, batch), m)
        recipe = tsh.recipe_for(ShapeConfig("s", kind, 4096, batch), m.shape)
        for axes in (("batch",), ("seq",), ("seq_outer",), ("heads",),
                     ("batch", "seq"), ("embed",)):
            with jax_axes.axis_rules(want_recipe, m):
                want = jax_axes.mesh_axis_size(*axes)
            with tax.axis_rules(recipe, m.shape):
                assert tax.mesh_axis_size(*axes) == want, (kind, axes)
    assert tax.mesh_axis_size("seq") == 1


def test_mesh_entry_points_refuse_what_they_cannot_run():
    """Without a process group there is no mesh; a mesh needs a recipe
    and a backend; sequence-sharded prefill (``return_kv`` under a
    sequence-sharding recipe, which no entry point runs here or in the
    reference) and a task without a mesh form refuse one."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train as train_cli
    from repro_torch.models.lm import LMModel, lm_forward
    from repro_torch.parallel.axes import axis_rules
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tasks import Task

    class Mesh:      # a (1, 2) mesh's shape; no group is ever reached
        mesh_dim_names, shape = ("data", "model"), (1, 2)

        def get_group(self, name):
            return object()

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        lmesh.make_host_mesh(model=2)
    with pytest.raises(ValueError, match="recipe"):
        Trainer(None, TrainerConfig(), task=None, mesh={"model": 2})
    argv = ["--arch", "gt", "--smoke", "--steps", "1", "--device", "cpu",
            "--mesh-model", "2"]
    with pytest.raises(ValueError, match="--backend"):
        train_cli.main(argv)
    model = LMModel(get_smoke_config("qwen3_0_6b"), device="cpu")
    recipe = tsh.recipe_for(ShapeConfig("t", "train", 8, 1), Mesh())
    with axis_rules(recipe, Mesh()), \
            pytest.raises(ValueError, match="sequence-sharded prefill"):
        lm_forward(model, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                   return_kv=True)
    with pytest.raises(ValueError, match="no mesh form"):
        Task().prepare(None, {"model": 2}, object())
