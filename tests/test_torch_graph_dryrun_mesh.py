"""The paper's scale run on a mesh, on the CPU: ``graph_dryrun.run(
mesh_model=2)`` on two gloo ranks against one process, on the mask-free
path. Its attention goes through ``sharded_cluster_attention``'s
no-buckets branch (``core/graph_model._sharded_sparse``: ``bk = bq``),
which the mesh slices ran only with buckets.

Ranks are spawned with ``torch.multiprocessing`` over gloo (a
``file://`` rendezvous under the test's temporary directory), each rank
on its share of this worker's threads. This module imports no JAX: the
ranks import it.

Tolerances (the sequence's sums split over two ranks): in fp32 the loss
at init within 1e-5 relative and every gradient within 1e-4 of the
largest entry of the one-process gradient; the two bf16 steps' losses
of ``run`` within 1e-4 relative (their gradients sum in another order
before the first update).
"""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import graph_model as tgm
from repro_torch.launch import graph_dryrun as gd

from test_torch_threads import worker_share

TOL_RUN = 1e-4   # the bf16 run's losses: another sum order of its grads


def _child(rank, world, tmp, threads, fn, args):
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    try:
        torch.save(fn(*args), f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _mesh_run(S, mb):
    """Loss and gradients at init, then a two-step ``run``, on this
    rank's shard; counts the sharded op's calls."""
    calls = []
    real = tgm.sharded_cluster_attention

    def seen(*a, **kw):
        calls.append(kw.get("bq"))
        return real(*a, **kw)
    tgm.sharded_cluster_attention = seen
    try:
        return _one(S, mb, dist.get_world_size()), calls
    finally:
        tgm.sharded_cluster_attention = real


def _one(S, mb, p):
    from repro_torch.launch import mesh as lmesh
    from repro_torch.parallel import axes as pax
    from repro_torch.parallel.sharding import recipe_for
    from repro_torch.configs import ShapeConfig
    from repro_torch.tasks.base import shard_rows

    cfg = gd.scale_config("graphormer_slim", smoke=True)
    batch = gd.graph_batch(cfg, S, mb=mb, seed=6)
    model = tgm.GraphModel(cfg.replace(dtype="float32"), device="cpu")
    if p > 1:
        mesh = lmesh.make_host_mesh(model=p, data=1)
        recipe = recipe_for(ShapeConfig("g", "train", S, 1), mesh)
        part = {k: shard_rows(v, mesh, seq_dim=k in gd.SEQ_KEYS)
                .contiguous() for k, v in batch.items()}
        with pax.axis_rules(recipe, mesh):
            loss, _, grads = gd.loss_and_grads(model, part)
    else:
        loss, _, grads = gd.loss_and_grads(model, batch)
    rec = gd.run("graphormer_slim", S, steps=2, device="cpu", smoke=True,
                 mesh_model=p, batch=batch)
    return (loss.item(), [g.numpy() for g in grads], rec["losses"],
            rec["mesh"])


def test_two_ranks_match_one_process(tmp_path):
    import torch.multiprocessing as mp

    S, mb = 2048, 4
    threads = max(1, (worker_share() or 2) // 2)
    mp.spawn(_child, args=(2, str(tmp_path), threads, _mesh_run, (S, mb)),
             nprocs=2, join=True)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    loss1, grads1, losses1, mesh1 = _one(S, mb, 1)
    assert mesh1 == "1x1"
    for (loss, grads, losses, mesh), calls in ranks:
        assert mesh == "1x2"
        # the sharded op ran, its no-buckets branch (bk = bq = 128), on
        # every layer of every forward (and recomputation)
        assert calls and set(calls) == {128}
        np.testing.assert_allclose(loss, loss1, rtol=1e-5)
        np.testing.assert_allclose(losses, losses1, rtol=TOL_RUN)
        for a, b in zip(grads, grads1):
            assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-6)
