"""Graph-level and link training on a mesh (``GraphLevelTask`` and
``LinkTask`` under ``Trainer(..., mesh=, recipe=)``, ``launch/train.py
--task graph|link --mesh-model/--mesh-data``) against the JAX package's
single-device training, on the CPU.

Ranks are spawned with ``torch.multiprocessing`` over gloo (a
``file://`` rendezvous under the test's temporary directory), one world
of 2 (a (1, 2) mesh) and one of 4 (a (2, 2) mesh) for the module, each
rank on its share of this worker's threads. Every run starts from the
JAX init of GT smoke (fp32), given to the port as a step-0 checkpoint
(``convert.params_from_jax``'s layout), on the same synthetic data.

* The CLI, 4 steps with the dense interleave at steps 1 and 3 and the
  layout frozen: ``--task graph`` (8 mini-graphs in mini-batches of 4,
  S = 128, 16 x 16 blocks; on the (2, 2) mesh the graphs split over
  "data") and ``--task link`` (the 128-node SBM, 32 x 32 blocks; B = 1,
  so "data" cannot split it): every rank's losses equal the JAX CLI's
  within 1e-4 (the reference's bound,
  ``tests/test_distributed.py:test_graph_train_cli_sharded_matches_single_device``).
* The init step: each variant's loss and gradients (summed over the
  ranks) equal ``jax.value_and_grad`` of the reference's loss on the
  reference task's step-0 batch, the gradients within 1e-5 of each
  parameter's largest JAX entry.
* The graph-level label sits on the global token at position 0, which
  only model rank 0 holds: the other model ranks count no label.
"""

import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as train_cli

from test_torch_threads import worker_share

TOL_LOSS = 1e-4      # per-step losses (the reference's bound)
TOL_GRAD = 1e-5      # init gradients, of the largest entry of the JAX one

COMMON = ["--arch", "gt", "--smoke", "--steps", "4", "--elastic-every",
          "0", "--interleave-period", "2", "--dtype", "float32"]
TASKS = {"graph": ["--task", "graph", "--graphs", "8", "--batch-graphs",
                   "4"],
         "link": ["--task", "link", "--graph-nodes", "128"]}
MESHES = {"p2": ["--mesh-model", "2"],
          "d2p2": ["--mesh-model", "2", "--mesh-data", "2"]}


# ------------------------------------------------------------ spawning

def _child(rank, fn, world, tmp, threads, args):
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, world, tmp, *args) -> list:
    """``fn(rank, world, *args)`` in ``world`` gloo ranks, each on its
    share of this worker's threads; each rank's returned value, in rank
    order."""
    import torch.multiprocessing as mp

    threads = max(1, (worker_share() or world) // world)
    mp.spawn(_child, args=(fn, world, str(tmp), threads, args),
             nprocs=world, join=True)
    return [torch.load(f"{tmp}/rank{r}.pt") for r in range(world)]


# ------------------------------------------------------------ rank bodies

def _port_task(task, cfg):
    """The CLI's task (its data and seeds), batches on the CPU."""
    from repro_torch.core.graph import sbm_graph
    from repro_torch.tasks import (GraphLevelTask, LinkTask,
                                   synthetic_graph_level_dataset)

    if task == "graph":
        return GraphLevelTask(synthetic_graph_level_dataset(8, cfg, seed=1),
                              cfg, batch_graphs=4, device="cpu")
    return LinkTask(sbm_graph(128, 4, p_in=0.04, p_out=0.002,
                              feat_dim=cfg.feat_dim,
                              n_classes=cfg.n_classes, seed=0), cfg,
                    device="cpu")


def _init_grads(task_name, state, mesh_shape):
    """Each variant's loss and gradients (summed over the world) at the
    init on the step-0 batch, and this rank's label count."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.graph_model import GraphModel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import recipe_for

    cfg = get_smoke_config("gt").replace(dtype="float32")
    model = GraphModel(cfg, device="cpu")
    model.load_state_dict(state)
    task = _port_task(task_name, cfg)
    mesh = make_host_mesh(**mesh_shape)
    recipe = recipe_for(ShapeConfig("g", "train", task.layout.seq_len, 1),
                        mesh)
    task.prepare(model, mesh, recipe)
    out = {"labels": int((task.batches(0)["labels"] >= 0).sum()),
           "model_rank": mesh.get_local_rank("model")}
    names = [n for n, _ in model.named_parameters()]
    for variant, fn in task.loss_variants.items():
        with task.context():
            loss, _ = fn(model, task.batches(0))
            grads = torch.autograd.grad(loss, list(model.parameters()),
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, model.parameters())]
        for g in grads:
            dist.all_reduce(g)
        out[variant] = {"loss": loss.item(), "grads": dict(zip(names, grads))}
    return out


def _world(rank, world, ckpts, state):
    mesh = "p2" if world == 2 else "d2p2"
    shape = {"model": 2, "data": world // 2}
    out = {}
    for task in TASKS:
        tr = train_cli.main(COMMON + TASKS[task] + MESHES[mesh] + [
            "--backend", "gloo", "--device", "cpu", "--ckpt-dir",
            str(ckpts[f"{task}_{mesh}"])])
        out[task] = {"loss": [h["loss"] for h in tr.history],
                     "variant": [h["variant"] for h in tr.history],
                     "init": _init_grads(task, state, shape)}
    return out


# ------------------------------------------------------------ fixtures

def _jax_tree():
    import jax

    from repro.configs import get_smoke_config as jsmoke
    from repro.models import build

    cfg = jsmoke("gt").replace(dtype="float32")
    return jax.tree.map(lambda x: np.array(x, copy=True),
                        build(cfg).init(jax.random.PRNGKey(0)))


def _step0(tree, path):
    """A step-0 checkpoint of ``tree`` (fresh moments), as the port's
    trainer restores it."""
    zeros = lambda t: {k: zeros(v) if isinstance(v, dict)  # noqa: E731
                       else np.zeros_like(v) for k, v in t.items()}
    Checkpointer(str(path)).save(0, {
        "params": tree, "opt": {"m": zeros(tree), "v": zeros(tree),
                                "step": np.int32(0)},
        "step": np.int32(0), "bad": np.int32(0)}, blocking=True)


def _jax_init(task, tree):
    """``{variant: (loss, gradient tree)}`` of the reference's losses on
    the reference task's step-0 batch."""
    import jax

    from repro.configs import get_smoke_config as jsmoke
    from repro.core import graph_model as jgm
    from repro.core.graph import sbm_graph as jsbm
    from repro.tasks import GraphLevelTask as JGraphLevelTask
    from repro.tasks import LinkTask as JLinkTask
    from repro.tasks import link_loss as jlink_loss
    from repro.tasks import synthetic_graph_level_dataset as jdataset

    cfg = jsmoke("gt").replace(dtype="float32")
    if task == "graph":
        jb = JGraphLevelTask(jdataset(8, cfg, seed=1), cfg,
                             batch_graphs=4).batches(0)
        fns = {"sparse": lambda p: jgm.graph_loss(p, cfg, jb),
               "dense": lambda p: jgm.graph_loss_dense(p, cfg, jb)}
    else:
        jb = JLinkTask(jsbm(128, 4, p_in=0.04, p_out=0.002,
                            feat_dim=cfg.feat_dim, n_classes=cfg.n_classes,
                            seed=0), cfg).batches(0)
        fns = {"sparse": lambda p: jlink_loss(p, cfg, jb),
               "dense": lambda p: jlink_loss(
                   p, cfg, jgm.with_dense_bias(p, cfg, jb), dense=True)}
    out = {}
    for variant, fn in fns.items():
        (loss, _), g = jax.value_and_grad(fn, has_aux=True)(tree)
        out[variant] = (float(loss), jax.tree.map(np.asarray, g))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro.launch import train as jtrain

    tmp = tmp_path_factory.mktemp("mesh_tasks")
    tree = _jax_tree()
    ckpts = {}
    for task in TASKS:
        for mesh in MESHES:
            ckpts[f"{task}_{mesh}"] = tmp / f"{task}_{mesh}"
            _step0(tree, ckpts[f"{task}_{mesh}"])
    out = {"jax": {}, "jax_init": {}}
    for task in TASKS:
        out["jax"][task] = [h["loss"] for h in jtrain.main(
            COMMON + TASKS[task] + ["--attn-impl", "ref", "--ckpt-dir",
                                    str(tmp / f"jax_{task}")]).history]
        out["jax_init"][task] = _jax_init(task, tree)
    state = params_from_jax(tree)
    out["p2"] = spawn(_world, 2, tmp_path_factory.mktemp("w2"), ckpts,
                      state)
    out["d2p2"] = spawn(_world, 4, tmp_path_factory.mktemp("w4"), ckpts,
                        state)
    shutil.rmtree(tmp, ignore_errors=True)
    return out


# ------------------------------------------------------------ tests

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("task", list(TASKS))
def test_cli_mesh_losses_match_jax_single_device(runs, task, mesh):
    want = runs["jax"][task]
    assert len(want) == 4
    for r in runs[mesh]:
        assert r[task]["variant"] == ["dense", "sparse"] * 2
        np.testing.assert_allclose(r[task]["loss"], want, rtol=0,
                                   atol=TOL_LOSS)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("task", list(TASKS))
def test_init_loss_and_grads_on_mesh_match_jax(runs, task, mesh):
    for variant, (jloss, jgrads) in runs["jax_init"][task].items():
        want = params_from_jax(jgrads)
        for r in runs[mesh]:
            got = r[task]["init"][variant]
            np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
            assert sorted(got["grads"]) == sorted(want)
            for k, w in want.items():
                w = w.numpy()
                err = np.abs(got["grads"][k].numpy() - w).max()
                assert err <= TOL_GRAD * max(np.abs(w).max(), 1e-6), \
                    (variant, k, err)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_graph_label_only_on_model_rank_zero(runs, mesh):
    """Each rank's shard of the step-0 batch: the graph labels (one a
    graph, at position 0) all sit on model rank 0; the others count
    none, so the loss's count is the data shard's graphs."""
    graphs = 4 // (len(runs[mesh]) // 2)
    for r in runs[mesh]:
        got = r["graph"]["init"]
        assert got["labels"] == (graphs if got["model_rank"] == 0 else 0)
