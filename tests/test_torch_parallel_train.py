"""Sequence- and data-parallel training on the port (``Trainer(...,
mesh=, recipe=)``, ``launch/train.py --mesh-model/--mesh-data``) against
the JAX package and against the port on one process, on the CPU.

Ranks are spawned with ``torch.multiprocessing`` over gloo (a
``file://`` rendezvous under the test's temporary directory, one thread
a rank): one world of 2 and one of 4 for the module, each running every
case in turn. The reference's single-device functions are the oracle,
as its own sharded tests use theirs.

* The graph CLI (``--arch gt --smoke --steps 4 --graph-nodes 192
  --dtype float32``, the layout frozen) at ``--mesh-model 2``: per-step
  losses equal the port at P = 1 and the JAX ``repro.launch.train.main``
  with the same flags within atol 1e-4 (the reference's bound,
  ``tests/test_distributed.py``), without and with the dense interleave
  step, and on Graphormer smoke (``n_global = 1``, a bias table); every
  rank's sparse steps went through ``sharded_cluster_attention``. With
  the ladder on, every rank makes the same moves. The three runs start
  from the JAX init, given to the port as a step-0 checkpoint.
* The LM: the loss and every gradient (summed over the ranks) of Qwen3
  smoke under Ulysses on the cluster-sparse backend (S = 256), and of
  SmolLM smoke, whose 3 heads force sequence-parallel attention, equal
  the JAX single-device ``model.loss`` within 1e-4 (fp32).
* Data parallelism: a (2, 2) mesh trains Qwen3 smoke as one process does
  (losses within 1e-4); a step poisoned on one rank is skipped on every
  rank.
* Elastic restore: the graph run's checkpoint saved at P = 2 resumes at
  P = 2, P = 1 and on a (2, 2) mesh with the same next losses (1e-5).
"""

import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch
from repro_torch.launch import train as train_cli

TOL_LOSS = 1e-4      # per-step losses (the reference's bound)
TOL_GRAD = 1e-4      # of the largest entry of the JAX gradient
TOL_RESUME = 1e-5    # the same checkpoint resumed on other meshes

GRAPH = ["--smoke", "--steps", "4", "--graph-nodes", "192",
         "--elastic-every", "0", "--dtype", "float32"]
# name -> (arch, interleave period)
GRAPH_RUNS = {"gt": ("gt", "0"), "gt_dense": ("gt", "2"),
              "graphormer": ("graphormer_large", "2")}
LADDER = ["--arch", "gt", "--smoke", "--steps", "4", "--graph-nodes", "192",
          "--interleave-period", "2", "--elastic-every", "1", "--dtype",
          "float32", "--device", "cpu"]
LM_CASES = {"qwen3_ulysses": ("qwen3_0_6b", "cluster_sparse", 256),
            "smollm_seqpar": ("smollm_135m", "dense", 64)}
DP = dict(arch="qwen3_0_6b", seq=64, batch=4, steps=3)


# ------------------------------------------------------------ spawning

def _child(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, tmp, *args)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, world, tmp, *args) -> list:
    import torch.multiprocessing as mp

    mp.spawn(_child, args=(fn, world, str(tmp), args), nprocs=world,
             join=True)
    return [torch.load(f"{tmp}/rank{r}.pt") for r in range(world)]


def _graph_argv(name, ckpt, steps="4", mesh=()):
    arch, period = GRAPH_RUNS[name]
    argv = ["--arch", arch, *GRAPH, "--interleave-period", period,
            "--device", "cpu", "--ckpt-dir", str(ckpt)]
    argv[argv.index("--steps") + 1] = steps
    return argv + list(mesh)


def _record(tr) -> dict:
    return {"loss": [h["loss"] for h in tr.history],
            "variant": [h["variant"] for h in tr.history],
            "beta_thre": [h["beta_thre"] for h in tr.history],
            "moves": [(m.step, m.pos) for m in tr.task.moves]}


# ------------------------------------------------------------ rank bodies

def _lm_loss_grads(cfg, state, seq, batch):
    """Loss and gradients (summed over the world) of the LM on this rank's
    shard, on a (1, P) mesh."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LMModel, lm_loss
    from repro_torch.parallel.axes import axis_rules
    from repro_torch.parallel.sharding import recipe_for
    from repro_torch.tasks import BatchFnTask

    model = LMModel(cfg, device="cpu")
    model.load_state_dict(state)
    mesh = make_host_mesh(model=dist.get_world_size())
    recipe = recipe_for(ShapeConfig("t", "train", seq, batch), mesh)
    task = BatchFnTask(lambda s: lm_batch(LMDataConfig(
        cfg.vocab_size, seq, batch), s)).prepare(model, mesh, recipe)
    with axis_rules(recipe, mesh):
        loss, _ = lm_loss(model, task.batches(0))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    for g in grads:
        dist.all_reduce(g)
    return {"loss": loss.item(), "grads": dict(zip(names, grads))}


def _world2(rank, world, tmp, ckpts, lm_states):
    import repro_torch.core.graph_model as tgm

    calls = {"n": 0}
    real = tgm.sharded_cluster_attention

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)
    tgm.sharded_cluster_attention = counting
    mesh = ["--mesh-model", "2", "--backend", "gloo"]
    out = {}
    for name in GRAPH_RUNS:
        out[name] = _record(train_cli.main(_graph_argv(
            name, ckpts[name + "_p2"], mesh=mesh)))
    out["sharded_calls"] = calls["n"]
    tgm.sharded_cluster_attention = real
    out["ladder"] = _record(train_cli.main(LADDER + mesh))
    # the P = 2 checkpoint at step 4, resumed at P = 2
    if rank == 0:
        shutil.copytree(ckpts["gt_p2"], ckpts["gt_resume_p2"])
    dist.barrier()
    out["resume"] = _record(train_cli.main(_graph_argv(
        "gt", ckpts["gt_resume_p2"], steps="6", mesh=mesh)))
    for name, (arch, backend, seq) in LM_CASES.items():
        cfg = get_smoke_config(arch).replace(dtype="float32",
                                             attn_backend=backend)
        out[name] = _lm_loss_grads(cfg, lm_states[name], seq, 2)
    return out


def _world4(rank, world, tmp, ckpts):
    out = {"resume": _record(train_cli.main(_graph_argv(
        "gt", ckpts["gt_resume_22"], steps="6",
        mesh=["--mesh-model", "2", "--mesh-data", "2", "--backend",
              "gloo"])))}
    tr = _dp_trainer(mesh=True)
    assert tr.run() == "done"
    out["dp_loss"] = [h["loss"] for h in tr.history]
    before = [p.detach().clone() for p in tr.params]
    m = tr.step("sparse", tr.task.batches(DP["steps"]), poison=rank == 1)
    out["poisoned"] = {"skipped": m["skipped"], "unchanged": all(
        torch.equal(a, b) for a, b in zip(before, tr.params))}
    return out


def _dp_trainer(mesh: bool):
    """Qwen3 smoke (fp32, dense attention) in a Trainer, on a (2, 2) mesh
    or on one process."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LMModel
    from repro_torch.parallel.sharding import recipe_for
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tasks import BatchFnTask

    cfg = get_smoke_config(DP["arch"]).replace(dtype="float32")
    model = LMModel(cfg, device="cpu")
    m = make_host_mesh(model=2, data=2) if mesh else None
    recipe = None if m is None else recipe_for(
        ShapeConfig("t", "train", DP["seq"], DP["batch"]), m)
    dc = LMDataConfig(cfg.vocab_size, DP["seq"], DP["batch"])
    return Trainer(model, TrainerConfig(steps=DP["steps"], lr=1e-3,
                                        warmup=1),
                   task=BatchFnTask(lambda s: lm_batch(dc, s)), mesh=m,
                   recipe=recipe)


# ------------------------------------------------------------ fixtures

def _jax_tree(arch, seed=0):
    import jax

    from repro.configs import get_smoke_config as jsmoke
    from repro.models import build

    cfg = jsmoke(arch).replace(dtype="float32")
    return jax.tree.map(np.asarray, build(cfg).init(jax.random.PRNGKey(seed)))


def _step0(tree, path):
    """A step-0 checkpoint of ``tree`` (fresh moments), as both packages'
    trainers restore it."""
    zeros = lambda t: {k: zeros(v) if isinstance(v, dict)  # noqa: E731
                       else np.zeros_like(v) for k, v in t.items()}
    Checkpointer(str(path)).save(0, {
        "params": tree, "opt": {"m": zeros(tree), "v": zeros(tree),
                                "step": np.int32(0)},
        "step": np.int32(0), "bad": np.int32(0)}, blocking=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run's record: the JAX CLI's, the port's at P = 1 and each
    world's ranks'."""
    from repro.launch import train as jtrain

    tmp = tmp_path_factory.mktemp("runs")
    trees = {a: _jax_tree(a) for a in ("gt", "graphormer_large")}
    ckpts = {}
    for name, (arch, _) in GRAPH_RUNS.items():
        for where in ("p1", "p2"):
            ckpts[f"{name}_{where}"] = tmp / f"{name}_{where}"
            _step0(trees[arch], ckpts[f"{name}_{where}"])
    for where in ("resume_p2", "resume_p1", "resume_22"):
        ckpts[f"gt_{where}"] = tmp / f"gt_{where}"
    out = {"jax": {}, "p1": {}}
    for name, (arch, period) in GRAPH_RUNS.items():
        out["jax"][name] = [h["loss"] for h in jtrain.main(
            ["--arch", arch, *GRAPH, "--interleave-period", period,
             "--attn-impl", "ref", "--ckpt-dir", str(tmp / f"jax_{name}")]
        ).history]
        out["p1"][name] = _record(train_cli.main(_graph_argv(
            name, ckpts[name + "_p1"])))
    lm_states = {name: params_from_jax(_jax_tree(arch))
                 for name, (arch, _, _) in LM_CASES.items()}
    out["w2"] = spawn(_world2, 2, tmp_path_factory.mktemp("w2"), ckpts,
                      lm_states)
    shutil.copytree(ckpts["gt_p2"], ckpts["gt_resume_p1"])
    shutil.copytree(ckpts["gt_p2"], ckpts["gt_resume_22"])
    out["p1"]["resume"] = _record(train_cli.main(_graph_argv(
        "gt", ckpts["gt_resume_p1"], steps="6")))
    out["w4"] = spawn(_world4, 4, tmp_path_factory.mktemp("w4"), ckpts)
    return out


# ------------------------------------------------------------ tests

@pytest.mark.parametrize("name", list(GRAPH_RUNS))
def test_graph_cli_mesh_losses_match_p1_and_jax(runs, name):
    want = runs["jax"][name]
    p1 = runs["p1"][name]
    np.testing.assert_allclose(p1["loss"], want, rtol=0, atol=TOL_LOSS)
    for r in runs["w2"]:
        assert r[name]["variant"] == p1["variant"]
        np.testing.assert_allclose(r[name]["loss"], want, rtol=0,
                                   atol=TOL_LOSS)
        np.testing.assert_allclose(r[name]["loss"], p1["loss"], rtol=0,
                                   atol=TOL_LOSS)
    if GRAPH_RUNS[name][1] != "0":
        assert "dense" in p1["variant"] and "sparse" in p1["variant"]


def test_graph_cli_mesh_engages_sharded_cluster_attention(runs):
    """Every rank's sparse steps (4 + 2 + 2 of them, 2 layers each, and
    the evaluations) went through sharded_cluster_attention."""
    for r in runs["w2"]:
        assert r["sharded_calls"] >= 2 * (4 + 2 + 2), r["sharded_calls"]


def test_ladder_moves_agree_across_ranks(runs):
    """With the ladder on (an AutoTuner epoch every step) and the dense
    interleave, every rank sees the same losses, rungs and moves."""
    a, b = (r["ladder"] for r in runs["w2"])
    assert a == b
    assert a["variant"] == ["dense", "sparse"] * 2
    assert np.isfinite(a["loss"]).all()


@pytest.mark.parametrize("name", list(LM_CASES))
def test_lm_loss_and_grads_on_mesh_match_jax(runs, name):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jsmoke
    from repro.models import build

    arch, backend, seq = LM_CASES[name]
    cfg = jsmoke(arch).replace(dtype="float32", attn_backend=backend)
    tree = _jax_tree(arch)
    b = {k: jnp.asarray(v) for k, v in lm_batch(
        LMDataConfig(cfg.vocab_size, seq, 2), 0).items()}
    (loss, _), jgrads = jax.value_and_grad(build(cfg).loss, has_aux=True)(
        tree, b)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    for r in runs["w2"]:
        got = r[name]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=TOL_GRAD)
        assert sorted(got["grads"]) == sorted(want)
        for k, w in want.items():
            err = np.abs(got["grads"][k].numpy() - w.numpy()).max()
            assert err <= TOL_GRAD * max(np.abs(w.numpy()).max(), 1e-6), \
                (k, err)


def test_data_parallel_mesh_matches_one_process(runs):
    tr = _dp_trainer(mesh=False)
    assert tr.run() == "done"
    want = [h["loss"] for h in tr.history]
    for r in runs["w4"]:
        np.testing.assert_allclose(r["dp_loss"], want, rtol=0,
                                   atol=TOL_LOSS)


def test_step_poisoned_on_one_rank_is_skipped_on_every_rank(runs):
    for r in runs["w4"]:
        assert r["poisoned"] == {"skipped": 1, "unchanged": True}


def test_checkpoint_saved_at_p2_resumes_on_other_meshes(runs):
    """The P = 2 run's step-4 checkpoint resumed to step 6 at P = 2, at
    P = 1 and on a (2, 2) mesh: the same two next losses."""
    want = runs["w2"][0]["resume"]["loss"]
    assert len(want) == 2
    got = [runs["p1"]["resume"]] + [r["resume"] for r in runs["w2"]] + \
        [r["resume"] for r in runs["w4"]]
    for g in got:
        np.testing.assert_allclose(g["loss"], want, rtol=0, atol=TOL_RESUME)
