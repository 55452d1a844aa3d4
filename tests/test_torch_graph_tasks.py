"""The port's graph-level and link tasks against the JAX package, on the
CPU: the packed mini-graph batches of ``prepare_graph_task_ladder`` and
``pad_graph_batch`` (byte for byte, at 16 x 16 and 32 x 32 blocks), the
graph-level and link losses with their gradients (GT and
Graphormer-Slim, sparse and dense), the link task's pair stream, a short
graph-level training run through both trainers, and the CLI's
``--task graph`` and ``--task link``. Inputs are seeded numpy arrays and
one parameter tree from the JAX init, given to both.

Tolerances (fp32, as in ``test_torch_train.py``): losses within 1e-5
relative; every parameter gradient within 1e-4 of the largest entry of
its JAX counterpart (the two frameworks sum in other orders); a 6-step
loss trajectory within 1e-4 relative and the parameters after it within
1e-4 (rounding differences compound over the updates). Batches, pair
streams and eval edges: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import graph_model as jgm
from repro.core.graph import sbm_graph as jax_sbm
from repro.data import graph_pipeline as j_pipe
from repro.models import build
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro.tasks import GraphLevelTask as JGraphLevelTask
from repro.tasks import LinkTask as JLinkTask
from repro.tasks import link_loss as jlink_loss
from repro.tasks import synthetic_graph_level_dataset as jdataset
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import graph_model as tgm
from repro_torch.core.graph import sbm_graph
from repro_torch.data import graph_pipeline
from repro_torch.launch import train as train_cli
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.tasks import (GraphLevelTask, LinkTask, link_loss,
                               synthetic_graph_level_dataset)

ARCHS = ("gt", "graphormer_slim")
SMALL = dict(n_lo=20, n_hi=44)   # mini-graphs of 20-43 nodes
PACKED_KEYS = ("feat", "in_deg", "out_deg", "labels", "block_idx",
               "block_idx_t", "buckets", "dense_buckets", "lap_pe")


def _cfg(arch):
    return get_smoke_config(arch).replace(dtype="float32")


def _jax_tree(cfg, seed=0):
    """Numpy copy of a JAX init; a random nonzero bias table where the
    config has one (GT has none), so its lookup and gradient matter."""
    tree = jax.tree.map(lambda x: np.array(x, copy=True),
                        build(cfg).init(jax.random.PRNGKey(seed)))
    if "bias_table" in tree:
        rng = np.random.default_rng(seed)
        tree["bias_table"] = (rng.standard_normal(tree["bias_table"].shape)
                              * 0.5).astype(np.float32)
    return tree


def _port_model(cfg, tree):
    model = tgm.GraphModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model


def _same_array(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _check_grads(model, jgrads):
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        # a parameter the loss does not reach (the link task's class
        # head) has no gradient here and a zero one under jax.grad
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = np.abs(g - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-6), (name, err)


# ------------------------------------------------------------ host prep

def test_synthetic_dataset_identical():
    cfg = _cfg("gt")
    mine = synthetic_graph_level_dataset(6, cfg, seed=1)
    ref = jdataset(6, jcfgs.get_smoke_config("gt"), seed=1)
    for a, b in zip(mine, ref, strict=True):
        for x, y in ((a.src, b.src), (a.dst, b.dst), (a.feat, b.feat),
                     (a.labels, b.labels)):
            _same_array(x, y)


@pytest.mark.parametrize("bq", [16, 32])
@pytest.mark.parametrize("arch", ARCHS)
def test_graph_task_ladder_and_pad_identical(arch, bq):
    """Every rung of the packed ladder, then padded past its own budget,
    equals the reference's byte for byte; the rung-invariant arrays stay
    aliased across rungs through both pads, as the upload dedup needs."""
    cfg = _cfg(arch)
    ladder = [None, 0.0, 0.3, 1.0]
    mine = graph_pipeline.prepare_graph_task_ladder(
        synthetic_graph_level_dataset(5, cfg, seed=3), cfg, ladder, bq=bq,
        bk=bq, with_dense_buckets=True)
    ref = j_pipe.prepare_graph_task_ladder(
        jdataset(5, jcfgs.get_smoke_config(arch), seed=3), cfg, ladder,
        bq=bq, bk=bq, with_dense_buckets=True)
    seq = mine[0].layout.seq_len + 2 * bq
    mb, mt = mine[0].layout.mb + 3, mine[0].layout.mt + 2
    shared: dict = {}
    padded = [graph_pipeline.pad_graph_batch(p, seq, mb, mt,
                                             _shared=shared) for p in mine]
    jshared: dict = {}
    jpadded = [j_pipe.pad_graph_batch(p, seq, mb, mt, _shared=jshared)
               for p in ref]
    for a, b in zip(mine + padded, ref + jpadded, strict=True):
        assert set(a.batch) == set(b.batch)
        assert ("lap_pe" in a.batch) == (arch == "gt")
        for key in PACKED_KEYS:
            if key in b.batch:
                _same_array(a.batch[key], b.batch[key])
        assert a.layout.stats == b.layout.stats
        assert (a.layout.seq_len, a.layout.bq, a.layout.mb, a.layout.mt) \
            == (b.layout.seq_len, b.layout.bq, b.layout.mb, b.layout.mt)
        assert a.cut == b.cut and vars(a.report) == vars(b.report)
    for ps in (mine, padded):
        for key in ("feat", "in_deg", "labels") + (
                ("lap_pe",) if arch == "gt" else ()):
            assert all(p.batch[key] is ps[0].batch[key] for p in ps), key
    assert padded[0].layout.seq_len == seq


def test_graph_level_task_uploads_invariant_arrays_once():
    cfg = _cfg("gt")
    task = GraphLevelTask(synthetic_graph_level_dataset(4, cfg, seed=1),
                          cfg, batch_graphs=2, device="cpu")
    assert task.n_batches == 2 and task.layout.bq == 16
    feats = {id(task.batches(s)["feat"]) for s in range(2)}
    for bt in task._preps:
        state = task.tuner.state_dict()
        state["pos"] = task.tuner.ladder.index(bt)
        task.tuner.load_state_dict(state)
        for s in range(2):
            b = task.batches(s)
            assert id(b["feat"]) in feats
            assert b["lap_pe"] is task._uploads[
                id(task._preps[bt][s].batch["lap_pe"])]
    assert len(feats) == 2


# ----------------------------------------------------- losses and grads

def _graph_batch(arch, bq=16):
    cfg = _cfg(arch)
    prep = graph_pipeline.prepare_graph_task(
        synthetic_graph_level_dataset(4, cfg, seed=5, **SMALL), cfg, bq=bq,
        bk=bq, with_dense_buckets=True)
    return cfg, prep.batch


@pytest.mark.parametrize("variant", ["sparse", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_graph_level_loss_and_grads_match_jax(arch, variant):
    cfg, batch = _graph_batch(arch)
    tree = _jax_tree(cfg)
    jloss = jgm.graph_loss_dense if variant == "dense" else \
        (lambda p, c, b: jgm.graph_loss(p, c, b, dense=False))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (lval, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, cfg, jb), has_aux=True))(tree)
    model = _port_model(cfg, tree)
    loss, met = model.loss_variants[variant](
        model, tgm.batch_to_torch(batch, "cpu"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(lval), rtol=1e-5)
    np.testing.assert_allclose(met["acc"].item(), float(jmet["acc"]),
                               rtol=1e-6)
    _check_grads(model, jgrads)
    if arch == "gt":
        assert np.abs(model.pe_proj.grad.numpy()).max() > 0


def _link_tasks(cfg, n=96, n_pairs=64):
    kw = dict(feat_dim=cfg.feat_dim, n_classes=cfg.n_classes, seed=4)
    task = LinkTask(sbm_graph(n, 4, 0.08, 0.004, **kw), cfg,
                    n_pairs=n_pairs, device="cpu")
    jtask = JLinkTask(jax_sbm(n, 4, 0.08, 0.004, **kw), cfg,
                      n_pairs=n_pairs)
    return task, jtask


@pytest.mark.parametrize("variant", ["sparse", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_link_loss_and_grads_match_jax(arch, variant):
    cfg = _cfg(arch)
    task, jtask = _link_tasks(cfg)
    tree = _jax_tree(cfg)
    jb = jtask.batches(0)
    if variant == "dense":
        jfn = lambda p: jlink_loss(p, cfg, jgm.with_dense_bias(p, cfg, jb),
                                   dense=True)
    else:
        jfn = lambda p: jlink_loss(p, cfg, jb)
    (lval, jmet), jgrads = jax.jit(jax.value_and_grad(jfn,
                                                      has_aux=True))(tree)
    model = _port_model(cfg, tree)
    task.prepare(model)
    loss, met = task.loss_variants[variant](model, task.batches(0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(lval), rtol=1e-5)
    np.testing.assert_allclose(met["acc"].item(), float(jmet["acc"]),
                               rtol=1e-6)
    _check_grads(model, jgrads)
    # the module-level loss is the sparse variant
    model.zero_grad()
    l2, _ = link_loss(model, task.batches(0))
    if variant == "sparse":
        assert l2.item() == loss.item()


def test_link_pair_stream_and_eval_edges_match_jax():
    """The pair stream of steps 0-3 and the held-out edges equal the
    reference's; the cached device batch gains no pair arrays."""
    cfg = _cfg("gt")
    task, jtask = _link_tasks(cfg, n=120, n_pairs=32)
    for step in range(4):
        b, jb = task.batches(step), jtask.batches(step)
        for key in ("pair_src", "pair_dst", "pair_y"):
            np.testing.assert_array_equal(b[key].numpy(),
                                          np.asarray(jb[key]))
        assert b["pair_src"].shape == (32,)
    for a, c in zip(task._eval_edges, jtask._eval_edges, strict=True):
        _same_array(a, c)
    for a, c in zip(task._train_edges, jtask._train_edges, strict=True):
        _same_array(a, c)
    assert not any(k.startswith("pair_") for k in
                   task._batches_dev[(task.beta_thre, 0)])
    model = _port_model(cfg, _jax_tree(cfg))
    task.prepare(model)
    jev = jtask.eval(_jax_tree(cfg))
    ev = task.eval(model)
    assert set(ev) == set(jev) == {"xent", "acc"}
    np.testing.assert_allclose(ev["xent"], jev["xent"], rtol=1e-5)
    np.testing.assert_allclose(ev["acc"], jev["acc"], atol=1e-6)


# ------------------------------------------------------------ trainer

def test_graph_level_trainer_trajectory_matches_jax(tmp_path):
    """Six steps of GT from the same init on two mini-batches, dense at
    steps 0, 2 and 4, the layout frozen (``elastic_every=0``: the ladder
    reads wall time)."""
    cfg = _cfg("gt")
    kw = dict(steps=6, lr=1e-3, warmup=2, interleave_period=2,
              elastic_every=0)
    jtask = JGraphLevelTask(
        jdataset(8, jcfgs.get_smoke_config("gt"), seed=1, **SMALL), cfg,
        batch_graphs=4, eval_graphs=jdataset(4, cfg, seed=2, **SMALL))
    jtr = JTrainer(build(cfg), JTrainerConfig(
        ckpt_dir=str(tmp_path), attn_impl="ref", **kw), task=jtask)
    jstate, _ = jtr.run()
    model = _port_model(cfg, _jax_tree(cfg))
    task = GraphLevelTask(
        synthetic_graph_level_dataset(8, cfg, seed=1, **SMALL), cfg,
        batch_graphs=4, device="cpu",
        eval_graphs=synthetic_graph_level_dataset(4, cfg, seed=2, **SMALL))
    tr = Trainer(model, TrainerConfig(**kw), task=task)
    assert tr.run() == "done"
    assert task.n_batches == 2
    assert [h["variant"] for h in tr.history] == \
        [h["variant"] for h in jtr.history] == ["dense", "sparse"] * 3
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in jtr.history], rtol=1e-4)
    want = params_from_jax(jax.tree.map(np.asarray, jstate["params"]))
    got = dict(model.named_parameters())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                   atol=1e-4, err_msg=name)
    ev, jev = task.eval(model), jtask.eval(jstate["params"])
    assert set(ev) == set(jev) == {"xent", "acc"}
    np.testing.assert_allclose(ev["xent"], jev["xent"], rtol=1e-4)


# ---------------------------------------------------------------- CLI

@pytest.mark.parametrize("task,extra", [
    ("graph", ["--graphs", "8", "--batch-graphs", "4"]),
    ("link", ["--graph-nodes", "96"])])
def test_train_cli_tasks_run_on_cpu(capsys, task, extra):
    tr = train_cli.main(["--arch", "gt", "--smoke", "--task", task,
                         "--steps", "3", "--interleave-period", "2",
                         "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert f"task={'graph_level' if task == 'graph' else 'link'}" in out
    assert "[dense ]" in out and "[sparse]" in out and "eval: " in out
    assert "status=done" in out
    assert np.isfinite([h["loss"] for h in tr.history]).all()
    if task == "graph":
        assert "bq=16" in out and "mini_batches=2" in out


@pytest.mark.parametrize("task", ["graph", "link"])
def test_train_cli_tasks_default_to_cuda(task):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--arch", "gt", "--smoke", "--task", task,
                        "--steps", "1", "--graphs", "2",
                        "--graph-nodes", "64"])
