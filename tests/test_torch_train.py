"""The port's training slice against the JAX package, on the CPU: the
model's two losses and their parameter gradients, one AdamW update, a
short trainer run, and the elastic ladder of ``NodeTask``. Inputs are
seeded numpy arrays (and one parameter tree from the JAX init) given to
both.

Tolerances (fp32): losses within 1e-5 relative; every parameter gradient
within 1e-4 of the largest entry of its JAX counterpart (the two
frameworks sum in other orders); one AdamW update within 1e-6; a 6-step
loss trajectory within 1e-4 relative (rounding differences compound over
the updates). Ladders and layouts: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph_model as jgm
from repro.core.graph import sbm_graph as jax_sbm
from repro.models import build
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import warmup_cosine as jwarmup_cosine
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro.tasks import NodeTask as JNodeTask
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import graph_model as tgm
from repro_torch.core.graph import sbm_graph
from repro_torch.data.graph_pipeline import prepare_node_task
from repro_torch.launch import train as train_cli
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.tasks import NodeTask

N_NODES = 120


def _cfg(arch="graphormer_slim"):
    return get_smoke_config(arch).replace(dtype="float32")


def _graphs(cfg, n=N_NODES, seed=2):
    kw = dict(feat_dim=cfg.feat_dim, n_classes=cfg.n_classes, seed=seed)
    return (sbm_graph(n, 4, 0.08, 0.004, **kw),
            jax_sbm(n, 4, 0.08, 0.004, **kw))


def _train_mask(n, seed=0):
    return np.random.default_rng(seed).random(n) < 0.5


def _jax_tree(cfg, seed=0, bias=True):
    tree = jax.tree.map(lambda x: np.array(x, copy=True),
                        build(cfg).init(jax.random.PRNGKey(seed)))
    if bias:   # a nonzero table, so its lookup and gradient matter
        rng = np.random.default_rng(seed)
        tree["bias_table"] = (rng.standard_normal(tree["bias_table"].shape)
                              * 0.5).astype(np.float32)
    return tree


def _port_model(cfg, tree):
    model = tgm.GraphModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model


@pytest.mark.parametrize("variant", ["sparse", "dense"])
@pytest.mark.parametrize("arch", ["graphormer_slim", "graphormer_large"])
def test_loss_and_grads_match_jax(arch, variant):
    cfg = _cfg(arch)
    g, _ = _graphs(cfg)
    prep = prepare_node_task(g, cfg, bq=32, bk=32, d_b=8,
                             train_mask=_train_mask(g.n),
                             with_dense_buckets=True)
    tree = _jax_tree(cfg)
    jloss = jgm.graph_loss_dense if variant == "dense" else \
        (lambda p, c, b: jgm.graph_loss(p, c, b, dense=False))
    jb = {k: jnp.asarray(v) for k, v in prep.batch.items()}
    (lval, jmet), jgrads = jax.value_and_grad(
        lambda p: jloss(p, cfg, jb), has_aux=True)(tree)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))

    model = _port_model(cfg, tree)
    loss, met = model.loss_variants[variant](
        model, tgm.batch_to_torch(prep.batch, "cpu"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(lval), rtol=1e-5)
    np.testing.assert_allclose(met["acc"].item(), float(jmet["acc"]),
                               rtol=1e-6)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-6), (name, err)
    assert np.abs(model.bias_table.grad.numpy()).max() > 0


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 3, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jopt = JAdamW(lr=jwarmup_cosine(1e-2, 2, 10), weight_decay=0.1)
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)
    tparams = [torch.tensor(p) for p in params]
    opt = AdamW(tparams, lr=warmup_cosine(1e-2, 2, 10), weight_decay=0.1)
    for step in range(4):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jparams, jstate = jopt.update([jnp.asarray(x) for x in grads],
                                      jstate, jparams)
        opt.update([torch.tensor(x) for x in grads])
        for a, b in zip(tparams, jparams):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    sched, jsched = warmup_cosine(1e-3, 3, 20), jwarmup_cosine(1e-3, 3, 20)
    for s in range(0, 24):
        np.testing.assert_allclose(sched(s), float(jsched(s)), rtol=1e-6)
    with pytest.raises(ValueError, match="float16"):
        AdamW(tparams, lr=1e-3, state_dtype="float16")


def test_trainer_trajectory_matches_jax(tmp_path):
    """Six steps from the same init, dense at steps 0, 2 and 4, with the
    layout frozen (``elastic_every=0``: the ladder reads wall time)."""
    cfg = _cfg()
    g, jg = _graphs(cfg)
    mask = _train_mask(g.n)
    kw = dict(steps=6, lr=1e-3, warmup=2, interleave_period=2,
              elastic_every=0)
    jtr = JTrainer(build(cfg), JTrainerConfig(
        ckpt_dir=str(tmp_path), attn_impl="ref", **kw),
        task=JNodeTask(jg, cfg, train_mask=mask))
    jstate, _ = jtr.run()
    model = _port_model(cfg, _jax_tree(cfg, bias=False))
    tr = Trainer(model, TrainerConfig(**kw),
                 task=NodeTask(g, cfg, train_mask=mask, device="cpu"))
    assert tr.run() == "done"
    assert [h["variant"] for h in tr.history] == \
        [h["variant"] for h in jtr.history] == ["dense", "sparse"] * 3
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in jtr.history], rtol=1e-4)
    np.testing.assert_allclose([h["acc"] for h in tr.history],
                               [h["acc"] for h in jtr.history], atol=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, jstate["params"]))
    got = dict(model.named_parameters())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                   atol=1e-4, err_msg=name)
    ev = tr.task.eval(model)
    assert set(ev) == {"xent", "acc"} and np.isfinite(ev["xent"])


def test_ladders_make_the_same_moves_and_layouts():
    """Both NodeTasks fed one on_epoch sequence (a steady descent, then a
    plateau) move alike and serve identical layout arrays at every rung
    they visit, the dense step's bucket matrix included."""
    cfg = _cfg()
    g, jg = _graphs(cfg, n=96, seed=0)
    task = NodeTask(g, cfg, delta=2, device="cpu")
    jtask = JNodeTask(jg, cfg, delta=2)
    feed = [(5.0 - 0.4 * i, 1.0) for i in range(8)] + [(2.0, 1.0)] * 6
    keys = ("block_idx", "block_idx_t", "buckets", "dense_buckets", "feat",
            "in_deg", "out_deg", "labels")
    visited = set()
    for i, (loss, secs) in enumerate(feed):
        moved = task.on_epoch(loss, secs, step=i + 1)
        assert moved == jtask.on_epoch(loss, secs, step=i + 1)
        assert task.tuner.pos == jtask.tuner.pos
        visited.add(task.beta_thre)
        for k in keys:
            a, b = task.prep.batch[k], jtask.prep.batch[k]
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
            dev = task.batches(i)[k]
            np.testing.assert_array_equal(dev.numpy(),
                                          np.asarray(jtask.batches(i)[k]))
    assert len(visited) >= 3
    assert [vars(m) for m in task.moves] == [vars(m) for m in jtask.moves]
    assert task.state_dict() == jtask.state_dict()
    fresh = NodeTask(g, cfg, delta=2, device="cpu")
    fresh.load_state_dict(jtask.state_dict())
    assert fresh.tuner.pos == task.tuner.pos and fresh.moves == task.moves
    # rung-invariant arrays are uploaded once, whatever the rung
    assert task.batches(0)["feat"] is task._uploads[id(task.prep.batch["feat"])]


def test_nonfinite_step_is_skipped():
    """A step whose loss is not finite leaves parameters and moments as
    they were and counts as bad; the next good step resets the count."""
    cfg = _cfg()
    g, _ = _graphs(cfg, n=64)
    model = tgm.GraphModel(cfg, device="cpu")
    task = NodeTask(g, cfg, device="cpu")
    tr = Trainer(model, TrainerConfig(steps=2, lr=1e-3, warmup=1),
                 task=task)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        model.head[0, 0] = float("nan")
    before["head"] = model.head.detach().clone()
    m = tr.step("sparse", task.batches(0))
    assert m["skipped"] == 1 and m["bad_steps"] == 1 and tr.opt.step == 0
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]) or n == "head", n
    assert torch.equal(model.head.isnan(), before["head"].isnan())
    with torch.no_grad():
        model.head[0, 0] = 0.0
    m = tr.step("sparse", task.batches(0))
    assert m["skipped"] == 0 and m["bad_steps"] == 0 and tr.opt.step == 1


def test_train_cli_runs_on_cpu(capsys):
    train_cli.main(["--arch", "graphormer_slim", "--smoke", "--steps", "4",
                    "--graph-nodes", "64", "--interleave-period", "2",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[dense ]" in out and "[sparse]" in out and "eval: " in out
    assert "status=done" in out and "dense_steps=2" in out
    # the link task, once refused, trains on the same graph
    train_cli.main(["--arch", "graphormer_slim", "--smoke", "--task",
                    "link", "--steps", "2", "--graph-nodes", "64",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "task=link" in out and "eval: " in out and "status=done" in out


def test_train_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--smoke", "--steps", "1", "--graph-nodes", "64"])

