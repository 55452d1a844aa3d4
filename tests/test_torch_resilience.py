"""The port's fault plan, recovery ladder and chaos sweep, on the CPU:
``FaultPlan`` against the reference's on a grid of specs; every fault
case of the chaos sweep on the GT smoke graph-level task (16 steps,
checkpoints every 4, the layout frozen: the ladder reads wall time),
bitwise where the case promises ``exact``; the task's state across a
restart; ``max_rollbacks``; the straggler report; a crash save that never
writes torn state; ``python -m repro_torch.resilience``; and resuming a
run across packages, the reference's checkpoint by the port and the
port's by the reference.

Tolerances: the recoveries are exact (the port against itself, same
device). Across packages, fp32 as ``test_torch_graph_tasks.py`` states
them: losses within 1e-4 relative, parameters within 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.ckpt.checkpoint import Checkpointer as JCheckpointer
from repro.models import build
from repro.resilience import faults as jfaults
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro.tasks import GraphLevelTask as JGraphLevelTask
from repro.tasks import synthetic_graph_level_dataset as jdataset
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.graph_model import GraphModel
from repro_torch.resilience import faults
from repro_torch.resilience.__main__ import main as chaos_main
from repro_torch.resilience.chaos import (bitwise, run_training_cases,
                                          state_of)
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.tasks import GraphLevelTask, synthetic_graph_level_dataset
from repro_torch.tasks.elastic import LadderMove

SMALL = dict(n_lo=20, n_hi=44)   # mini-graphs of 20-43 nodes
STEPS, EVERY = 16, 4
AT = {"skip": 6, "rollback": (5, 7), "preempt": 10, "corrupt": 16}


def _cfg():
    return get_smoke_config("gt").replace(dtype="float32")


def _task():
    cfg = _cfg()
    return GraphLevelTask(synthetic_graph_level_dataset(8, cfg, seed=1,
                                                        **SMALL),
                          cfg, batch_graphs=4, device="cpu")


def _factory(task, **fixed):
    def make(d, **kw):
        model = GraphModel(_cfg(), device="cpu", seed=0)
        return Trainer(model, TrainerConfig(
            steps=STEPS, lr=1e-3, warmup=2, interleave_period=8,
            ckpt_dir=None if d is None else str(d),
            **{"ckpt_every": EVERY, "elastic_every": 0, **fixed, **kw}),
            task=task)
    return make


@pytest.fixture(scope="module")
def graph_task():
    return _task()


@pytest.fixture(scope="module")
def baseline(graph_task):
    tr = _factory(graph_task)(None)
    assert tr.run() == "done"
    return state_of(tr)


# ------------------------------------------------------------ FaultPlan

SPECS = ["", "nonfinite@3", "nonfinite@3,preempt@5,ckpt_corrupt@4-6,seed=7",
         " preempt@0 , burst@2-3 ,", "ckpt_corrupt@10,nonfinite@10,seed=0",
         "nonfinite@5-5,nonfinite@5"]
BAD = ["meteor@3", "nonfinite", "preempt@-1", "nonfinite@", "burst@3-x",
       "preempt@@2"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parses_and_takes_as_the_reference(spec):
    mine, ref = faults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert [(f.kind, f.step) for f in mine.faults] == \
        [(f.kind, f.step) for f in ref.faults]
    assert (mine.seed, mine.spec, bool(mine)) == \
        (ref.seed, ref.spec, bool(ref))
    for _ in range(2):   # the second pass: every fault already fired
        for step in range(12):
            for kind in faults.KINDS:
                a, b = mine.take(kind, step), ref.take(kind, step)
                assert (a is None) == (b is None)
                assert a is None or (a.kind, a.step) == (b.kind, b.step)
        assert mine.pending() == () and ref.pending() == ()


@pytest.mark.parametrize("spec", BAD)
def test_fault_plan_rejects_what_the_reference_rejects(spec):
    with pytest.raises(ValueError) as ref:
        jfaults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as mine:
        faults.FaultPlan.parse(spec)
    assert str(mine.value) == str(ref.value)


def test_fault_plan_env_wins_over_config(monkeypatch):
    assert faults.ENV_VAR == jfaults.ENV_VAR and \
        faults.KINDS == jfaults.KINDS
    monkeypatch.setenv(faults.ENV_VAR, "preempt@9")
    assert faults.FaultPlan.resolve("nonfinite@2").faults == \
        (faults.Fault("preempt", 9),)
    monkeypatch.delenv(faults.ENV_VAR)
    assert faults.FaultPlan.resolve("nonfinite@2").faults == \
        (faults.Fault("nonfinite", 2),)


# ------------------------------------------- the fault cases, GT graph

WANT = {
    "nonfinite_skip": {"skipped_steps": [7]},
    "nonfinite_rollback": {"rollbacks": [(8, 4)], "passed_over": [8],
                           "bitwise_equal": True},
    "preempt_rescued": {"latest_after_crash": 10, "resumed_at": 10,
                        "bitwise_equal": True},
    "preempt_unrescued": {"latest_after_crash": 8, "resumed_at": 8,
                          "bitwise_equal": True},
    "ckpt_corrupt": {"verify_issues": 1, "resumed_at": 12,
                     "replayed_steps": 4, "bitwise_equal": True},
}


@pytest.mark.parametrize("case", sorted(WANT))
def test_fault_case_recovers_on_gt_graph_level(graph_task, baseline, case):
    out = run_training_cases(_factory(graph_task), steps=STEPS,
                             ckpt_every=EVERY, at=AT, only=case)
    assert bitwise(state_of(out["baseline"]), baseline)
    (rec,) = out["records"]
    assert rec["fault"] == case and rec["recovered"], rec["detail"]
    for key, want in WANT[case].items():
        assert rec["facts"][key] == want, (key, rec["facts"])


def test_task_state_survives_a_restart(tmp_path):
    """An AutoTuner epoch every step: a run failed at step 10 leaves the
    task's state in the crash save's manifest, and a fresh task resumes
    with exactly that state."""
    task = _task()
    make = _factory(task, elastic_every=1)
    with pytest.raises(RuntimeError, match="injected failure at step 10"):
        make(tmp_path, fail_at_step=10).run()
    saved = Checkpointer(str(tmp_path)).load_extra(10)["task"]
    assert saved == task.state_dict()
    fresh = _task()
    tr = _factory(fresh, elastic_every=1)(tmp_path)
    assert tr.restore_or_init() == 10
    assert fresh.state_dict()["tuner"] == saved["tuner"]
    assert fresh.moves == [LadderMove(**m) for m in saved["moves"]]
    assert tr.run() == "done" and tr.history[0]["step"] == 11


def test_fail_at_step_then_restart_is_bitwise(graph_task, baseline,
                                              tmp_path):
    make = _factory(graph_task)
    with pytest.raises(RuntimeError, match="injected failure at step 6"):
        make(tmp_path, fail_at_step=6).run()
    assert Checkpointer(str(tmp_path)).all_steps() == [4, 6]
    tr = make(tmp_path)
    assert tr.run() == "done" and tr.history[0]["step"] == 7
    assert bitwise(state_of(tr), baseline)


def test_max_rollbacks_raises(graph_task, tmp_path):
    """A fault that replay does not clear (a NaN in the weights the
    Trainer was given) is rolled back to re-init once, then refused."""
    model = GraphModel(_cfg(), device="cpu", seed=0)
    with torch.no_grad():
        model.head[0, 0] = float("nan")
    tr = Trainer(model, TrainerConfig(
        steps=STEPS, lr=1e-3, warmup=2, ckpt_every=EVERY,
        ckpt_dir=str(tmp_path), max_bad_steps=2, max_rollbacks=1),
        task=graph_task)
    with pytest.warns(RuntimeWarning, match="rolled back to verified "
                                            "checkpoint step 0"), \
            pytest.raises(RuntimeError, match="refusing to loop"):
        tr.run()
    assert [(r.at_step, r.to_step) for r in tr.rollbacks] == [(2, 0)]


def test_straggler_report_fires_on_a_slow_step(graph_task, monkeypatch):
    import time

    fast = graph_task.batches

    def slow(step):
        if step == 10:
            # the injected straggler: 5x the slowest step the EMA has
            # read, so it stands out however loaded the machine is
            time.sleep(max(1.0, 5 * max(h["seconds"]
                                        for h in tr.history[2:])))
        return fast(step)

    monkeypatch.setattr(graph_task, "batches", slow)
    tr = _factory(graph_task)(None)
    assert tr.run() == "done"
    assert any(r.step == 10 and r.seconds > 3 * r.ema
               for r in tr.stragglers), tr.stragglers


def test_crash_inside_the_update_writes_no_torn_state(graph_task, baseline,
                                                      tmp_path):
    """``preempt`` fires halfway through the in-place update. Without a
    rescue copy the crash save writes nothing: the directory keeps only
    the periodic checkpoint, which equals an unfaulted run's state at
    that step, and the restart resumes there, bitwise."""
    make = _factory(graph_task)
    tr = make(tmp_path, fault_plan="preempt@5")
    with pytest.raises(faults.Preempted, match="step 5"):
        tr.run()
    assert tr._torn and tr.fault_log == [{"kind": "preempt", "step": 5}]
    assert Checkpointer(str(tmp_path)).all_steps() == [4]
    # an unfaulted run's step-4 state (its crash save at a failure there)
    with pytest.raises(RuntimeError, match="injected failure at step 4"):
        make(tmp_path / "ref", fail_at_step=4).run()
    got = Checkpointer(str(tmp_path)).restore(4)
    want = Checkpointer(str(tmp_path / "ref")).restore(4)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tr2 = make(tmp_path)
    assert tr2.run() == "done" and tr2.history[0]["step"] == 5
    assert bitwise(state_of(tr2), baseline)


def test_crash_before_any_checkpoint_restarts_from_scratch(graph_task,
                                                           baseline,
                                                           tmp_path):
    make = _factory(graph_task, ckpt_every=100)
    with pytest.raises(faults.Preempted):
        make(tmp_path, fault_plan="preempt@3").run()
    assert Checkpointer(str(tmp_path)).all_steps() == []
    tr = make(tmp_path)
    assert tr.run() == "done" and tr.history[0]["step"] == 1
    assert bitwise(state_of(tr), baseline)


def test_chaos_cli_reports_five_recovered_and_two_waiting(tmp_path):
    import json

    report = tmp_path / "r.json"
    assert chaos_main(["--offline", "--device", "cpu", "--report",
                       str(report)]) == 0
    doc = json.loads(report.read_text())
    train = [f for f in doc["faults"] if f["kind"] != "burst"]
    assert [f["fault"] for f in train] == [
        "nonfinite_skip", "nonfinite_rollback", "preempt_rescued",
        "preempt_unrescued", "ckpt_corrupt"]
    assert all(f["recovered"] for f in train) and doc["ok"]
    assert [f["replay"] for f in train] == ["skip"] + ["exact"] * 4
    serve = [f for f in doc["faults"] if f["kind"] == "burst"]
    assert [(f["fault"], f["recovered"], f["replay"]) for f in serve] \
        == [("serve_overload", True, "n/a"), ("serve_deadline", True, "n/a")]
    assert doc["unrecovered"] == [] and "waiting_for" not in doc


def test_chaos_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        chaos_main(["--report", str(tmp_path / "r.json")])


# ---------------------------------------------- across the two packages

KW = dict(steps=6, lr=1e-3, warmup=2, interleave_period=2, elastic_every=0)


def _jtrainer(d, **kw):
    cfg = _cfg()
    jtask = JGraphLevelTask(
        jdataset(8, jcfgs.get_smoke_config("gt"), seed=1, **SMALL), cfg,
        batch_graphs=4)
    return JTrainer(build(cfg), JTrainerConfig(
        ckpt_dir=str(d), ckpt_every=100, attn_impl="ref", **KW, **kw),
        task=jtask)


def _ptrainer(d, **kw):
    cfg = _cfg()
    tree = jax.tree.map(lambda x: np.array(x, copy=True),
                        build(cfg).init(jax.random.PRNGKey(0)))
    model = GraphModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return Trainer(model, TrainerConfig(ckpt_dir=str(d), ckpt_every=100,
                                        **KW, **kw), task=_task())


@pytest.fixture(scope="module")
def full_runs(tmp_path_factory):
    """Both packages' uninterrupted 6-step runs: (losses, params as the
    port's state dict) each."""
    jtr = _jtrainer(tmp_path_factory.mktemp("jfull"))
    jstate, status = jtr.run()
    assert status == "done"
    ptr = _ptrainer(tmp_path_factory.mktemp("pfull"))
    assert ptr.run() == "done"
    return {"jax": ([h["loss"] for h in jtr.history], params_from_jax(
                jax.tree.map(np.asarray, jstate["params"]))),
            "port": ([h["loss"] for h in ptr.history],
                     {n: p.detach().clone()
                      for n, p in ptr.model.named_parameters()})}


@pytest.mark.parametrize("stops,resumes", [("jax", "port"),
                                            ("port", "jax")])
def test_cross_package_resume(full_runs, tmp_path, stops, resumes):
    """One package fails at step 3 (its crash save), the other restores
    that checkpoint and finishes; losses and parameters match the
    resuming package's own uninterrupted run."""
    first = (_jtrainer if stops == "jax" else _ptrainer)(
        tmp_path, fail_at_step=3)
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        first.run()
    assert JCheckpointer(str(tmp_path)).all_steps() == [3]
    second = (_jtrainer if resumes == "jax" else _ptrainer)(tmp_path)
    if resumes == "jax":
        state, status = second.run()
        params = params_from_jax(jax.tree.map(np.asarray, state["params"]))
    else:
        status = second.run()
        params = {n: p.detach() for n, p in second.model.named_parameters()}
    assert status == "done"
    assert [h["step"] for h in second.history] == [4, 5, 6]
    want_losses, want_params = full_runs[resumes]
    np.testing.assert_allclose([h["loss"] for h in second.history],
                               want_losses[3:], rtol=1e-4)
    assert sorted(params) == sorted(want_params)
    for name, w in want_params.items():
        np.testing.assert_allclose(params[name].numpy(), w.numpy(),
                                   atol=1e-4, err_msg=name)


def test_a_checkpoint_of_another_model_is_refused_whole(graph_task,
                                                        tmp_path):
    """Restoring a checkpoint whose names or shapes are not the model's
    raises before any tensor is written."""
    tr = _factory(graph_task)(tmp_path)
    tr.ckpt.save(4, tr.state_tree(), blocking=True)
    good = tr.ckpt.restore(4)
    before = state_of(tr)
    wrong_shape = jax.tree.map(lambda x: x, good)
    wrong_shape["opt"]["v"]["head"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="head has shape"):
        tr.load_state_tree(wrong_shape)
    missing = jax.tree.map(lambda x: x, good)
    del missing["params"]["head"]
    with pytest.raises(ValueError, match="head"):
        tr.load_state_tree(missing)
    assert bitwise(state_of(tr), before)
