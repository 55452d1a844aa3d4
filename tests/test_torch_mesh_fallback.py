"""What the mesh runs where the reference falls back, and checkpoints of
an expert-parallel model, on the CPU.

Ranks are spawned with ``torch.multiprocessing`` over gloo (a
``file://`` rendezvous under the test's temporary directory), each rank
on its share of this worker's threads.

* The graph fallback (``core/graph_model.py``): GT smoke on a 3-rank
  world, whose 4 heads do not split 3 ways, through the train CLI
  (``sharded_cluster_attention=OFF (shape cannot shard; GSPMD
  fallback)``), 4 steps with the dense interleave at steps 1 and 3:
  ``--task graph`` (S = 128) and ``--task link`` (S = 160), sequences
  that do not split 3 ways either, so every rank runs the whole
  sequence; and the node task at S = 192, whose sequence splits (64 a
  rank) while its heads do not, so each rank all-gathers q, k and v and
  keeps its rows of the unsharded op. Every rank's losses equal the JAX
  CLI's within 1e-4 (the reference's bound,
  ``tests/test_distributed.py``), from the JAX init given as a step-0
  checkpoint.
* Checkpoints of an expert-parallel model: Qwen3-235B-A22B smoke with 4
  experts, every token routed to all 4 (top-k 4), so that nothing drops
  and the expert-parallel path computes the same function as the
  single-rank one; each of 2 ranks holds its 2 experts
  (``experts=(m, 2)``), fp32 and int8 moments. Saved at step 2 of a
  4-step run at P = 2 and resumed at P = 2, the next two losses equal
  the unbroken run's exactly; the saved leaves are byte for byte those
  a P = 1 trainer writes when it holds the same parameters and moments
  (assembled here from each rank's parts, the int8 blocks layer by
  layer), a P = 1 trainer (a model holding every expert) restores
  exactly that state from it, and the reference's ``Checkpointer``
  reads it. Resumed at P = 1, the next loss is the unbroken run's
  within 1e-5, and with fp32 moments so is the one after it, as are an
  unbroken P = 1 run's four. With int8 moments P = 1 and P = 2 part
  after an update, checkpoint or not: the fp32 gradients sum in another
  order, and a second moment that rounds to another int8 level (or to
  0, where the update is then divided by eps) moves the parameters far
  apart; the state the P = 1 run resumes from is held bitwise instead.
"""

import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.convert import leaf_groups, params_from_jax
from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch

from test_torch_threads import worker_share

TOL_LOSS = 1e-4      # per-step losses (the reference's bound)
TOL_P1 = 1e-5        # the same function at P = 1

COMMON = ["--arch", "gt", "--smoke", "--steps", "4", "--elastic-every",
          "0", "--interleave-period", "2", "--dtype", "float32"]
TASKS = {"graph": ["--task", "graph", "--graphs", "8", "--batch-graphs",
                   "4"],
         "link": ["--task", "link", "--graph-nodes", "128"],
         "node": ["--task", "node", "--graph-nodes", "191"]}
SEQ = {"graph": 128, "link": 160, "node": 192}
MOMENTS = ("float32", "int8")
LM_SEQ, LM_BATCH = 64, 2


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
    share of this worker's threads; each rank's returned value."""
    import torch.multiprocessing as mp

    threads = max(1, (worker_share() or world) // world)
    mp.spawn(_child, args=(fn, world, str(tmp), threads, args),
             nprocs=world, join=True)
    return [torch.load(f"{tmp}/rank{r}.pt") for r in range(world)]


# ------------------------------------------------------------ graph

def _graph_world(rank, world, ckpts):
    from repro_torch.core import graph_model as tgm
    from repro_torch.launch import train as train_cli

    real, seqs = tgm.kops.cluster_attention, []

    def seen(q, *a, **kw):        # the sequence each unsharded call runs
        seqs.append(q.shape[1])
        return real(q, *a, **kw)
    tgm.kops.cluster_attention = seen
    out = {}
    try:
        for task, argv in TASKS.items():
            seqs.clear()
            tr = train_cli.main(COMMON + argv + [
                "--mesh-model", str(world), "--backend", "gloo", "--device",
                "cpu", "--ckpt-dir", str(ckpts[task])])
            out[task] = {"loss": [h["loss"] for h in tr.history],
                         "variant": [h["variant"] for h in tr.history],
                         "seq_sharded": tr.task.seq_sharded,
                         "op_seqs": sorted(set(seqs))}
    finally:
        tgm.kops.cluster_attention = real
    return out


def _step0(tree, path):
    """A step-0 checkpoint of ``tree`` (fresh moments), as the port's
    trainer restores it."""
    from repro_torch.ckpt.checkpoint import Checkpointer

    zeros = lambda t: {k: zeros(v) if isinstance(v, dict)  # noqa: E731
                       else np.zeros_like(v) for k, v in t.items()}
    Checkpointer(str(path)).save(0, {
        "params": tree, "opt": {"m": zeros(tree), "v": zeros(tree),
                                "step": np.int32(0)},
        "step": np.int32(0), "bad": np.int32(0)}, blocking=True)


@pytest.fixture(scope="module")
def graph_runs(tmp_path_factory):
    import jax

    from repro.configs import get_smoke_config as jsmoke
    from repro.launch import train as jtrain
    from repro.models import build

    tmp = tmp_path_factory.mktemp("fallback")
    tree = jax.tree.map(lambda x: np.array(x, copy=True), build(
        jsmoke("gt").replace(dtype="float32")).init(jax.random.PRNGKey(0)))
    ckpts = {}
    out = {"jax": {}}
    for task, argv in TASKS.items():
        ckpts[task] = tmp / f"port_{task}"
        _step0(tree, ckpts[task])
        out["jax"][task] = [h["loss"] for h in jtrain.main(
            COMMON + argv + ["--attn-impl", "ref", "--ckpt-dir",
                             str(tmp / f"jax_{task}")]).history]
    out["ranks"] = spawn(_graph_world, 3, tmp_path_factory.mktemp("w3"),
                         ckpts)
    return out


@pytest.mark.parametrize("task", list(TASKS))
def test_graph_fallback_cli_matches_jax_cli(graph_runs, task):
    want = graph_runs["jax"][task]
    assert len(want) == 4
    for r in graph_runs["ranks"]:
        got = r[task]
        assert got["variant"] == ["dense", "sparse"] * 2
        np.testing.assert_allclose(got["loss"], want, rtol=0, atol=TOL_LOSS)
        # the sparse steps ran the unsharded op on the whole sequence:
        # gathered where the sequence splits 3 ways, else kept whole
        assert got["seq_sharded"] == (SEQ[task] % 3 == 0)
        assert got["op_seqs"] == [SEQ[task]]


# ------------------------------------------------------------ experts

def _moe_cfg():
    return get_smoke_config("qwen3_moe_235b_a22b").replace(
        dtype="float32", moe_experts=4, moe_top_k=4)


def _moe_trainer(state_dtype, steps, ckpt_dir, mesh: bool, every=2):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LMModel
    from repro_torch.parallel.sharding import recipe_for
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tasks import BatchFnTask

    cfg = _moe_cfg()
    kw, m, recipe = {}, None, None
    if mesh:
        m = make_host_mesh(model=dist.get_world_size())
        recipe = recipe_for(ShapeConfig("t", "train", LM_SEQ, LM_BATCH), m)
        kw["experts"] = (dist.get_rank(), dist.get_world_size())
    model = LMModel(cfg, device="cpu", seed=0, **kw)
    dc = LMDataConfig(cfg.vocab_size, LM_SEQ, LM_BATCH)
    return Trainer(model, TrainerConfig(
        steps=steps, lr=1e-3, warmup=1, state_dtype=state_dtype,
        ckpt_dir=None if ckpt_dir is None else str(ckpt_dir),
        ckpt_every=every), task=BatchFnTask(lambda s: lm_batch(dc, s)),
        mesh=m, recipe=recipe)


def _losses(tr):
    assert tr.run() == "done"
    return [h["loss"] for h in tr.history]


def _moe_world(rank, world, dirs):
    out = {}
    for sd in MOMENTS:
        d = dirs[sd]
        unbroken = _losses(_moe_trainer(sd, 4, d["unbroken"], True))
        dist.barrier()
        if rank == 0:     # the step-2 generation alone, to resume from
            shutil.copytree(d["unbroken"] / "step_00000002",
                            d["resume"] / "step_00000002")
        dist.barrier()
        resumed = _losses(_moe_trainer(sd, 4, d["resume"], True))
        # this rank's live parts at step 2 of the same 4-step schedule,
        # for the P = 1 save
        tr = _moe_trainer(sd, 4, None, True)
        for step in range(2):
            tr.step("sparse", tr.task.batches(step))
        opt = tr.opt.state_dict()
        out[sd] = {"unbroken": unbroken, "resumed": resumed,
                   "names": tr.names,
                   "params": [p.detach().clone() for p in tr.params],
                   "m": opt["m"], "v": opt["v"], "opt_step": opt["step"]}
    return out


def _assemble(ranks, sd):
    """Each parameter and moment whole, from every rank's parts: the
    expert stacks' parts concatenated in rank order; an int8 moment's
    blocks layer by layer, each layer's parts in rank order."""
    names = ranks[0][sd]["names"]
    parted = [".moe.w_" in n for n in names]
    cat = lambda xs: torch.cat(xs) if len(xs) > 1 else xs[0]  # noqa: E731
    params = [cat([r[sd]["params"][i] for r in ranks]) if parted[i]
              else ranks[0][sd]["params"][i] for i in range(len(names))]
    moments = {}
    for key in ("m", "v"):
        if sd != "int8":
            moments[key] = [cat([r[sd][key][i] for r in ranks]) if parted[i]
                            else ranks[0][sd][key][i]
                            for i in range(len(names))]
            continue
        out = []
        for k, (_, idx) in enumerate(leaf_groups(names)):
            qs = ranks[0][sd][key][k]
            if parted[idx[0]]:
                qs = {f: torch.cat([r[sd][key][k][f].view(
                    len(idx), -1, qs[f].shape[-1])[layer] for layer in
                    range(len(idx)) for r in ranks]) for f in ("q", "s")}
            out.append(qs)
        moments[key] = out
    return params, moments


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ckpt")
    dirs = {sd: {k: tmp / f"{sd}_{k}" for k in ("unbroken", "resume")}
            for sd in MOMENTS}
    ranks = spawn(_moe_world, 2, tmp_path_factory.mktemp("w2"), dirs)
    out = {"ranks": ranks, "dirs": dirs, "p1": {}}
    for sd in MOMENTS:
        p1 = tmp / f"{sd}_p1"
        shutil.copytree(dirs[sd]["unbroken"] / "step_00000002",
                        p1 / "step_00000002")
        params, moments = _assemble(ranks, sd)
        tr = _moe_trainer(sd, 4, p1, False)
        assert tr.restore_or_init() == 2
        opt = tr.opt.state_dict()
        out["p1"][sd] = {
            "restored": all(torch.equal(a, b) for a, b in zip(
                tr.params, params)) and _moments_equal(
                    opt, moments, sd),
            "resumed": _losses(tr),
            "unbroken": _losses(_moe_trainer(sd, 4, None, False))}
        # a P = 1 trainer holding the ranks' step-2 state writes its save
        tr = _moe_trainer(sd, 4, tmp / f"{sd}_p1_save", False)
        with torch.no_grad():
            for p, w in zip(tr.params, params):
                p.copy_(w)
        tr.opt.load_state_dict({**moments,
                                "step": ranks[0][sd]["opt_step"]})
        tr.steps_done = 2
        tr._save(2, blocking=True)
    return out


def _moments_equal(opt, moments, sd) -> bool:
    flat = lambda ts: [x for t in ts for x in  # noqa: E731
                       ((t["q"], t["s"]) if sd == "int8" else (t,))]
    return all(torch.equal(a, b) for key in ("m", "v")
               for a, b in zip(flat(opt[key]), flat(moments[key])))


def _leaf_files(d):
    import json

    with open(os.path.join(d, "manifest.json")) as fh:
        leaves = json.load(fh)["leaves"]
    out = {}
    for name, meta in leaves.items():
        with open(os.path.join(d, meta["file"]), "rb") as fh:
            out[name] = (meta["shape"], meta["dtype"], meta["crc32"],
                         fh.read())
    return out


@pytest.mark.parametrize("sd", MOMENTS)
def test_expert_part_checkpoint_resumes_at_p2_exactly(moe_runs, sd):
    for r in moe_runs["ranks"]:
        got = r[sd]
        assert len(got["unbroken"]) == 4 and len(got["resumed"]) == 2
        assert got["resumed"] == got["unbroken"][2:]


@pytest.mark.parametrize("sd", MOMENTS)
def test_expert_part_checkpoint_resumes_at_p1(moe_runs, sd):
    want = moe_runs["ranks"][0][sd]["unbroken"]
    p1 = moe_runs["p1"][sd]
    assert p1["restored"]
    assert len(p1["resumed"]) == 2
    np.testing.assert_allclose(p1["resumed"][0], want[2], rtol=TOL_P1)
    if sd == "float32":
        np.testing.assert_allclose(p1["resumed"], want[2:], rtol=TOL_P1)
        np.testing.assert_allclose(p1["unbroken"], want, rtol=TOL_P1)


@pytest.mark.parametrize("sd", MOMENTS)
def test_expert_part_checkpoint_bytes_equal_a_p1_save(moe_runs, tmp_path,
                                                     sd):
    d = moe_runs["dirs"][sd]["unbroken"]
    got = _leaf_files(d / "step_00000002")
    want = _leaf_files(d.parent / f"{sd}_p1_save" / "step_00000002")
    assert sorted(got) == sorted(want)
    assert any("moe" in k for k in got)
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("sd", MOMENTS)
def test_expert_part_checkpoint_read_by_reference(moe_runs, sd):
    from repro.ckpt.checkpoint import Checkpointer as JCheckpointer

    from repro_torch.convert import params_to_jax

    tree = JCheckpointer(str(moe_runs["dirs"][sd]["unbroken"])).restore(2)
    got = params_from_jax(jax_numpy(tree["params"]))
    params, _ = _assemble(moe_runs["ranks"], sd)
    names = moe_runs["ranks"][0][sd]["names"]
    assert sorted(got) == sorted(names)
    for n, w in zip(names, params):
        assert torch.equal(got[n], w), n
    want = params_to_jax(dict(zip(names, params)))
    assert tree["params"]["layers"]["moe"]["w_gate"].shape == \
        tuple(want["layers"]["moe"]["w_gate"].shape)
    m = tree["opt"]["m"]["layers"]["moe"]["w_gate"]
    if sd == "int8":
        assert sorted(m) == ["q", "s"]
    else:
        assert m.shape == tuple(want["layers"]["moe"]["w_gate"].shape)


def jax_numpy(tree):
    """A restored JAX tree's leaves as numpy arrays."""
    return {k: jax_numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}
