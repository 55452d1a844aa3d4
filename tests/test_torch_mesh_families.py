"""The SSM and hybrid families trained on a mesh (``Trainer(...,
mesh=, recipe=)``, ``launch/train.py --mesh-model``) against the JAX
package's single-device functions, on the CPU; the VLM and enc-dec
families take this module's machinery in
``tests/test_torch_mesh_vlm_encdec.py``.

Ranks are spawned with ``torch.multiprocessing`` over gloo (a
``file://`` rendezvous under the test's temporary directory), a world
of 2 (a (1, 2) mesh) and one of 3, each rank on its share of this
worker's threads. Every model starts from the JAX init of its smoke
config (fp32), carried across by ``convert.params_from_jax``; the
batches are the same numpy arrays (``lm_batch``, and seeded N(0, 1)
patches and frames).

* The init step, on a (1, 2) mesh: Mamba2 (its 8 SSM heads split, 4 a
  rank) and Jamba (Mamba slots over their heads, the attention slot
  under Ulysses, the MoE slots expert parallel); on a 3-rank world
  Mamba2, whose 8 heads do not split 3 ways (the whole mixer on every
  rank). The loss equals ``jax.value_and_grad`` of the reference's loss
  (jitted) within 1e-5 relative, and every gradient (summed over the
  ranks) is within 1e-4 of the parameter's largest JAX entry, the bound
  of the families' single-device tests
  (``tests/test_torch_hybrid_loss.py``): fp32 gradients that cancel,
  such as a Mamba2 block's ``d_skip``, already sit ~1e-5 from JAX's on
  one process.
* Four steps of the train CLI on Mamba2 at P = 2 and 3 and on Jamba at
  P = 2 (each rank holding its experts) against the JAX CLI, within 1e-4
  (the reference's bound, ``tests/test_distributed.py``); the port's
  CLI starts from the JAX init, given to it as a step-0 checkpoint.
* At these batches Jamba's expert-parallel MoE drops no pair (each
  expert's load stays under its capacity), so it computes the dropless
  function the single-device reference does: the test counts the drops
  and asserts there are none.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch

from test_torch_threads import worker_share

TOL_LOSS = 1e-4      # per-step losses (the reference's bound)
TOL_INIT = 1e-5      # the init loss, relative
TOL_GRAD = 1e-4      # init gradients, of the largest entry of the JAX one
B = 2

# every case: name -> (arch, attn backend, tokens, patches or frames (0:
# none)); the VLM and enc-dec ones run in test_torch_mesh_vlm_encdec.py
CASES = {"mamba2": ("mamba2_2_7b", "dense", 96, 0),
         "jamba": ("jamba_v0_1_52b", "dense", 128, 0),
         "vlm": ("internvl2_76b", "dense", 24, 40),
         "vlm_sparse": ("internvl2_76b", "cluster_sparse", 248, 8),
         "encdec": ("seamless_m4t_medium", "dense", 64, 32),
         "encdec_sparse": ("seamless_m4t_medium", "cluster_sparse", 256,
                           256)}
# this module's runs: world -> {"init": cases, "cli": cases, "train":
# cases (four Trainer steps against the JAX Trainer)}
RUNS = {2: {"init": ("mamba2", "jamba"), "cli": ("mamba2", "jamba"),
            "train": ()},
        3: {"init": ("mamba2",), "cli": ("mamba2",), "train": ()}}


def _cfg(name):
    arch, backend, _, _ = CASES[name]
    return get_smoke_config(arch).replace(dtype="float32",
                                          attn_backend=backend)


def _batch(name, step=0):
    """The numpy batch of case ``name`` at ``step``."""
    arch, _, T, extra = CASES[name]
    cfg = _cfg(name)
    b = lm_batch(LMDataConfig(cfg.vocab_size, T, B), step)
    if extra:
        rng = np.random.default_rng(100 + step)
        key = "patches" if cfg.family == "vlm" else "frames"
        b[key] = rng.standard_normal((B, extra, cfg.d_model)).astype(
            np.float32)
    return b


def _cli_argv(name):
    arch, _, seq, _ = CASES[name]
    return ["--arch", arch, "--smoke", "--steps", "4", "--seq", str(seq),
            "--batch", str(B), "--dtype", "float32"]


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


# ------------------------------------------------------------ rank bodies

def _count_drops():
    """Wrap the expert-parallel MoE so that every call's dropped pairs
    are counted; returns the list they go into and the unwrapping."""
    from repro_torch.models import moe as tmoe

    real, drops = tmoe._ep_local, []

    def counting(*a, **kw):
        got = real(*a, **kw)
        drops.append(int(tmoe.LAST_CALL["dropped"]))
        return got
    tmoe._ep_local = counting
    return drops, lambda: setattr(tmoe, "_ep_local", real)


def _task(name):
    from repro_torch.tasks import BatchFnTask

    return BatchFnTask(lambda s: _batch(name, s))


def _mesh(world, name):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import recipe_for

    mesh = make_host_mesh(model=world)
    arch, _, T, extra = CASES[name]
    seq = T + (extra if _cfg(name).family == "vlm" else 0)
    return mesh, recipe_for(ShapeConfig("t", "train", seq, B), mesh)


def _init_grads(name, state, world):
    """The loss and gradients (summed over the world) of the model on
    this rank's shard of the step-0 batch."""
    from repro_torch.models.api import lm_model_class

    cfg = _cfg(name)
    model = lm_model_class(cfg)(cfg, device="cpu")
    model.load_state_dict(state)
    mesh, recipe = _mesh(world, name)
    task = _task(name).prepare(model, mesh, recipe)
    with task.context():      # the backward recomputes layers under it
        loss, _ = model.loss_variants["sparse"](model, task.batches(0))
        grads = torch.autograd.grad(loss, list(model.parameters()))
    for g in grads:
        dist.all_reduce(g)
    names = [n for n, _ in model.named_parameters()]
    return {"loss": loss.item(), "grads": dict(zip(names, grads))}


def _trainer_losses(name, state, world):
    """Four Trainer steps of the model on the mesh."""
    from repro_torch.models.api import lm_model_class
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = _cfg(name)
    model = lm_model_class(cfg)(cfg, device="cpu")
    model.load_state_dict(state)
    mesh, recipe = _mesh(world, name)
    tr = Trainer(model, TrainerConfig(steps=4, lr=1e-3, warmup=1),
                 task=_task(name), mesh=mesh, recipe=recipe)
    assert tr.run() == "done"
    return [h["loss"] for h in tr.history]


def _world(rank, world, states, runs, ckpts):
    from repro_torch.launch import train as train_cli

    drops, unwrap = _count_drops()
    out = {"init": {}, "cli": {}, "train": {}}
    for name in runs["init"]:
        out["init"][name] = _init_grads(name, states[name], world)
    for name in runs["cli"]:
        out["cli"][name] = [h["loss"] for h in train_cli.main(
            _cli_argv(name) + ["--mesh-model", str(world), "--backend",
                               "gloo", "--device", "cpu", "--ckpt-dir",
                               str(ckpts[name])]).history]
    for name in runs["train"]:
        out["train"][name] = _trainer_losses(name, states[name], world)
    unwrap()
    out["ep_calls"], out["dropped"] = len(drops), sum(drops)
    return out


# ------------------------------------------------------------ fixtures

def _jax_model(name):
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import build

    arch, backend, _, _ = CASES[name]
    return build(jsmoke(arch).replace(dtype="float32", attn_backend=backend))


def _jax_init(name):
    """``(tree, loss, gradient tree)`` of the reference at its init on the
    step-0 batch."""
    import jax
    import jax.numpy as jnp

    model = _jax_model(name)
    tree = jax.tree.map(lambda x: np.array(x, copy=True),
                        model.init(jax.random.PRNGKey(0)))
    b = {k: jnp.asarray(v) for k, v in _batch(name).items()}
    (loss, _), g = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
        tree, b)
    return tree, float(loss), jax.tree.map(np.asarray, g)


def collect(tmp_path_factory, runs) -> dict:
    """The JAX references and every world's ranks for ``runs`` (as
    :data:`RUNS`)."""
    from repro.launch import train as jtrain
    from repro.runtime.trainer import Trainer as JTrainer
    from repro.runtime.trainer import TrainerConfig as JTrainerConfig

    tmp = tmp_path_factory.mktemp("families")
    out = {"jax_init": {}, "jax_cli": {}, "jax_train": {}}
    states, trees = {}, {}
    every = lambda kind: sorted({n for r in runs.values()  # noqa: E731
                                 for n in r[kind]})
    for name in sorted({*every("init"), *every("cli"), *every("train")}):
        trees[name], loss, grads = _jax_init(name)
        states[name] = params_from_jax(trees[name])
        out["jax_init"][name] = (loss, params_from_jax(grads))
    for name in every("cli"):
        out["jax_cli"][name] = [h["loss"] for h in jtrain.main(
            _cli_argv(name) + ["--ckpt-dir", str(tmp / f"jax_{name}")]
        ).history]
    for name in every("train"):
        tr = JTrainer(_jax_model(name), JTrainerConfig(
            steps=4, lr=1e-3, warmup=1, ckpt_dir=str(tmp / f"jt_{name}")),
            lambda s, n=name: _batch(n, s))
        tr.run()
        out["jax_train"][name] = [h["loss"] for h in tr.history]
    for world, r in runs.items():
        ckpts = {n: tmp / f"port_{n}_p{world}" for n in r["cli"]}
        for n, path in ckpts.items():
            _step0(trees[n], path)
        out[world] = spawn(_world, world,
                           tmp_path_factory.mktemp(f"w{world}"), states, r,
                           ckpts)
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


def check_init(runs, world, name):
    jloss, want = runs["jax_init"][name]
    for r in runs[world]:
        got = r["init"][name]
        np.testing.assert_allclose(got["loss"], jloss, rtol=TOL_INIT)
        assert sorted(got["grads"]) == sorted(want)
        for k, w in want.items():
            w = w.numpy()
            err = np.abs(got["grads"][k].numpy() - w).max()
            assert err <= TOL_GRAD * max(np.abs(w).max(), 1e-6), (k, err)


def check_steps(runs, world, name, kind):
    want = runs[f"jax_{kind}"][name]
    assert len(want) == 4
    for r in runs[world]:
        np.testing.assert_allclose(r[kind][name], want, rtol=0,
                                   atol=TOL_LOSS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return collect(tmp_path_factory, RUNS)


# ------------------------------------------------------------ tests

@pytest.mark.parametrize("world,name", [(w, n) for w, r in RUNS.items()
                                        for n in r["init"]])
def test_init_loss_and_grads_on_mesh_match_jax(runs, world, name):
    check_init(runs, world, name)


@pytest.mark.parametrize("world,name", [(w, n) for w, r in RUNS.items()
                                        for n in r["cli"]])
def test_cli_mesh_losses_match_jax_cli(runs, world, name):
    check_steps(runs, world, name, "cli")


def test_jamba_expert_parallel_drops_nothing_here(runs):
    """The precondition of holding Jamba's mesh runs to the dropless
    reference: its expert-parallel calls ran and dropped no pair."""
    for r in runs[2]:
        assert r["ep_calls"] > 0 and r["dropped"] == 0
