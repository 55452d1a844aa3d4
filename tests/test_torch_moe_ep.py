"""Expert parallelism on the port (``models/moe.py``'s ``_ep_local`` and
the mesh branch of ``moe_apply``; the MoE LM on a mesh) against the JAX
package, on the CPU.

The reference's expert-parallel path runs under a 2-device fake mesh in
a subprocess (``_subproc.run_code(..., devices=2)``), which writes its
arrays to a file; the port's runs in a world of 2 gloo ranks (a (1, 2)
mesh, the train recipe: the tokens sequence-sharded over "model", each
rank owning 4 of the 8 experts), each rank on its share of this
worker's threads. Inputs are seeded numpy arrays; parameters one draw
carried across by ``convert.params_from_jax``.

* At capacity factor 8 nothing drops: the port's output equals the
  reference's dropless ``moe_tokens`` within 1e-4 (the reference's own
  bound, ``tests/test_distributed.py:test_moe_ep_matches_oracle_under_mesh``).
* At 1.25 pairs drop: the port's output, aux term and the gradients of
  ``sum(y * g) + aux`` (the MoE's parameters and x) equal the reference's
  ``moe_apply`` under the mesh within 1e-5 (y, aux) and 1e-4 of the
  largest entry (gradients), and the pairs dropped over the ranks equal
  a host recount from the routing.
* The MoE LM (Qwen3-235B-A22B smoke, fp32, Ulysses attention, expert
  parallel FFN, the routing replayed under recomputation): loss and
  every gradient equal the reference's under the mesh within 1e-4; a
  model holding only each rank's experts (``experts=(m, 2)``) gives the
  same loss and the rows of the same gradients, and its seeded init is
  the rows of the whole one's; ``launch/train.py`` trains it on the mesh.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax

from test_torch_threads import worker_share

TOL_Y = 1e-5
TOL_GRAD = 1e-4
TOL_DROPLESS = 1e-4
B, S = 4, 16             # the op's tokens: T = 64 a model group
LM_SEQ, LM_BATCH = 64, 2

REFERENCE = """
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.models import build
from repro.models.moe import moe_apply, moe_tokens
from repro.parallel.axes import axis_rules
from repro.parallel.sharding import recipe_for

IN, OUT = {paths!r}
inp = dict(np.load(IN))

def tree(prefix):
    out = {{}}
    for k, v in inp.items():
        if k.startswith(prefix):
            node = out
            *path, last = k[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {{}})
            node[last] = jnp.asarray(v)
    return out

def flat(t, prefix, out):
    for k, v in t.items():
        if isinstance(v, dict):
            flat(v, prefix + k + "/", out)
        else:
            out[prefix + k] = np.asarray(v)
    return out

res = {{}}
mesh = compat.make_mesh((1, 2), ("data", "model"))
kw = dict(d_model=32, moe_experts=8, moe_top_k=2, moe_d_ff=48,
          moe_shared_experts=0, dtype="float32")
cfg = get_smoke_config("qwen3_moe_235b_a22b").replace(**kw)
p, x, g = tree("moe/"), jnp.asarray(inp["x"]), jnp.asarray(inp["g"])
recipe = recipe_for(ShapeConfig("t", "train", x.shape[1], x.shape[0]), mesh)
res["y_dropless"] = np.asarray(moe_tokens(p, cfg, x.reshape(-1, 32))[0])

def obj(pp, xx):
    with axis_rules(recipe, mesh):
        y, aux = moe_apply(pp, cfg, xx, capacity_factor=1.25)
    return jnp.sum(y * g) + aux, (y, aux)

with compat.use_mesh(mesh):
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True))(p, x)
res["y"], res["aux"], res["gx"] = np.asarray(y), np.asarray(aux), np.asarray(gx)
flat(gp, "gmoe/", res)

lcfg = get_smoke_config("qwen3_moe_235b_a22b").replace(dtype="float32")
model = build(lcfg)
batch = {{"tokens": jnp.asarray(inp["tokens"]),
          "labels": jnp.asarray(inp["labels"])}}
lrecipe = recipe_for(ShapeConfig("t", "train", {seq}, {batch}), mesh)

def lm_obj(pp):
    with axis_rules(lrecipe, mesh):
        return model.loss(pp, batch)

with compat.use_mesh(mesh):
    (loss, met), lg = jax.jit(jax.value_and_grad(lm_obj, has_aux=True))(
        tree("lm/"))
res["lm_loss"] = np.asarray(loss)
res["lm_aux"] = np.asarray(met["aux"])
flat(lg, "glm/", res)
np.savez(OUT, **res)
print("REFERENCE_OK")
"""


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
    import torch.multiprocessing as mp

    threads = max(1, (worker_share() or world) // world)
    mp.spawn(_child, args=(fn, world, str(tmp), threads, args),
             nprocs=world, join=True)
    return [torch.load(f"{tmp}/rank{r}.pt") for r in range(world)]


# ------------------------------------------------------------ the cases

def _moe_cfg():
    return get_smoke_config("qwen3_moe_235b_a22b").replace(
        d_model=32, moe_experts=8, moe_top_k=2, moe_d_ff=48,
        moe_shared_experts=0, dtype="float32")


def _lm_cfg():
    return get_smoke_config("qwen3_moe_235b_a22b").replace(dtype="float32")


def _inputs():
    """The op's params, x and cotangent, the LM's JAX init and batch."""
    import jax

    from repro.configs import get_smoke_config as jsmoke
    from repro.models import build
    from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch
    from repro_torch.models.moe import moe_defs

    rng = np.random.default_rng(0)
    cfg = _moe_cfg()
    moe = {}
    for name, (shape, _) in moe_defs(cfg).items():
        moe[name] = (rng.standard_normal(shape)
                     / np.sqrt(shape[-2])).astype(np.float32)
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    lm = jax.tree.map(
        lambda a: np.array(a, copy=True),
        build(jsmoke("qwen3_moe_235b_a22b").replace(dtype="float32")).init(
            jax.random.PRNGKey(0)))
    batch = lm_batch(LMDataConfig(_lm_cfg().vocab_size, LM_SEQ, LM_BATCH), 0)
    return moe, x, g, lm, batch


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _tree(flat, prefix):
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            node = out
            *path, last = k[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[last] = np.array(v)
    return out


# ------------------------------------------------------------ rank body

def _shard(x, rank, world, dim=1):
    n = x.shape[dim] // world
    return x.narrow(dim, rank * n, n)


def _world(rank, world, moe_state, x, g, lm_state, batch):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as tmoe
    from repro_torch.models.lm import LMModel, lm_loss
    from repro_torch.parallel.axes import axis_rules
    from repro_torch.parallel.sharding import recipe_for

    cfg = _moe_cfg()
    mesh = make_host_mesh(model=world)
    recipe = recipe_for(ShapeConfig("t", "train", S, B), mesh)
    p = tmoe.MoE(cfg, device="cpu")
    p.load_state_dict(moe_state)
    out = {}
    xl = _shard(torch.from_numpy(x), rank, world).clone()
    with axis_rules(recipe, mesh), torch.no_grad():
        out["y8"] = tmoe.moe_apply(p, cfg, xl, capacity_factor=8.0)[0]
    xl.requires_grad_()
    with axis_rules(recipe, mesh):
        y, aux = tmoe.moe_apply(p, cfg, xl, capacity_factor=1.25)
        dropped = tmoe.LAST_CALL["dropped"].clone()
        obj = (y * _shard(torch.from_numpy(g), rank, world)).sum() + aux
    names = [n for n, _ in p.named_parameters()]
    grads = torch.autograd.grad(obj, list(p.parameters()) + [xl])
    for gr in grads[:-1]:
        dist.all_reduce(gr)
    dist.all_reduce(dropped)
    out.update(y=y.detach(), aux=aux.item(), gx=grads[-1],
               gmoe=dict(zip(names, grads[:-1])), dropped=int(dropped),
               recount=tmoe.dropped_pairs(p, cfg, torch.from_numpy(
                   x).reshape(-1, cfg.d_model), world, 1.25))

    # the MoE LM, whole expert stacks and each rank's own
    lcfg = _lm_cfg()
    lrecipe = recipe_for(ShapeConfig("t", "train", LM_SEQ, LM_BATCH), mesh)
    tb = {k: _shard(torch.from_numpy(np.array(v)).long(), rank, world)
          for k, v in batch.items()}
    e = lcfg.moe_experts // world
    part = {k: v[rank * e:(rank + 1) * e] if ".moe.w_" in k else v
            for k, v in lm_state.items()}
    for key, state, kw in (("lm", lm_state, {}),
                           ("lm_part", part, {"experts": (rank, world)})):
        model = LMModel(lcfg, device="cpu", **kw)
        model.load_state_dict(state)
        with axis_rules(lrecipe, mesh):   # the backward recomputes layers
            loss, met = lm_loss(model, tb)
            lg = torch.autograd.grad(loss, list(model.parameters()))
        names = [n for n, _ in model.named_parameters()]
        for name, gr in zip(names, lg):
            if ".moe.w_" not in name or key == "lm":
                dist.all_reduce(gr)
        out[key] = {"loss": loss.item(), "aux": met["aux"].item(),
                    "grads": dict(zip(names, lg))}
    from repro_torch.runtime import trainer as trainer_mod

    argv = ["--arch", "qwen3_moe_235b_a22b", "--smoke", "--steps", "3",
            "--seq", str(LM_SEQ), "--batch", str(LM_BATCH), "--mesh-model",
            str(world), "--backend", "gloo", "--device", "cpu"]
    out["cli"] = [h["loss"] for h in train_cli.main(argv).history]
    # gradient buckets small enough that some gradients reduce in place
    real = trainer_mod.REDUCE_BUCKET
    trainer_mod.REDUCE_BUCKET = 4096
    try:
        out["cli_buckets"] = [h["loss"] for h in
                              train_cli.main(argv).history]
    finally:
        trainer_mod.REDUCE_BUCKET = real
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from _subproc import run_code

    tmp = tmp_path_factory.mktemp("moe_ep")
    moe, x, g, lm, batch = _inputs()
    inp = {"x": x, "g": g, "tokens": batch["tokens"],
           "labels": batch["labels"]}
    inp.update({"moe/" + k.replace(".", "/"): v for k, v in moe.items()})
    inp.update({"lm/" + k: v for k, v in _flat(lm).items()})
    paths = (str(tmp / "in.npz"), str(tmp / "out.npz"))
    np.savez(paths[0], **inp)
    assert "REFERENCE_OK" in run_code(REFERENCE.format(
        paths=paths, seq=LM_SEQ, batch=LM_BATCH), devices=2)
    ref = dict(np.load(paths[1]))
    moe_state = {k: torch.from_numpy(v) for k, v in moe.items()}
    ranks = spawn(_world, 2, tmp_path_factory.mktemp("w2"), moe_state, x,
                  g, params_from_jax(lm), batch)
    return {"ref": ref, "ranks": ranks}


def _check_grads(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = w.numpy()
        err = np.abs(got[k].numpy() - w).max()
        assert err <= TOL_GRAD * max(np.abs(w).max(), 1e-6), (k, err)


# ------------------------------------------------------------ tests

def test_ep_at_cf8_matches_dropless_moe_tokens(runs):
    want = runs["ref"]["y_dropless"].reshape(B, S, -1)
    got = np.concatenate([r["y8"].numpy() for r in runs["ranks"]], 1)
    assert np.abs(got - want).max() < TOL_DROPLESS


def test_ep_at_cf125_matches_reference_drops_included(runs):
    ref, ranks = runs["ref"], runs["ranks"]
    y = np.concatenate([r["y"].numpy() for r in ranks], 1)
    np.testing.assert_allclose(y, ref["y"], rtol=0,
                               atol=TOL_Y * np.abs(ref["y"]).max())
    # drops change the output: the dropless one is far from it
    assert np.abs(ref["y"] - ref["y_dropless"].reshape(y.shape)).max() > \
        1e-2
    for r in ranks:
        assert abs(r["aux"] - float(ref["aux"])) < TOL_Y
        _check_grads(r["gmoe"], params_from_jax(_tree(ref, "gmoe/")))
    gx = np.concatenate([r["gx"].numpy() for r in ranks], 1)
    np.testing.assert_allclose(gx, ref["gx"], rtol=0,
                               atol=TOL_GRAD * np.abs(ref["gx"]).max())


def test_dropped_pairs_equal_a_host_recount(runs):
    for r in runs["ranks"]:
        assert r["dropped"] == r["recount"] > 0


def test_moe_lm_loss_and_grads_on_mesh_match_jax(runs):
    ref = runs["ref"]
    want = params_from_jax(_tree(ref, "glm/"))
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["lm"]["loss"], float(ref["lm_loss"]),
                                   rtol=TOL_GRAD)
        np.testing.assert_allclose(r["lm"]["aux"], float(ref["lm_aux"]),
                                   rtol=TOL_GRAD)
        _check_grads(r["lm"]["grads"], want)


def test_expert_part_storage_matches_whole_stacks(runs):
    ranks = runs["ranks"]
    for m, r in enumerate(ranks):
        whole, part = r["lm"], r["lm_part"]
        assert part["loss"] == pytest.approx(whole["loss"], rel=1e-6)
        e = _lm_cfg().moe_experts // len(ranks)
        for k, gp in part["grads"].items():
            gw = whole["grads"][k]
            if ".moe.w_" in k:
                gw = gw[m * e:(m + 1) * e]
            np.testing.assert_allclose(gp.numpy(), gw.numpy(), rtol=0,
                                       atol=1e-6 * max(
                                           gw.abs().max().item(), 1e-6))


def test_expert_part_init_is_the_rows_of_the_whole_init():
    from repro_torch.models.lm import LMModel

    cfg = _lm_cfg()
    whole = dict(LMModel(cfg, device="cpu", seed=3).named_parameters())
    e = cfg.moe_experts // 2
    for m in range(2):
        part = LMModel(cfg, device="cpu", seed=3, experts=(m, 2))
        for k, w in part.named_parameters():
            want = whole[k][m * e:(m + 1) * e] if ".moe.w_" in k \
                else whole[k]
            assert torch.equal(w, want), k
            assert (getattr(w, "expert_part", None) == (m, 2)) == \
                (".moe.w_" in k)


def test_train_cli_trains_moe_on_mesh(runs):
    """Every rank trains alike, and the gradient all-reduce's buckets
    (one flat bucket here; many, and in-place reductions of the larger
    gradients, at a bucket of 4096 elements) change no loss."""
    a, b = (r["cli"] for r in runs["ranks"])
    assert a == b and len(a) == 3 and np.isfinite(a).all()
    for r in runs["ranks"]:
        assert r["cli_buckets"] == a
