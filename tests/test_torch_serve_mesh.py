"""``ServeEngine`` on a mesh (``mesh_model=2``: the KV heads and the
experts split over two ranks, or every head on every rank where the
heads do not split; ``launch/serve.py --mesh-model 2``) against the JAX
package's engine on a 2-device mesh, on the CPU.

The reference engine runs in a subprocess with 2 fake devices
(``_subproc.run_code(..., devices=2)``) and writes its streams to a
file; the port's runs in a world of 2 gloo ranks, each rank on its share
of this worker's threads, from the same JAX init
(``convert.params_from_jax``, fp32 configs; the pools are bf16 in both,
as the reference's are) and the same seeded prompts.

* Qwen3-0.6B smoke (dense, under the cluster-sparse decode mask) and
  Qwen3-235B-A22B smoke (MoE, expert parallel at the reference's
  capacity, which drops pairs at a few decode slots): every rank's
  streams equal the reference engine's, both programs stay at one
  signature each, and each rank's pool holds half the KV heads;
  SmolLM-135M smoke, whose 3 query and 3 kv heads do not split two
  ways: the same, each rank's pool holding all 3 kv heads (the
  reference's ``fit_spec`` keeps the axis whole).
* Rank 0's schedule is the one every rank runs: with rank 1's clock
  1000 s ahead, requests whose deadline is 1000 s are still served in
  full on every rank (on its own clock rank 1 would shed them).
* The serve CLI serves the MoE smoke config on the mesh.
"""

import contextlib
import datetime
import io
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax

from test_torch_threads import worker_share

ARCHS = {"qwen3_0_6b": True, "qwen3_moe_235b_a22b": False,  # -> sparse
         "smollm_135m": False}
ENGINE = dict(batch_slots=4, page=8, chunk=8, max_len=64)
PROMPT_LENS = (5, 12, 9, 20, 3, 15)
NEW = 6

REFERENCE = """
import json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.models import build
from repro.serve import ServeEngine

inp = dict(np.load({inp!r}))
out = {{}}
for arch, sparse in {archs!r}.items():
    tree = {{}}
    for k, v in inp.items():
        if k.startswith(arch + "/"):
            node = tree
            *path, last = k[len(arch) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {{}})
            node[last] = jnp.asarray(v)
    cfg = get_smoke_config(arch).replace(dtype="float32")
    eng = ServeEngine(build(cfg), tree, sparse=sparse, mesh_model=2,
                      **{engine!r})
    for rid, n in enumerate({lens!r}):
        eng.submit(rid, inp["prompt%d" % rid].tolist(), {new})
    eng.run()
    assert eng.traced_programs() == 2
    out[arch] = {{str(k): v for k, v in eng.done.items()}}
with open({out!r}, "w") as fh:
    json.dump(out, fh)
print("REFERENCE_OK")
"""


# ------------------------------------------------------------ spawning

def _child(rank, fn, world, tmp, threads, args):
    torch.set_num_threads(threads)
    # a rank that left rank 0's schedule would wait in a collective: fail
    # within a minute instead
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
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


# ------------------------------------------------------------ rank body

def _engine(arch, state, **kw):
    from repro_torch.models.lm import LMModel
    from repro_torch.serve import ServeEngine

    model = LMModel(get_smoke_config(arch).replace(dtype="float32"),
                    device="cpu")
    model.load_state_dict(state)
    return ServeEngine(model, sparse=ARCHS[arch], mesh_model=2, **ENGINE,
                       **kw)


def _world(rank, world, states, prompts):
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import moe as tmoe
    from repro_torch.serve import engine as engine_mod

    out = {}
    real_ep, drops = tmoe._ep_local, []

    def counting(*a, **kw):   # the pairs each expert-parallel call drops
        got = real_ep(*a, **kw)
        drops.append(int(tmoe.LAST_CALL["dropped"]))
        return got
    tmoe._ep_local = counting
    for arch, state in states.items():
        drops.clear()
        eng = _engine(arch, state)
        for rid, p in enumerate(prompts):
            eng.submit(rid, p, NEW)
        eng.run()
        out[arch] = {"done": {str(k): v for k, v in eng.done.items()},
                     "programs": eng.traced_programs(),
                     "pool_kv_heads": eng.pool["layers"]["k"].shape[-2],
                     "ep_calls": len(drops), "dropped": sum(drops)}
    tmoe._ep_local = real_ep
    # rank 1's clock 1000 s ahead of rank 0's
    real = engine_mod.time.perf_counter
    if rank == 1:
        engine_mod.time.perf_counter = lambda: real() + 1000.0
    try:
        eng = _engine("qwen3_0_6b", states["qwen3_0_6b"])
        for rid, p in enumerate(prompts):
            eng.submit(rid, p, NEW, deadline=1000.0)
        eng.run()
    finally:
        engine_mod.time.perf_counter = real
    out["skewed"] = {"done": {str(k): v for k, v in eng.done.items()},
                     "shed": dict(eng.shed)}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["cli_rc"] = serve_cli.main([
            "--arch", "qwen3_moe_235b_a22b", "--requests", "4", "--batch",
            "2", "--mesh-model", "2", "--backend", "gloo", "--device",
            "cpu"])
    out["cli"] = buf.getvalue()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from _subproc import run_code
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import build

    tmp = tmp_path_factory.mktemp("serve_mesh")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 64, n).tolist() for n in PROMPT_LENS]
    inp = {f"prompt{i}": np.array(p) for i, p in enumerate(prompts)}
    states = {}
    for arch in ARCHS:
        tree = jax.tree.map(lambda a: np.array(a, copy=True), build(
            jsmoke(arch).replace(dtype="float32")).init(
                jax.random.PRNGKey(0)))
        states[arch] = params_from_jax(tree)

        def flat(t, prefix):
            for k, v in t.items():
                if isinstance(v, dict):
                    flat(v, prefix + k + "/")
                else:
                    inp[prefix + k] = v
        flat(tree, arch + "/")
    np.savez(tmp / "in.npz", **inp)
    assert "REFERENCE_OK" in run_code(REFERENCE.format(
        inp=str(tmp / "in.npz"), out=str(tmp / "out.json"), archs=ARCHS,
        engine=ENGINE, lens=PROMPT_LENS, new=NEW), devices=2)
    with open(tmp / "out.json") as fh:
        ref = json.load(fh)
    ranks = spawn(_world, 2, tmp_path_factory.mktemp("w2"), states, prompts)
    return {"ref": ref, "ranks": ranks}


# ------------------------------------------------------------ tests

@pytest.mark.parametrize("arch", list(ARCHS))
def test_mesh_engine_streams_equal_reference_mesh_engine(runs, arch):
    want = runs["ref"][arch]
    assert len(want) == len(PROMPT_LENS)
    from repro_torch.models.lm import heads_split

    cfg = get_smoke_config(arch)
    for r in runs["ranks"]:
        assert r[arch]["done"] == want
        assert r[arch]["programs"] == 2
        assert r[arch]["pool_kv_heads"] == (
            cfg.kv_heads // 2 if heads_split(cfg, 2) else cfg.kv_heads)
        # the MoE's every layer call went expert parallel, and dropped
        assert (r[arch]["ep_calls"] > 0) == (r[arch]["dropped"] > 0) == \
            bool(cfg.moe_experts)


def test_every_rank_runs_rank_zeros_schedule(runs):
    a, b = (r["skewed"] for r in runs["ranks"])
    assert a == b
    assert a["shed"] == {} and len(a["done"]) == len(PROMPT_LENS)
    assert all(len(v) == NEW for v in a["done"].values())


def test_serve_cli_serves_moe_on_mesh(runs):
    r0, r1 = runs["ranks"]
    assert r0["cli_rc"] == r1["cli_rc"] == 0
    assert "served 4 requests" in r0["cli"] and "recipe=decode" in r0["cli"]
    assert r1["cli"] == ""
