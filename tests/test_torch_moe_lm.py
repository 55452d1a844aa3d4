"""The port's MoE LMs against the JAX package, on the CPU: the
reference's Qwen3-235B-A22B and Kimi-K2 smoke configs (Kimi's leading
dense layer and shared expert included), fp32, on the cluster-sparse
backend: the configs, the parameter tree, the loss, its cross-entropy
and balance term and every gradient under ``remat`` "none" and "block",
the decode paths and the serving engine. Parameters are one JAX init
carried across by ``convert.params_from_jax``. (The MoE FFN itself and
the CLIs are ``test_torch_moe.py``'s.)

Tolerances: LM losses within 1e-5 relative, gradients within 1e-4 of the
largest entry of their ``jax.grad`` counterpart; decode logits within
1e-4 relative with fp32 caches. The engine's fp32 streams: equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import build
from repro.nn import param as nnp
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import MOE_ARCHS, get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import lm as tlm
from repro_torch.serve import ServeEngine

from _torch_cases import t

TOL_F32 = 1e-5
TOL_GRAD = 1e-4
TOL_LOGITS = 1e-4


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ------------------------------------------------------------ the LMs

def _cfgs(arch, **kw):
    kw = {"dtype": "float32", "attn_backend": "cluster_sparse", **kw}
    return (get_smoke_config(arch).replace(**kw),
            jcfgs.get_smoke_config(arch).replace(**kw))


@functools.lru_cache(maxsize=None)
def _world(arch):
    """(port model, JAX model, JAX params) of one MoE smoke config, fp32,
    cluster-sparse, from one JAX init; built once per arch."""
    cfg, jcfg = _cfgs(arch, window=8, n_global=2)
    jmodel = build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = tlm.LMModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(lambda x: np.array(x, copy=True), params)),
        strict=True)
    return model, jmodel, params


@pytest.fixture(params=MOE_ARCHS)
def world(request):
    return _world(request.param)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_configs_match_the_reference(arch):
    for get, jget in ((get_config, jcfgs.get_config),
                      (get_smoke_config, jcfgs.get_smoke_config)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))


def test_parameter_names_and_shapes(world):
    """Every leaf of the JAX tree on a port parameter of its shape (Kimi:
    ``dense_layer_0`` with its ``dense_d_ff`` MLP beside the stacked MoE
    layers, whose MoE has a shared expert)."""
    model, _, params = world
    cfg = model.cfg
    want = {n: tuple(x.shape) for n, x in params_from_jax(jax.tree.map(
        np.asarray, params)).items()}
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == want
    assert len(model.layers) == cfg.n_layers - cfg.n_dense_layers
    assert tuple(model.layers[0].moe.w_gate.shape) == (
        cfg.moe_experts, cfg.d_model, cfg.moe_d_ff)
    if cfg.n_dense_layers:
        assert tuple(model.dense_layer_0.mlp.w_up.shape) == (
            cfg.d_model, cfg.dense_d_ff)
        assert hasattr(model.layers[0].moe, "shared")


@pytest.mark.parametrize("arch,remat", [("qwen3_moe_235b_a22b", "none"),
                                        ("qwen3_moe_235b_a22b", "block"),
                                        ("kimi_k2_1t_a32b", "block")])
def test_lm_loss_and_gradients_match_reference(arch, remat):
    """``lm_loss``, its ``xent`` and ``aux`` and every parameter's
    gradient at S=256 (the cluster-sparse branch), the same recomputation
    on both sides: Qwen3-MoE keeping every activation and recomputing
    each layer, Kimi-K2 (a leading dense layer, a shared expert)
    recomputing each layer."""
    model, jmodel, params = _world(arch)
    base = model.cfg
    model.cfg = base.replace(remat=remat)
    jcfg = jmodel.cfg.replace(remat=remat)
    rng = np.random.default_rng(5)
    tok = rng.integers(1, base.vocab_size, (2, 256))
    lab = rng.integers(0, base.vocab_size, (2, 256))
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    from repro.models import lm as jlm
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jcfg, jb), has_aux=True)(params)
    try:
        loss, met = tlm.lm_loss(model, {"tokens": t(tok),
                                        "labels": t(lab)})
        grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        model.cfg = base
    assert abs(loss.item() / float(jl) - 1) < TOL_F32
    for key in ("xent", "aux"):
        assert abs(met[key].item() / float(jmet[key]) - 1) < TOL_F32, key
    assert met["aux"].item() > 0
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    for (name, _), g in zip(model.named_parameters(), grads):
        assert _rel(g, want[name]) < TOL_GRAD, name


def _f32(tree):
    """A cache tree with every leaf cast to fp32 (JAX or torch)."""
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float() if torch.is_tensor(tree) else \
        tree.astype(jnp.float32)


def test_decode_step_matches_reference(world):
    """12 contiguous decode steps from empty fp32 caches, sparse (the
    window binds past step 8): logits every step, the caches at the
    end, the dense layers' entries included."""
    model, jmodel, params = world
    T, B = 12, 2
    tok = np.random.default_rng(6).integers(1, 512, (B, T))
    jcache = _f32(nnp.init_tree(jmodel.cache_defs(B, T), jax.random.PRNGKey(1)))
    cache = _f32(model.cache_defs(B, T))
    assert sorted(cache) == sorted(jcache)
    step = jax.jit(lambda p, c, x, i: jmodel.decode(p, c, x, i, sparse=True))
    for i in range(T):
        want, jcache = step(params, jcache, jnp.asarray(tok[:, i:i + 1]),
                            jnp.int32(i))
        with torch.no_grad():
            got, out = tlm.lm_decode_step(model, cache, t(tok[:, i:i + 1]),
                                          i, sparse=True)
        assert out is cache
        assert _rel(got, want) < TOL_LOGITS, i
    for key in jcache:
        for kv in ("k", "v"):
            assert _rel(cache[key][kv], jcache[key][kv]) < TOL_F32, key


def test_prefill_chunk_and_paged_decode_match_reference(world):
    """On the same fp32 pool and block tables: a ragged prompt in chunks,
    then batched paged decode with per-slot positions; logits each call,
    the whole pool (the dense layers' entries included) at the end."""
    model, jmodel, params = world
    NB, page, nmax, C = 12, 4, 6, 8
    jpool = _f32(nnp.init_tree(jmodel.paged_cache_defs(NB, page),
                               jax.random.PRNGKey(0)))
    pool = _f32(model.paged_cache_defs(NB, page))
    assert sorted(pool) == sorted(jpool)
    rng = np.random.default_rng(7)
    bts = np.zeros((2, nmax), np.int64)
    bts[0, :5] = [3, 9, 1, 11, 5]
    bts[1, :3] = [2, 7, 4]
    prompts = {0: rng.integers(1, 512, 17), 1: rng.integers(1, 512, 6)}
    jpf = jax.jit(lambda p, pl, x, o, n, b: jmodel.prefill_chunk(
        p, pl, x, o, n, b, sparse=True))
    jpd = jax.jit(lambda p, pl, x, q, b: jmodel.paged_decode(
        p, pl, x, q, b, sparse=True))
    for s, prompt in prompts.items():
        for off in range(0, len(prompt), C):
            n = min(C, len(prompt) - off)
            tokens = np.zeros((1, C), np.int64)
            tokens[0, :n] = prompt[off:off + n]
            want, jpool = jpf(params, jpool, jnp.asarray(tokens, jnp.int32),
                              jnp.int32(off), jnp.int32(n),
                              jnp.asarray(bts[s:s + 1], jnp.int32))
            with torch.no_grad():
                got, _ = model.prefill_chunk(pool, t(tokens), off, n,
                                             t(bts[s:s + 1]), sparse=True)
            assert _rel(got, want) < TOL_LOGITS
    pos = np.array([17, 6])
    for _ in range(4):
        tokens = rng.integers(1, 512, (2, 1))
        want, jpool = jpd(params, jpool, jnp.asarray(tokens, jnp.int32),
                          jnp.asarray(pos, jnp.int32),
                          jnp.asarray(bts, jnp.int32))
        with torch.no_grad():
            got, _ = model.paged_decode(pool, t(tokens), t(pos), t(bts),
                                        sparse=True)
        assert _rel(got, want) < TOL_LOGITS
        pos += 1
    for key in jpool:
        for kv in ("k", "v"):
            assert _rel(pool[key][kv][..., 1:, :, :, :] if key == "layers"
                        else pool[key][kv][1:],
                        jpool[key][kv][..., 1:, :, :, :] if key == "layers"
                        else jpool[key][kv][1:]) < TOL_F32, key


def test_engine_matches_reference(world):
    """The fp32 MoE smoke model behind both engines (two slots for four
    ragged requests): equal greedy streams and counters, two programs."""
    model, jmodel, params = world
    kw = dict(batch_slots=2, page=8, chunk=8, max_len=48)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 128, n).tolist() for n in (5, 12, 17, 9)]
    engines = (ServeEngine(model, **kw), JServeEngine(jmodel, params, **kw))
    stats = []
    for eng in engines:
        for rid, p in enumerate(prompts):
            eng.submit(rid, p, 6)
        stats.append(eng.run())
    assert engines[0].done == engines[1].done
    for key in ("requests", "tokens", "prefill_calls", "decode_calls",
                "traced_programs"):
        assert stats[0][key] == stats[1][key], key
    assert stats[0]["traced_programs"] == 2
    assert engines[0].pool_bytes() == sum(
        x.nbytes for x in jax.tree.leaves(engines[1].pool))
