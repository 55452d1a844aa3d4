"""The port's Jamba hybrid (``models/hybrid.py``) against the JAX package,
on the CPU, on the reference's Jamba-v0.1 smoke config (one period of 8
layers: Mamba2 slots, the attention slot at index 4, MoE every other
FFN) and at 16 layers, where two periods stack: the parameter tree,
``hybrid_decode_step`` step by step and its caches, the prefill, the
cache layout, ``convert`` across the stacked periods, a port checkpoint
restored by the reference's ``Checkpointer``, and the CLIs.
(``hybrid_loss`` and its gradients are ``test_torch_hybrid_loss.py``'s,
a file of their own so that xdist's ``--dist loadfile`` runs the two
halves on two workers.) Inputs are
seeded numpy arrays, parameters one JAX init carried across by
``convert.params_from_jax``.

Tolerances (fp32): losses within 1e-5 relative, every gradient within
1e-4 of the largest entry of its ``jax.grad`` counterpart; decode and
prefill logits within 1e-4 relative with fp32 caches, 1e-2 with the
served bf16 caches (a value near a rounding boundary may round either
way). Trees and checkpoints: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.ckpt.checkpoint import Checkpointer as JCheckpointer
from repro.models import build
from repro.models import hybrid as jhy
from repro.nn import param as nnp
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import hybrid as thy
from repro_torch.models.api import lm_model_class

from _torch_cases import t

TOL_F32 = 1e-5
TOL_GRAD = 1e-4
TOL_LOGITS = 1e-4
TOL_LOGITS_BF16_CACHE = 1e-2
ARCH = "jamba_v0_1_52b"


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _cfgs(n_layers: int):
    kw = {"dtype": "float32", "attn_backend": "cluster_sparse",
          "n_layers": n_layers}
    return (get_smoke_config(ARCH).replace(**kw),
            jcfgs.get_smoke_config(ARCH).replace(**kw))


@functools.lru_cache(maxsize=None)
def _world(n_layers: int):
    """(port model, JAX model, JAX params), fp32, cluster-sparse, from
    one JAX init; built once per depth for the module."""
    cfg, jcfg = _cfgs(n_layers)
    jmodel = build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = thy.HybridLMModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(lambda x: np.array(x, copy=True), params)),
        strict=True)
    return model, jmodel, params


@pytest.fixture(params=[8, 16], ids=["1period", "2periods"])
def world(request):
    return _world(request.param)


def test_period_pattern_and_tree(world):
    """The slots' mixers and FFNs are the reference's; every leaf of the
    JAX tree lands on a port parameter of its shape (the period axis
    unstacked)."""
    model, jmodel, params = world
    cfg = model.cfg
    assert thy._period_pattern(cfg) == jhy._period_pattern(jmodel.cfg)
    assert [m for m, _ in thy._period_pattern(cfg)].index("attn") == 4
    assert [f for _, f in thy._period_pattern(cfg)] == ["moe", "dense"] * 4
    want = {n: tuple(x.shape) for n, x in params_from_jax(jax.tree.map(
        np.asarray, params)).items()}
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == want
    assert len(model.periods) == cfg.n_layers // 8
    assert lm_model_class(cfg) is thy.HybridLMModel


def _as(tree, dtype):
    """A cache tree as it is ("bfloat16") or every leaf in fp32."""
    if dtype == "bfloat16":
        return tree
    if isinstance(tree, dict):
        return {k: _as(v, dtype) for k, v in tree.items()}
    return tree.float() if torch.is_tensor(tree) else \
        tree.astype(jnp.float32)


@pytest.mark.parametrize("n_layers,cache_dtype", [
    (8, "float32"), (8, "bfloat16"), (16, "float32")])
def test_decode_step_matches_reference(n_layers, cache_dtype):
    """12 decode steps from empty caches under the sparse mask (the
    window of 8 binds): logits every step, and with fp32 caches every
    slot's caches at the end (attention k/v, Mamba conv history and
    state); the served bf16 caches at one period."""
    model, jmodel, params = _world(n_layers)
    base = model.cfg
    model.cfg = base.replace(window=8, n_global=2)
    jcfg = jmodel.cfg.replace(window=8, n_global=2)
    T, B = 12, 2
    tok = np.random.default_rng(2).integers(1, 512, (B, T))
    jcache = _as(nnp.init_tree(jhy.hybrid_cache_defs(jcfg, B, T),
                               jax.random.PRNGKey(1)), cache_dtype)
    cache = _as(model.cache_defs(B, T), cache_dtype)
    step = jax.jit(lambda p, c, x, i: jhy.hybrid_decode_step(
        p, jcfg, c, x, i, sparse=True))
    tol = TOL_LOGITS if cache_dtype == "float32" else TOL_LOGITS_BF16_CACHE
    try:
        for i in range(T):
            want, jcache = step(params, jcache, jnp.asarray(tok[:, i:i + 1]),
                                jnp.int32(i))
            with torch.no_grad():
                got, cache = model.decode(cache, t(tok[:, i:i + 1]), i,
                                          sparse=True)
            assert _rel(got, want) < tol, i
    finally:
        model.cfg = base
    if cache_dtype == "float32":
        for slot, leaves in jcache["periods"].items():
            for key, want in leaves.items():
                assert _rel(cache["periods"][slot][key], want) < TOL_F32, \
                    (slot, key)


def test_prefill_matches_reference(world):
    """Last-token logits of the full forward, and no cache, as the
    reference's ``_hybrid_prefill``."""
    model, jmodel, params = world
    tok = np.random.default_rng(3).integers(1, 512, (2, 64))
    want, wcache = jmodel.prefill(params, {"tokens": jnp.asarray(tok)})
    with torch.no_grad():
        got, cache = model.prefill({"tokens": t(tok)})
    assert cache == {} and wcache == {}
    assert got.shape == (2, 1, model.cfg.vocab_padded)
    assert _rel(got, want) < TOL_LOGITS


def test_cache_defs_match_reference(world):
    model, jmodel, _ = world
    got = model.cache_defs(3, 40)["periods"]
    want = jmodel.cache_defs(3, 40)["periods"]
    assert sorted(got) == sorted(want)
    for slot, leaves in want.items():
        assert sorted(got[slot]) == sorted(leaves)
        for key, d in leaves.items():
            assert tuple(got[slot][key].shape) == tuple(d.shape)
            assert str(got[slot][key].dtype).split(".")[-1] == \
                jnp.dtype(d.dtype).name
            assert not got[slot][key].any()


def test_convert_restacks_periods(world):
    """``params_to_jax`` stacks ``periods.<p>.*`` back into the
    reference's tree, leaf for leaf, from the model's own parameters."""
    model, _, params = world
    back = params_to_jax(dict(model.named_parameters()))
    flat_want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, params))
    assert len(flat_want) == len(jax.tree.leaves(back))
    for path, leaf in flat_want:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)


def test_reference_restores_a_port_checkpoint(tmp_path):
    """The port's checkpoint of the smoke model, saved through
    ``params_to_jax``, restores through the reference's ``Checkpointer``
    to ``hybrid_defs``'s shapes and the model's values."""
    cfg, jcfg = _cfgs(16)
    model = thy.HybridLMModel(cfg, device="cpu", seed=3)
    Checkpointer(str(tmp_path), codec="zlib").save(
        2, {"params": params_to_jax(dict(model.named_parameters()))},
        blocking=True)
    got = jax.tree.map(np.asarray, JCheckpointer(str(tmp_path)).restore(2))
    shapes = jax.tree.map(lambda d: tuple(d.shape),
                          nnp.abstract_tree(build(jcfg).param_defs))
    assert jax.tree.map(lambda x: tuple(x.shape), got["params"]) == shapes
    state = params_from_jax(got["params"])
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(state[name].numpy(),
                                      p.detach().numpy(), err_msg=name)


def test_hybrid_raises_where_the_reference_does():
    cfg = get_smoke_config(ARCH)
    with pytest.raises(ValueError, match="hybrid family"):
        thy.HybridLMModel(get_smoke_config("qwen3_0_6b"), device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        thy.HybridLMModel(cfg.replace(n_layers=12), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            thy.HybridLMModel(cfg)


def test_train_cli_runs_jamba_on_cpu(capsys):
    train_cli.main(["--arch", ARCH, "--smoke", "--steps", "2", "--seq",
                    "32", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=jamba-52b-smoke" in out and "status=done" in out
    assert " xent " in out and " aux " in out


def test_serve_cli_refuses_the_hybrid(capsys):
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", ARCH, "--device", "cpu"])
    assert "no paged serving path" in capsys.readouterr().err
