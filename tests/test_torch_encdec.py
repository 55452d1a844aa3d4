"""The port's encoder-decoder (``models/encdec.py``, SeamlessM4T-medium)
against the JAX package, on the CPU, on the reference's smoke config (2
encoder and 2 decoder layers): the configs of both new families, the
parameter tree, ``encode``, ``encdec_loss`` and every gradient on the
dense and the cluster-sparse path under ``remat`` "none" and "block",
the prefill, ``encdec_decode_step`` step by step over caches whose
``ck``/``cv`` come from the encoder (dense and sparse decode masks), the
reference's prefill-against-decode contract, and the CLIs. The sparse
path has 256 frames (the non-causal sparse encoder) and S = 256 (the
causal sparse decoder). Inputs are seeded numpy arrays, parameters one
JAX init carried across by ``convert.params_from_jax``.

Tolerances (fp32): losses within 1e-5 relative, every gradient within
1e-4 of the largest entry of its ``jax.grad`` counterpart, the encoder's
output within 1e-5 relative; prefill and decode logits within 1e-4
relative with fp32 caches, 1e-2 with the served bf16 caches; the
prefill-against-decode contract at the reference test's ``atol=0.15,
rtol=0.05`` and equal argmax.
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
from repro.models import encdec as jed
from repro.nn import param as nnp
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import encdec as ted
from repro_torch.models.api import lm_model_class
from repro_torch.serve import ServeEngine

from _torch_cases import t

TOL_F32 = 1e-5
TOL_GRAD = 1e-4
TOL_LOGITS = 1e-4
TOL_LOGITS_BF16_CACHE = 1e-2
ARCH = "seamless_m4t_medium"
SPARSE_FRAMES = 256   # the shortest that reaches the sparse encoder


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _world(backend: str):
    """(port model, JAX model, JAX params), fp32, from one JAX init;
    built once per backend for the module. The sparse world has
    SPARSE_FRAMES frames, the dense one the smoke config's 16."""
    kw = {"dtype": "float32", "attn_backend": backend}
    if backend == "cluster_sparse":
        kw["frontend_tokens"] = SPARSE_FRAMES
    cfg = get_smoke_config(ARCH).replace(**kw)
    jcfg = jcfgs.get_smoke_config(ARCH).replace(**kw)
    jmodel = build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = ted.EncDecModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(lambda x: np.array(x, copy=True), params)),
        strict=True)
    return model, jmodel, params


def _inputs(cfg, S: int, B: int = 2, seed: int = 1):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal(
        (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    tok = rng.integers(1, cfg.vocab_size, (B, S))
    lab = rng.integers(0, cfg.vocab_size, (B, S))
    return ({"frames": jnp.asarray(frames), "tokens": jnp.asarray(tok),
             "labels": jnp.asarray(lab)},
            {"frames": t(frames), "tokens": t(tok), "labels": t(lab)})


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ["seamless_m4t_medium", "internvl2_76b"])
def test_configs_match_reference(arch):
    """Full and smoke configs of both new families, field for field."""
    for mine, ref in ((get_config(arch), jcfgs.get_config(arch)),
                      (get_smoke_config(arch), jcfgs.get_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


def test_port_runs_every_reference_arch():
    assert set(jcfgs.ALL_ARCHS) <= set(ARCHS)


# ------------------------------------------------------------ the model

def test_tree_matches_reference():
    """Every leaf of the JAX tree lands on a port parameter of its shape
    (both stacks unstacked); the family maps to ``EncDecModel``, which
    has no paged serving path."""
    model, _, params = _world("dense")
    want = {n: tuple(x.shape) for n, x in params_from_jax(jax.tree.map(
        np.asarray, params)).items()}
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == want
    assert len(model.enc_layers) == 2 and len(model.dec_layers) == 2
    assert "dec_layers.1.cross.wq" in want
    assert lm_model_class(model.cfg) is ted.EncDecModel
    assert model.paged_decode is None and model.prefill_chunk is None


@pytest.mark.parametrize("backend", ["dense", "cluster_sparse"])
def test_encode_matches_reference(backend):
    """The encoder's normed output, non-causal (dense: 16 frames; sparse:
    256 frames through the non-causal cluster op)."""
    model, jmodel, params = _world(backend)
    jb, tb = _inputs(model.cfg, 16)
    want = jed.encode(params, jmodel.cfg, jb["frames"])
    with torch.no_grad():
        got = ted.encode(model, tb["frames"])
    assert _rel(got, want) < TOL_F32


def test_encoder_and_decoder_take_a_layout_each():
    """At Tf == S the sparse encoder and decoder get two layouts: the
    non-causal one (a window of blocks from each block onwards) and the
    causal one."""
    model = _world("cluster_sparse")[0]
    _, tb = _inputs(model.cfg, SPARSE_FRAMES, B=1)
    model._layouts.clear()
    with torch.no_grad():
        ted.encdec_forward(model, tb)
    keys = sorted(model._layouts)
    assert [k[0] for k in keys] == [SPARSE_FRAMES] * 2
    assert [k[-1] for k in keys] == [False, True]


@functools.lru_cache(maxsize=None)
def _reference_grads(backend: str):
    """The reference's loss and gradients on the backend's batch (sparse:
    256 frames and S = 256), under its "block" recomputation, which
    changes no value; computed once for the module."""
    model, jmodel, params = _world(backend)
    S = 256 if backend == "cluster_sparse" else 32
    jb, tb = _inputs(model.cfg, S)
    jcfg = jmodel.cfg.replace(remat="block")
    (jl, _), jg = jax.value_and_grad(
        lambda p: jed.encdec_loss(p, jcfg, jb), has_aux=True)(params)
    return float(jl), params_from_jax(jax.tree.map(np.asarray, jg)), tb


@pytest.mark.parametrize("backend,remat", [
    ("dense", "none"), ("dense", "block"),
    ("cluster_sparse", "none"), ("cluster_sparse", "block")])
def test_loss_and_gradients_match_reference(backend, remat):
    """``encdec_loss`` and every parameter's gradient under each
    recomputation, against the reference's."""
    model = _world(backend)[0]
    base = model.cfg
    jl, want, tb = _reference_grads(backend)
    model.cfg = base.replace(remat=remat)
    try:
        loss, met = ted.encdec_loss(model, tb)
        grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        model.cfg = base
    assert abs(loss.item() / jl - 1) < TOL_F32
    assert set(met) == {"xent"}
    for (name, _), g in zip(model.named_parameters(), grads):
        assert _rel(g, want[name]) < TOL_GRAD, name


def test_prefill_matches_reference():
    """The last token's logits of the full forward, and an empty cache."""
    model, jmodel, params = _world("dense")
    jb, tb = _inputs(model.cfg, 24)
    want, wcache = jmodel.prefill(params, jb)
    with torch.no_grad():
        got, cache = model.prefill(tb)
    assert got.shape == (2, 1, model.cfg.vocab_padded)
    assert cache == {} and wcache == {}
    assert _rel(got, want) < TOL_LOGITS


def _filled_caches(model, jmodel, params, frames, B, S, cache_dtype):
    """Both packages' decode caches with ``ck``/``cv`` from the encoder
    (the reference test's construction), every leaf in ``cache_dtype``."""
    jcfg = jmodel.cfg
    enc_out = jed.encode(params, jcfg, jnp.asarray(frames))
    ck, cv = jax.vmap(lambda pp: jed._cross_kv(pp["cross"], jcfg, enc_out))(
        params["dec_layers"])
    jcache = nnp.init_tree(jmodel.cache_defs(B, S), jax.random.PRNGKey(1))
    jcache["dec"]["ck"], jcache["dec"]["cv"] = ck, cv
    cache = {"dec": {k: v.to(getattr(torch, cache_dtype))
                     for k, v in model.cache_defs(B, S)["dec"].items()}}
    with torch.no_grad():
        enc = ted.encode(model, t(frames))
        for i, layer in enumerate(model.dec_layers):
            k, v = ted.cross_kv(layer.cross, enc)
            cache["dec"]["ck"][i], cache["dec"]["cv"][i] = k, v
    dt = jnp.dtype(cache_dtype)
    jcache = {"dec": {k: v.astype(dt) for k, v in jcache["dec"].items()}}
    return cache, jcache


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [False, True])
def test_decode_step_matches_reference(sparse, cache_dtype):
    """T decode steps from empty self-attention caches, the cross caches
    filled from ``encode`` (the sparse window, 64 rows at the smoke size,
    binds past step 64 only, so ``sparse`` runs with a window of 4 on
    both sides): logits every step, the caches at the end."""
    model, jmodel, params = _world("dense")
    base, jbase = model.cfg, jmodel.cfg
    over = {"window": 4, "n_global": 2} if sparse else {}
    T, B = 10, 2
    rng = np.random.default_rng(2)
    frames = rng.standard_normal(
        (B, base.frontend_tokens, base.d_model)).astype(np.float32)
    tok = rng.integers(1, base.vocab_size, (B, T))
    jcfg = jbase.replace(**over)
    cache, jcache = _filled_caches(model, jmodel, params, frames, B, T + 2,
                                   cache_dtype)
    step = jax.jit(lambda p, c, x, i: jed.encdec_decode_step(
        p, jcfg, c, x, i, sparse=sparse))
    tol = TOL_LOGITS if cache_dtype == "float32" else TOL_LOGITS_BF16_CACHE
    model.cfg = base.replace(**over)
    try:
        for i in range(T):
            want, jcache = step(params, jcache, jnp.asarray(tok[:, i:i + 1]),
                                jnp.int32(i))
            with torch.no_grad():
                got, out = ted.encdec_decode_step(
                    model, cache, t(tok[:, i:i + 1]), i, sparse=sparse)
            assert out is cache
            assert _rel(got, want) < tol, i
    finally:
        model.cfg = base
    for key in ("k", "v", "ck", "cv"):
        a, b = cache["dec"][key], jcache["dec"][key]
        assert str(a.dtype).endswith(cache_dtype), key
        assert _rel(a, b) < (TOL_F32 if cache_dtype == "float32" else 1e-2)


def test_prefill_decode_contract_holds():
    """The reference's serving contract on the port (bf16 smoke model,
    zero frames as the reference test has them): prefill's last logits
    against T decode steps over the filled cache."""
    _, jmodel, params = _world("dense")
    cfg = get_smoke_config(ARCH).replace(remat="none")
    model = ted.EncDecModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    B, T = 2, 16
    tok = np.random.default_rng(0).integers(1, cfg.vocab_size // 4, (B, T))
    frames = torch.zeros((B, cfg.frontend_tokens, cfg.d_model),
                         dtype=torch.bfloat16)
    with torch.no_grad():
        full, _ = model.prefill({"frames": frames, "tokens": t(tok)})
        cache = model.cache_defs(B, T + 4)
        enc = ted.encode(model, frames)
        for i, layer in enumerate(model.dec_layers):
            cache["dec"]["ck"][i], cache["dec"]["cv"][i] = ted.cross_kv(
                layer.cross, enc)
        for i in range(T):
            logits, cache = model.decode(cache, t(tok[:, i:i + 1]), i)
    a, b = _np(full[:, -1]), _np(logits[:, 0])
    np.testing.assert_allclose(a, b, atol=0.15, rtol=0.05)
    assert (a.argmax(-1) == b.argmax(-1)).all()


# ---------------------------------------------------------------- CLIs

def test_train_cli_refuses_the_family():
    with pytest.raises(ValueError, match="encdec family"):
        train_cli.main(["--arch", ARCH, "--smoke", "--steps", "1",
                        "--device", "cpu"])


def test_serve_cli_and_engine_refuse_the_family(capsys):
    """As the reference's: no paged serving path."""
    with pytest.raises(SystemExit) as exc:
        serve_cli.main(["--arch", ARCH, "--device", "cpu"])
    assert exc.value.code == 2
    assert "no paged serving path" in capsys.readouterr().err
    with pytest.raises(ValueError, match="no paged serving path"):
        ServeEngine(_world("dense")[0])
