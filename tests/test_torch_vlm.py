"""The port's VLM (``models/lm.py`` with ``family == "vlm"``,
InternVL2-76B's backbone with its stub vision frontend) against the JAX
package, on the CPU, on the reference's smoke config (2 layers, 8
patches): the parameter tree with ``frontend_proj``, ``lm_loss`` over the
text positions and every gradient (``frontend_proj``'s included) at S =
Tp + T = 256 on the cluster-sparse path and at S = 40 dense, the prefill
with patches and its caches, decode after it at Tp + T, one
``ServeEngine`` run (text-only, as the reference serves a VLM) against
the reference's engine, and the CLIs. Inputs are seeded numpy arrays,
parameters one JAX init carried across by ``convert.params_from_jax``.

Tolerances (fp32 model): losses within 1e-5 relative, every gradient
within 1e-4 of the largest entry of its ``jax.grad`` counterpart;
prefill logits within 1e-4 relative; the bf16 caches within one bf16
ulp (plus 1e-5 of the largest entry); decode logits over those caches
within 1e-2 relative; the engines' streams equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import build
from repro.models import lm as jlm
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import lm as tlm
from repro_torch.models.api import lm_model_class
from repro_torch.serve import ServeEngine

from _torch_cases import t

TOL_F32 = 1e-5
TOL_GRAD = 1e-4
TOL_LOGITS = 1e-4
TOL_LOGITS_BF16_CACHE = 1e-2
ARCH = "internvl2_76b"


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _bf16_close(a, b) -> None:
    """Entry by entry within one bf16 ulp of the larger magnitude, plus
    TOL_F32 of the largest entry."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert (np.abs(a - b) - ulp <= TOL_F32 * np.abs(b).max()).all()


@functools.lru_cache(maxsize=None)
def _world(backend: str):
    """(port model, JAX model, JAX params), fp32, from one JAX init;
    built once per backend for the module."""
    kw = {"dtype": "float32", "attn_backend": backend}
    cfg = get_smoke_config(ARCH).replace(**kw)
    jmodel = build(jcfgs.get_smoke_config(ARCH).replace(**kw))
    params = jmodel.init(jax.random.PRNGKey(0))
    model = tlm.LMModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(lambda x: np.array(x, copy=True), params)),
        strict=True)
    return model, jmodel, params


def _inputs(cfg, S: int, B: int = 2, seed: int = 1):
    """Patches (B, Tp, D) and S - Tp text tokens and labels."""
    rng = np.random.default_rng(seed)
    Tp = cfg.frontend_tokens
    patches = rng.standard_normal((B, Tp, cfg.d_model)).astype(np.float32)
    tok = rng.integers(1, cfg.vocab_size, (B, S - Tp))
    lab = rng.integers(0, cfg.vocab_size, (B, S - Tp))
    return ({"patches": jnp.asarray(patches), "tokens": jnp.asarray(tok),
             "labels": jnp.asarray(lab)},
            {"patches": t(patches), "tokens": t(tok), "labels": t(lab)})


def test_tree_has_the_frontend_projection():
    model, _, params = _world("dense")
    want = {n: tuple(x.shape) for n, x in params_from_jax(jax.tree.map(
        np.asarray, params)).items()}
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == want
    assert want["frontend_proj.w"] == (model.cfg.d_model,) * 2
    assert lm_model_class(model.cfg) is tlm.LMModel


@pytest.mark.parametrize("backend,S,remat", [("dense", 40, "none"),
                                             ("cluster_sparse", 256,
                                              "block")])
def test_loss_and_gradients_match_reference(backend, S, remat):
    """``lm_loss`` over the text positions and every gradient; sparse at
    S = Tp + T = 256 (the patches go through the cluster op with the
    text), the same recomputation on both sides."""
    model, jmodel, params = _world(backend)
    base = model.cfg
    jcfg = jmodel.cfg.replace(remat=remat)
    jb, tb = _inputs(base, S)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jcfg, jb), has_aux=True)(params)
    model.cfg = base.replace(remat=remat)
    try:
        loss, met = tlm.lm_loss(model, tb)
        grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        model.cfg = base
    assert abs(loss.item() / float(jl) - 1) < TOL_F32
    assert abs(met["xent"].item() / float(jmet["xent"]) - 1) < TOL_F32
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    names = [n for n, _ in model.named_parameters()]
    assert "frontend_proj.w" in names
    for name, g in zip(names, grads):
        assert _rel(g, want[name]) < TOL_GRAD, name


@pytest.mark.parametrize("backend,S", [("dense", 40),
                                       ("cluster_sparse", 256)])
def test_prefill_with_patches_and_decode_after_it(backend, S):
    """``lm_prefill`` with patches: the last token's logits and every
    layer's bf16 k/v over the Tp + T positions; then 4 decode steps at Tp
    + T onwards, on each package's own caches."""
    model, jmodel, params = _world(backend)
    jb, tb = _inputs(model.cfg, S)
    del jb["labels"], tb["labels"]
    want, wcache = jmodel.prefill(params, jb)
    with torch.no_grad():
        got, cache = tlm.lm_prefill(model, tb, cache_len=S + 4)
    assert _rel(got, want) < TOL_LOGITS
    for key in ("k", "v"):
        assert cache["layers"][key].shape[2] == S + 4
        _bf16_close(cache["layers"][key][:, :, :S], wcache["layers"][key])
    jcache = jax.tree.map(
        lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))),
        wcache)
    tok = np.random.default_rng(3).integers(1, model.cfg.vocab_size, (2, 4))
    for i in range(4):
        want, jcache = jmodel.decode(params, jcache,
                                     jnp.asarray(tok[:, i:i + 1]),
                                     jnp.int32(S + i))
        with torch.no_grad():
            got, cache = tlm.lm_decode_step(model, cache,
                                            t(tok[:, i:i + 1]), S + i)
        assert _rel(got, want) < TOL_LOGITS_BF16_CACHE, i


def test_engine_serves_the_vlm_as_the_reference_does():
    """The fp32 smoke VLM through both engines (text-only prompts, two
    slots for four requests): equal streams and counters, two programs."""
    model, jmodel, params = _world("dense")
    kw = dict(batch_slots=2, page=8, chunk=8, max_len=64)
    engines = (ServeEngine(model, **kw), JServeEngine(jmodel, params, **kw))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 128, n).tolist() for n in (5, 12, 17, 9)]
    stats = []
    for eng in engines:
        for rid, p in enumerate(prompts):
            eng.submit(rid, p, 6)
        stats.append(eng.run())
    mine, ref = engines
    assert mine.done == ref.done
    keys = ("requests", "tokens", "prefill_calls", "decode_calls",
            "traced_programs")
    assert {k: stats[0][k] for k in keys} == {k: stats[1][k] for k in keys}
    assert stats[0]["traced_programs"] == 2


def test_train_cli_refuses_the_family():
    with pytest.raises(ValueError, match="vlm family"):
        train_cli.main(["--arch", ARCH, "--smoke", "--steps", "1",
                        "--device", "cpu"])


def test_serve_cli_serves_the_vlm(capsys):
    assert serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--requests", "3", "--max-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "2 traced programs" in out
