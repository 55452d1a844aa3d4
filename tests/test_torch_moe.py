"""The port's MoE family against the JAX package, on the CPU: the MoE FFN
(``models/moe.py``: routing, dropless dispatch, the combine, the shared
experts), the recomputation's routing, and the CLIs on the reference's
Qwen3-235B-A22B and Kimi-K2 smoke configs. Inputs are seeded numpy
arrays, parameters one JAX init carried across by
``convert.params_from_jax``. (The MoE LMs against the reference are
``test_torch_moe_lm.py``'s, a file of their own so that xdist's
``--dist loadfile`` runs the two halves on two workers.)

Tolerances: ``moe_tokens`` in fp32 within 1e-5 (y, of its largest entry;
aux absolutely), gradients within 1e-4 of the largest entry of their
``jax.grad`` counterpart; bf16 within 2e-2 of the largest output (the
combine sums a token's slots in slot order, the reference scatter-adds
them in pair order: another rounding order). Routing ties: equal
indices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import moe as jmoe
from repro_torch.configs import MOE_ARCHS, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

from _torch_cases import t

TOL_F32 = 1e-5
TOL_GRAD = 1e-4
TOL_BF16 = 2e-2


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ------------------------------------------------------------ the MoE FFN

def _moe_cfgs(shared: int):
    """T=64 tokens of D=32 over E=8 experts, top-2, expert width 48."""
    kw = dict(d_model=32, moe_experts=8, moe_top_k=2, moe_d_ff=48,
              moe_shared_experts=shared, dtype="float32")
    return (get_smoke_config("qwen3_moe_235b_a22b").replace(**kw),
            jcfgs.get_smoke_config("qwen3_moe_235b_a22b").replace(**kw))


def _moe_world(shared: int, seed: int = 0):
    """(port MoE, JAX params, cfg, jcfg) from one seeded numpy draw."""
    cfg, jcfg = _moe_cfgs(shared)
    rng = np.random.default_rng(seed)
    tree = {}
    for name, (shape, _) in tmoe.moe_defs(cfg).items():
        leaf = (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    p = tmoe.MoE(cfg, device="cpu")
    p.load_state_dict(params_from_jax(tree), strict=True)
    return p, jax.tree.map(jnp.asarray, tree), cfg, jcfg


def _jax_objective(jcfg, jp, x, r, c):
    y, aux = jmoe.moe_apply(jp, jcfg, x)
    return jnp.sum(y.astype(jnp.float32) * r) + c * aux, (y, aux)


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_matches_reference_fp32(shared):
    """y and aux, then the gradients of ``sum(y * r) + 0.3 aux`` for x,
    the router and the three expert stacks (and the shared MLP)."""
    p, jp, cfg, jcfg = _moe_world(shared)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32)).astype(np.float32)
    r = rng.standard_normal((2, 32, 32)).astype(np.float32)
    (_, (jy, jaux)), (jg, jgx) = jax.value_and_grad(
        _jax_objective, argnums=(1, 2), has_aux=True)(
            jcfg, jp, jnp.asarray(x), jnp.asarray(r), 0.3)
    xt = t(x).requires_grad_()
    y, aux = tmoe.moe_apply(p, cfg, xt)
    assert y.shape == (2, 32, 32) and y.dtype == torch.float32
    assert _rel(y, jy) < TOL_F32
    assert abs(aux.item() - float(jaux)) < TOL_F32
    names = [n for n, _ in p.named_parameters()]
    grads = torch.autograd.grad((y * t(r)).sum() + 0.3 * aux,
                                [xt, *p.parameters()])
    assert _rel(grads[0], jgx) < TOL_GRAD
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    assert sorted(want) == sorted(names)
    for name, g in zip(names, grads[1:]):
        assert _rel(g, want[name]) < TOL_GRAD, name


def test_moe_tokens_bf16_within_tolerance():
    """bf16 activations (fp32 parameters, cast per call): the flat-token
    op within 2e-2 of the largest output."""
    p, jp, cfg, jcfg = _moe_world(0, seed=2)
    x = np.random.default_rng(3).standard_normal((64, 32)).astype(
        np.float32)
    jy, jaux = jmoe.moe_tokens(jp, jcfg.replace(dtype="bfloat16"),
                               jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        y, aux = tmoe.moe_tokens(p, cfg.replace(dtype="bfloat16"),
                                 t(x).bfloat16())
    assert y.dtype == torch.bfloat16 and y.shape == (64, 32)
    assert _rel(y, jy) < TOL_BF16
    assert abs(float(aux) - float(jaux)) < TOL_BF16


def test_routing_ties_pick_the_lower_expert():
    """Router columns duplicated so that rows tie (and a zero row, where
    every expert ties): the chosen indices, probabilities and aux equal
    the reference's ``lax.top_k``."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    w[:, 5] = w[:, 2]
    w[:, 7] = w[:, 2]
    w[:, 6] = w[:, 1]
    x = rng.standard_normal((12, 16)).astype(np.float32)
    x[3] = 0.0
    for k in (1, 2, 3):
        jv, ji, jaux = jmoe._route(jnp.asarray(w), jnp.asarray(x), k)
        v, i, aux = tmoe._route(t(w), t(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        assert _rel(v, jv) < TOL_F32
        assert abs(float(aux) - float(jaux)) < TOL_F32
    assert i[3].tolist() == [0, 1, 2]


def test_moe_raises_under_a_mesh():
    """A model axis that does not divide the experts (8 over 3) raises
    with its numbers: no path runs the experts unsharded on a mesh."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.parallel.axes import axis_rules
    from repro_torch.parallel.sharding import recipe_for

    p, _, cfg, _ = _moe_world(0)
    mesh = {"data": 1, "model": 3}
    with axis_rules(recipe_for(ShapeConfig("t", "train", 6, 1), mesh),
                    mesh):
        with pytest.raises(ValueError, match="8 experts do not split over "
                                             "a 3-way model axis"):
            tmoe.moe_apply(p, cfg, torch.zeros(1, 2, 32))


# ------------------------------------------------------------ the CLIs

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_cli_runs_moe_on_cpu(capsys, arch):
    train_cli.main(["--arch", arch, "--smoke", "--steps", "2", "--seq",
                    "32", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "status=done" in out and " xent " in out and " aux " in out


def test_serve_cli_serves_moe_on_cpu(capsys):
    assert serve_cli.main(["--arch", "qwen3_moe_235b_a22b", "--device",
                           "cpu", "--requests", "3", "--batch", "2",
                           "--max-tokens", "4", "--chunk", "8", "--page",
                           "8", "--max-len", "32"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "2 traced programs" in out
    assert "free blocks at drain: 8/8" in out


def test_moe_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        tlm.LMModel(get_smoke_config("qwen3_moe_235b_a22b"))


@pytest.mark.parametrize("remat", ["block", "dots"])
def test_recomputation_routes_as_the_forward(monkeypatch, remat):
    """The backward recomputes each layer; where the recomputed router
    logits differ from the forward's (on the card an op that accumulates
    with atomics may round otherwise the second time), the recomputation
    must still route every token as the forward did: under "block" the
    forward's choices are replayed (``moe.routing_contexts``), under
    "dots" the router's product is kept. A router that drifts on its
    second call (the recomputation of the one layer) would otherwise
    change the experts' row counts."""
    cfg = get_smoke_config("qwen3_moe_235b_a22b").replace(
        n_layers=1, dtype="float32", remat=remat)
    model = tlm.LMModel(cfg, device="cpu", seed=0)
    tok = t(np.random.default_rng(9).integers(1, 512, (2, 64)))
    batch = {"tokens": tok, "labels": tok}
    real, calls, routes, inputs = tmoe._route, [], [], []
    drift = t(np.random.default_rng(10).standard_normal(
        tuple(model.layers[0].moe.router.shape)).astype(np.float32))

    def drifting(w, xt, k, **kw):
        calls.append(1)
        if len(calls) == 2:
            w = w + drift
        out = real(w, xt, k, **kw)
        routes.append(out[1])
        inputs.append((w.detach(), xt.detach()))
        return out
    monkeypatch.setattr(tmoe, "_route", drifting)
    loss, _ = tlm.lm_loss(model, batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert len(calls) == 2 and all(torch.isfinite(g).all() for g in grads)
    # the drifted router alone routes otherwise; the recomputation kept
    # the forward's routing
    assert not torch.equal(real(*inputs[1], 2)[1], routes[0])
    assert torch.equal(routes[1], routes[0])
