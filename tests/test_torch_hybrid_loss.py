"""The port's Jamba hybrid against the JAX package, on the CPU:
``hybrid_loss`` (cross-entropy and balance term) and every gradient on
the reference's Jamba-v0.1 smoke config (one period of 8 layers) and at
16 layers (two periods), the same recomputation on both sides.
Parameters are one JAX init carried across by
``convert.params_from_jax``. (The rest of the hybrid is
``test_torch_hybrid.py``'s.)

Tolerances (fp32): losses within 1e-5 relative, every gradient within
1e-4 of the largest entry of its ``jax.grad`` counterpart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import build
from repro.models import hybrid as jhy
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import hybrid as thy

from _torch_cases import t

TOL_F32 = 1e-5
TOL_GRAD = 1e-4
ARCH = "jamba_v0_1_52b"


def _rel(a, b) -> float:
    a = a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.detach().float().numpy() if torch.is_tensor(b) else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _world(n_layers: int):
    """(port model, JAX model, JAX params), fp32, cluster-sparse, from
    one JAX init."""
    kw = {"dtype": "float32", "attn_backend": "cluster_sparse",
          "n_layers": n_layers}
    cfg = get_smoke_config(ARCH).replace(**kw)
    jmodel = build(jcfgs.get_smoke_config(ARCH).replace(**kw))
    params = jmodel.init(jax.random.PRNGKey(0))
    model = thy.HybridLMModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(lambda x: np.array(x, copy=True), params)),
        strict=True)
    return model, jmodel, params


@pytest.mark.parametrize("n_layers,remat", [(8, "none"), (16, "block")])
def test_hybrid_loss_and_gradients_match_reference(n_layers, remat):
    """``hybrid_loss``, ``xent``, ``aux`` and every parameter's gradient
    at S=256 (the attention slot on the cluster-sparse branch), the same
    recomputation on both sides: one period keeping every activation,
    two recomputing each period."""
    model, jmodel, params = _world(n_layers)
    base = model.cfg
    jcfg = jmodel.cfg.replace(remat=remat)
    rng = np.random.default_rng(1)
    tok = rng.integers(1, base.vocab_size, (2, 256))
    lab = rng.integers(0, base.vocab_size, (2, 256))
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jhy.hybrid_loss(p, jcfg, jb), has_aux=True)(params)
    model.cfg = base.replace(remat=remat)
    try:
        loss, met = thy.hybrid_loss(model, {"tokens": t(tok),
                                            "labels": t(lab)})
        grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        model.cfg = base
    assert abs(loss.item() / float(jl) - 1) < TOL_F32
    for key in ("xent", "aux"):
        assert abs(met[key].item() / float(jmet[key]) - 1) < TOL_F32, key
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    for (name, _), g in zip(model.named_parameters(), grads):
        assert _rel(g, want[name]) < TOL_GRAD, name
