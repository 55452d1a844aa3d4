"""The port's Graphormer forward against the JAX package's: the same
parameters (a JAX tree through ``convert.params_from_jax``), the same
prepared graph, on the CPU.

Tolerances: fp32 logits within 1e-4 (the two frameworks sum in other
orders); bf16 logits within 5e-2 of each other relative to the logits'
scale, and the same argmax on at least 95% of nodes — bf16 rounds at
other places in the two frameworks, and the JAX reference also rounds
the attention probabilities to bf16 before the PV product.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import graph_model as jgm
from repro.core.graph import sbm_graph as jax_sbm
from repro.data.graph_pipeline import prepare_node_task as jax_prepare
from repro.models import build
from repro.nn import param as nnp
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import graph_model as tgm
from repro_torch.core.graph import sbm_graph
from repro_torch.data.graph_pipeline import prepare_node_task


def jax_params(cfg, seed=0):
    """Numpy copy of a JAX init, with a random nonzero bias table (the JAX
    init is zeros, which would leave the bias lookup untested)."""
    tree = jax.tree.map(np.asarray, build(cfg).init(jax.random.PRNGKey(seed)))
    tree = jax.tree.map(lambda x: np.array(x, copy=True), tree)
    rng = np.random.default_rng(seed)
    tree["bias_table"] = (rng.standard_normal(tree["bias_table"].shape)
                          * 0.5).astype(np.float32)
    return tree


def port_model(cfg, tree):
    model = tgm.GraphModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jcfgs.get_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(jcfgs.get_smoke_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_defs_match_reference(arch):
    """Same parameter names, per-layer shapes and init families as the
    reference's ParamDef tree (with the stacked layer axis removed)."""
    cfg = get_config(arch)
    ref = {}
    for path, d in nnp._walk(jgm.graph_defs(jcfgs.get_config(arch))):
        shape = d.shape[1:] if path[0] == "layers" else d.shape
        ref[".".join(path)] = (tuple(shape), d.init)
    assert tgm.graph_defs(cfg) == ref


def test_seeded_init_families():
    cfg = get_smoke_config("graphormer_large")
    a = tgm.GraphModel(cfg, device="cpu", seed=3)
    b = tgm.GraphModel(cfg, device="cpu", seed=3)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert not a.bias_table.any()
    assert torch.equal(a.layers[1].attn_norm.scale, torch.ones(cfg.d_model))
    assert abs(a.z_in.std().item() - 0.02) < 2e-3
    wq = a.layers[0].attn.wq
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 0.02


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax(arch, dtype):
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    tree = jax_params(cfg)
    g = sbm_graph(160, 4, 0.08, 0.004, feat_dim=cfg.feat_dim,
                  n_classes=cfg.n_classes, seed=2)
    jg = jax_sbm(160, 4, 0.08, 0.004, feat_dim=cfg.feat_dim,
                 n_classes=cfg.n_classes, seed=2)
    prep = prepare_node_task(g, cfg, bq=32, bk=32, d_b=8)
    want = np.asarray(jax.jit(
        lambda p, b: jgm.graph_predict(p, cfg, b, dense=False))(
        tree, jax_prepare(jg, cfg, bq=32, bk=32, d_b=8).batch),
        np.float32)[0]
    model = port_model(cfg, tree)
    with torch.inference_mode():
        got = tgm.graph_predict(model, tgm.batch_to_torch(prep.batch, "cpu"))
    got = got.float().numpy()[0]
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 5e-2 * scale
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.95


def test_params_from_jax_unstacks_layers():
    cfg = get_smoke_config("graphormer_slim")
    tree = jax_params(cfg)
    state = params_from_jax(tree)
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(state[f"layers.{i}.mlp.w_up"].numpy(),
                                      tree["layers"]["mlp"]["w_up"][i])
    model = port_model(cfg, tree)
    assert set(state) == set(model.state_dict())


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request is legal")
    with pytest.raises(RuntimeError, match="cuda"):
        tgm.GraphModel(get_smoke_config("graphormer_slim"))
