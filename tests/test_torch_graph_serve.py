"""The port's GraphServe against the JAX package's on the same graph and
parameters (CPU), its layout cache, its CLI, and the port's isolation
from JAX."""

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core.graph import sbm_graph as jax_sbm
from repro.models import build
from repro.serve import GraphServe as JaxGraphServe
from repro.serve import graph_hash as jax_graph_hash
from repro_torch.configs import get_smoke_config
from repro_torch.core.graph import sbm_graph
from repro_torch.kernels import cluster_attention as tca
from repro_torch.launch.serve import main as serve_main
from repro_torch.serve import GraphServe, graph_hash

from _subproc import run_code
from test_torch_graph_model import jax_params, port_model

NODES = np.asarray([0, 5, 17, 60, 95])


@pytest.fixture(scope="module")
def world():
    cfg = get_smoke_config("graphormer_slim").replace(dtype="float32")
    jcfg = jcfgs.get_smoke_config("graphormer_slim").replace(
        dtype="float32")
    tree = jax_params(cfg)
    kw = dict(p_in=0.05, p_out=0.003, feat_dim=cfg.feat_dim,
              n_classes=cfg.n_classes, seed=0)
    g, jg = sbm_graph(96, 4, **kw), jax_sbm(96, 4, **kw)
    srv = GraphServe(port_model(cfg, tree))
    jsrv = JaxGraphServe(build(jcfg), jax.tree.map(np.asarray, tree))
    return srv, jsrv, g, jg


def test_graph_hash_matches_reference(world):
    _, _, g, jg = world
    assert graph_hash(g) == jax_graph_hash(jg)


def test_node_matches_jax_graph_serve(world):
    srv, jsrv, g, jg = world
    got, want = srv.node(g, NODES), jsrv.node(jg, NODES)
    np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["nodes"], NODES)


def test_link_matches_jax_graph_serve(world):
    srv, jsrv, g, jg = world
    src, dst = g.src[:7], g.dst[:7]
    got, want = srv.link(g, src, dst), jsrv.link(jg, src, dst)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got["prob"], want["prob"], atol=1e-5)


def test_layout_cache_counts_one_entry(world):
    srv, _, g, _ = world
    srv.node(g, NODES)
    srv.link(g, NODES, NODES[::-1])
    assert srv.n_cached_layouts() == 1
    with pytest.raises(ValueError, match="node ids"):
        srv.node(g, [g.n])


def test_serve_cli_runs_on_cpu(capsys):
    tca.reset_count()
    assert serve_main(["--arch", "graphormer_large", "--device", "cpu",
                       "--graph-nodes", "96", "--queries", "4"]) == 0
    out = capsys.readouterr().out
    assert "1 cached layout" in out and "graphormer-large-smoke" in out
    assert tca.launches == 0          # CPU tensors never reach the kernel


def test_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request is legal")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_main(["--graph-nodes", "96"])


def test_port_imports_neither_jax_nor_reference():
    """Importing every module of the port leaves jax and the JAX package
    out of sys.modules (run in a fresh interpreter: this one has both)."""
    out = run_code("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(len(names), bad)
    """, devices=1, timeout=300)
    n, bad = out.strip().split(" ", 1)
    assert int(n) >= 15 and bad == "[]", out
