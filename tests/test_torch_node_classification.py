"""The port's node-classification harness
(``repro_torch.launch.node_classification``) against the reference's
``benchmarks.common.GraphTrainBench``, on the CPU.

Both harnesses build the same SBM graph (n=192) and train from the same
JAX init (``convert.params_from_jax``) in float32, in the smoke config
unless a case says otherwise. Tolerances, as the trainer's trajectory
test: per-epoch losses within 1e-4 relative, per-epoch training accuracy
within 1e-6, the held-out accuracy exactly, every trained parameter
within 1e-4. The bias table starts at zero, and one raw step moves it
only to ~2e-3, so ``raw`` and ``flash`` give nearly the same losses from
the init: one case draws a nonzero table into both packages, so that a
``raw`` mode that dropped the bias would fail.
"""

import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import dual_attention as jda
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import dual_attention as tda
from repro_torch.core.graph import sbm_graph
from repro_torch.data.graph_pipeline import prepare_node_task
from repro_torch.launch import node_classification as nc

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:   # the reference's benchmarks/ package
    sys.path.insert(0, str(REPO))

N = 192
EPOCHS = 4
PERIOD = 2      # torchgt: dense at epochs 0 and 2, sparse at 1 and 3
LR, WD = 2e-3, 0.01


def _ref_bench(arch, **kw):
    from benchmarks.common import GraphTrainBench
    return GraphTrainBench(arch=arch, n=N, dtype="float32", **kw)


@pytest.fixture(scope="module")
def benches():
    """``(reference, port)`` harness pairs by arch, built on first use."""
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = (_ref_bench(arch),
                          nc.GraphTrainBench(arch=arch, n=N, dtype="float32",
                                             device="cpu"))
        return made[arch]
    return get


def _init_tree(jb, table_std=0.0):
    """The reference's init as numpy leaves; ``table_std`` > 0 draws the
    bias table from N(0, table_std)."""
    tree = jax.tree.map(lambda x: np.array(x, copy=True), jb.init(0)[0])
    if table_std:
        rng = np.random.default_rng(7)
        tree["bias_table"] = (rng.standard_normal(tree["bias_table"].shape)
                              * table_std).astype(np.float32)
    return tree


def _train_both(monkeypatch, jb, tb, mode, tree, epochs=EPOCHS):
    """Trains ``mode`` in both harnesses from ``tree``; returns the
    reference's ``(hist, acc, params)`` and the port's ``(hist, acc)``
    (its parameters stay in ``tb.model``). The reference's harness starts
    from ``tree`` and hands its trained parameters out through patched
    ``init`` and ``test_acc`` on the instance."""
    kept = []
    test_acc = jb.test_acc
    monkeypatch.setattr(jb, "init", lambda seed=0: (tree, jb.opt.init(tree)))
    monkeypatch.setattr(jb, "test_acc",
                        lambda p: (kept.append(p), test_acc(p))[1])
    jhist, _, jacc = jb.train(mode, epochs=epochs, interleave_period=PERIOD)
    monkeypatch.undo()
    thist, t_epoch, tacc = tb.train(mode, epochs=epochs,
                                    interleave_period=PERIOD,
                                    params=params_from_jax(tree))
    assert np.isfinite(t_epoch) and t_epoch > 0
    want = params_from_jax(jax.tree.map(np.asarray, kept[0]))
    return (jhist, jacc, want), (thist, tacc)


def _assert_same_run(ref, port, model):
    (jhist, jacc, want), (thist, tacc) = ref, port
    assert [h["epoch"] for h in thist] == [h["epoch"] for h in jhist]
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-4)
    np.testing.assert_allclose([h["train_acc"] for h in thist],
                               [h["train_acc"] for h in jhist], atol=1e-6)
    assert tacc == jacc
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch,mode", [
    ("graphormer_slim", "raw"), ("graphormer_slim", "flash"),
    ("graphormer_slim", "sparse"), ("graphormer_slim", "torchgt"),
    ("gt", "raw"), ("gt", "torchgt")])
def test_harness_matches_reference(monkeypatch, benches, arch, mode):
    jb, tb = benches(arch)
    assert tb.g.sparsity == jb.g.sparsity
    assert tb.prep.layout.density() == jb.prep.layout.density()
    assert tb.prep.report.ok == jb.prep.report.ok
    ref, port = _train_both(monkeypatch, jb, tb, mode, _init_tree(jb))
    _assert_same_run(ref, port, tb.model)


def test_nonzero_bias_table_tells_raw_from_flash(monkeypatch, benches):
    jb, tb = benches("graphormer_slim")
    tree = _init_tree(jb, table_std=0.5)
    table0 = tree["bias_table"]
    runs = {}
    for mode in ("raw", "flash"):
        ref, port = _train_both(monkeypatch, jb, tb, mode, tree)
        _assert_same_run(ref, port, tb.model)
        runs[mode] = (port[0], ref[2]["bias_table"].numpy(),
                      tb.model.bias_table.detach().numpy().copy())
    raw_loss = np.array([h["loss"] for h in runs["raw"][0]])
    flash_loss = np.array([h["loss"] for h in runs["flash"][0]])
    # every epoch's loss tells them apart at twice the losses' tolerance
    rel = np.abs(raw_loss - flash_loss) / np.abs(flash_loss)
    assert rel.min() > 2e-4, (raw_loss, flash_loss)
    # flash never reaches the table: zero gradient, so AdamW only decays it
    decayed = table0 * (1.0 - LR * WD) ** EPOCHS
    for table in runs["flash"][1:]:
        np.testing.assert_allclose(table, decayed, rtol=1e-6)
    # raw moves it (and as the reference does, held above)
    for table in runs["raw"][1:]:
        assert np.abs(table - decayed).max() > 1e-3


@pytest.mark.parametrize("with_buckets", [True, False])
def test_dense_bias_from_layout_matches_reference(with_buckets):
    cfg = get_smoke_config("graphormer_slim").replace(dtype="float32")
    g = sbm_graph(N, 4, 0.04, 0.002, feat_dim=cfg.feat_dim,
                  n_classes=cfg.n_classes, seed=0)
    lay = prepare_node_task(g, cfg, bq=32, bk=32, d_b=8,
                            with_buckets=with_buckets).layout
    H, S = cfg.n_heads, lay.seq_len
    rng = np.random.default_rng(3)
    table = rng.standard_normal((H, 3)).astype(np.float32)
    w = rng.standard_normal((1, H, S, S)).astype(np.float32)

    want, jgrad = jax.value_and_grad(
        lambda t: (jda.dense_bias_from_layout(lay, t, H) * w).sum())(table)
    jbias = np.asarray(jda.dense_bias_from_layout(lay, table, H))
    t = torch.tensor(table, requires_grad=True)
    bias = tda.dense_bias_from_layout(lay, t, H)
    assert bias.shape == (1, H, S, S) and bias.dtype == torch.float32
    np.testing.assert_array_equal(bias.detach().numpy(), jbias)
    if with_buckets:
        (bias * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad),
                                   rtol=1e-5, atol=1e-3)
        assert np.abs(t.grad.numpy()).max() > 0
    else:   # zeros, which the table does not reach (its gradient is 0)
        assert not bias.any() and not bias.requires_grad
        assert not np.asarray(jgrad).any()
    # no table: zeros of the same shape, as the reference's
    none = tda.dense_bias_from_layout(lay, None, H)
    np.testing.assert_array_equal(
        none.numpy(), np.asarray(jda.dense_bias_from_layout(lay, None, H)))
    assert not none.any()
