"""The port's node-classification harness
(``repro_torch.launch.node_classification``) at Graphormer-Slim's
published width against the reference's ``benchmarks.common
.GraphTrainBench``, its counterpart of the paper's convergence claim,
and its CLI, on the CPU. The tolerances and the shared helpers are
``tests/test_torch_node_classification.py``'s.
"""

import pytest
import torch

from repro_torch.launch import node_classification as nc

from test_torch_node_classification import (N, _assert_same_run,
                                            _init_tree, _ref_bench,
                                            _train_both)


def test_full_config_matches_reference(monkeypatch):
    """Graphormer-Slim at its published width (4 layers, d 64, 8 heads of
    8, 128 features, 40 classes) in both harnesses."""
    import benchmarks.common as common
    from repro.configs import get_config as jget_config

    monkeypatch.setattr(common, "get_smoke_config", jget_config)
    jb = _ref_bench("graphormer_slim")
    monkeypatch.undo()
    tb = nc.GraphTrainBench(arch="graphormer_slim", n=N, dtype="float32",
                            device="cpu", config="full")
    assert (tb.cfg.n_layers, tb.cfg.d_model, tb.cfg.n_heads,
            tb.cfg.n_classes) == (jb.cfg.n_layers, jb.cfg.d_model,
                                  jb.cfg.n_heads, jb.cfg.n_classes) \
        == (4, 64, 8, 40)
    ref, port = _train_both(monkeypatch, jb, tb, "torchgt",
                            _init_tree(jb, table_std=0.5))
    _assert_same_run(ref, port, tb.model)


def test_interleaved_convergence_beats_pure_sparse():
    """The paper's convergence claim (Fig 10/11) on the port's harness, as
    ``tests/test_paper_claims.py`` holds the reference's to it."""
    bench = nc.GraphTrainBench(arch="graphormer_slim", n=384, seed=3,
                               device="cpu")
    _, _, acc_sparse = bench.train("sparse", epochs=30)
    _, _, acc_inter = bench.train("torchgt", epochs=30)
    _, _, acc_dense = bench.train("raw", epochs=30)
    assert acc_inter >= acc_sparse - 0.02, (acc_inter, acc_sparse)
    assert acc_inter >= acc_dense - 0.10, (acc_inter, acc_dense)


def test_bench_rejects_unknown_mode_and_config():
    with pytest.raises(ValueError, match="config"):
        nc.GraphTrainBench(n=64, device="cpu", config="tiny")
    bench = nc.GraphTrainBench(n=64, device="cpu")
    with pytest.raises(ValueError, match="dense"):
        bench.train("dense", epochs=1)


def test_cli_on_the_cpu(capsys):
    assert nc.main(["--device", "cpu", "--epochs", "3", "--nodes",
                    "128"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("graphormer_slim (graphormer-slim-smoke) on "
                             "SBM(n=128): beta_G=")
    assert out[1].split() == ["system", "t_epoch", "test_acc"]
    assert [ln.split()[0] for ln in out[2:5]] == ["GP-RAW", "GP-FLASH",
                                                  "TorchGT"]
    for ln in out[2:5]:
        assert 0.0 <= float(ln.split()[2]) <= 1.0
    assert out[5].startswith("TorchGT speedup vs GP-FLASH: ")
    assert out[5].endswith("(median epoch wall clock on the CPU)")


def test_cli_raises_without_cuda_when_no_device_is_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        nc.main(["--epochs", "3", "--nodes", "128"])
