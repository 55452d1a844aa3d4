"""Node classification with the paper's three systems on one synthetic
clustered graph — GP-RAW (dense attention with the structural bias),
GP-FLASH (dense attention, no bias) and TorchGT (dual-interleaved
cluster-sparse attention) — reporting each one's epoch time and held-out
accuracy (the paper's Table V). The port of
``benchmarks.common.GraphTrainBench`` and of
``examples/node_classification.py``.

:class:`GraphTrainBench` trains a graph arch on a stochastic block model
graph (``p_in=0.04``, ``p_out=0.002``, 60% of the nodes labelled) in one
of four modes, each epoch one full-graph step with AdamW:

* ``raw``: dense attention biased where the cluster-sparse layout
  defines structure, every epoch;
* ``flash``: dense attention without the bias, every epoch (the
  reference computes it in plain attention too, not in a flash kernel);
* ``sparse``: the cluster-sparse step (``kernels/ops.cluster_attention``)
  every epoch;
* ``torchgt``: dense with the bias every ``interleave_period`` epochs,
  or every epoch when the layout failed the C1-C3 conditions, sparse
  otherwise (``use_dense_step``).

Held-out accuracy is read on the sparse path in every mode. ``config``
picks the arch's smoke config (the reference's) or the published one.

  PYTHONPATH=src python -m repro_torch.launch.node_classification \\
      --epochs 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.node_classification \\
      --config full --nodes 8192
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.dual_attention import (dense_bias_from_buckets,
                                             dense_buckets_from_layout,
                                             use_dense_step)
from repro_torch.core.graph import sbm_graph
from repro_torch.core.graph_model import (GraphModel, batch_to_torch,
                                          graph_loss, graph_predict)
from repro_torch.data.graph_pipeline import prepare_node_task
from repro_torch.device import resolve
from repro_torch.optim.adamw import AdamW

MODES = ("raw", "flash", "sparse", "torchgt")
# the systems the CLI compares, in its table's order
SYSTEMS = (("raw", "GP-RAW"), ("flash", "GP-FLASH"), ("torchgt", "TorchGT"))
CONFIGS = ("smoke", "full")


class GraphTrainBench:
    """Synthetic-SBM node-classification harness: trains
    Graphormer-Slim/Large or GT in one of :data:`MODES`. Construction
    prepares the graph twice (training labels, then every label for the
    held-out accuracy), uploads both batches once and, for an arch with a
    bias table, the dense step's ``(S, S)`` bucket matrix once."""

    def __init__(self, arch="graphormer_slim", n=512, n_clusters=4,
                 beta_thre=None, seed=0, dtype=None, *, device="cuda",
                 config="smoke"):
        if config not in CONFIGS:
            raise ValueError(f"config {config!r} not in {CONFIGS}")
        cfg = get_smoke_config(arch) if config == "smoke" else \
            get_config(arch)
        if dtype:
            cfg = cfg.replace(dtype=dtype)
        self.cfg = cfg
        self.device = resolve(device)
        g = sbm_graph(n, n_clusters, p_in=0.04, p_out=0.002,
                      feat_dim=cfg.feat_dim, n_classes=cfg.n_classes,
                      seed=seed)
        rng = np.random.default_rng(seed)
        self.train_mask = rng.random(g.n) < 0.6
        self.prep = prepare_node_task(g, cfg, bq=32, bk=32, d_b=8,
                                      beta_thre=beta_thre,
                                      train_mask=self.train_mask)
        self.batch = batch_to_torch(self.prep.batch, self.device)
        # eval batch: all labels visible
        prep_all = prepare_node_task(g, cfg, bq=32, bk=32, d_b=8,
                                     beta_thre=beta_thre)
        self.eval_batch = batch_to_torch(prep_all.batch, self.device)
        self.eval_labels = np.asarray(prep_all.batch["labels"][0])
        self.g = g
        self.model = GraphModel(cfg, device=self.device, seed=seed)
        self.params = list(self.model.parameters())
        # the dense step's bucket matrix, a constant of the layout: built
        # and uploaded once, gathered from the live table every raw step
        self.dense_buckets = None
        if hasattr(self.model, "bias_table"):
            self.dense_buckets = torch.from_numpy(
                dense_buckets_from_layout(self.prep.layout)).to(self.device)

    def _dense_bias(self):
        if self.dense_buckets is None:
            return None
        return dense_bias_from_buckets(self.dense_buckets,
                                       self.model.bias_table,
                                       self.cfg.n_heads)

    def _step(self, opt, *, dense: bool, bias: bool):
        """One epoch: the loss of the mode's step, its gradients and one
        AdamW update. Returns the loss and the training accuracy."""
        batch = self.batch
        if dense:
            batch = dict(batch, dense_bias=self._dense_bias() if bias
                         else None)
        loss, m = graph_loss(self.model, batch, dense=dense)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        # a parameter the step does not reach (bias_table under flash)
        # gets a zero gradient, as under jax.value_and_grad: weight decay
        # and the moments' decay still apply to it
        opt.update([torch.zeros_like(p) if g is None else g
                    for g, p in zip(grads, self.params)])
        return loss.detach(), m["acc"].detach()

    def train(self, mode: str, epochs: int = 60, interleave_period: int = 8,
              seed: int = 0, params: dict | None = None):
        """Trains from the seeded init (or from ``params``, a state dict
        such as ``convert.params_from_jax`` gives) with a fresh optimizer.
        Returns ``(history, seconds_per_epoch, test_acc)``: one
        ``{"epoch", "loss", "train_acc"}`` an epoch, the median epoch wall
        (each to a device synchronisation) without epochs 0 and 1, and the
        held-out accuracy. The model keeps the trained parameters."""
        if mode not in MODES:
            raise ValueError(mode)
        if params is None:
            self.model.reset_parameters(seed)
        else:
            self.model.load_state_dict(params)
        opt = AdamW(self.params, lr=2e-3, weight_decay=0.01)
        cond_ok = self.prep.report.ok
        hist, times = [], []
        for ep in range(epochs):
            dense = mode in ("raw", "flash") or (
                mode == "torchgt" and use_dense_step(ep, interleave_period,
                                                     cond_ok))
            t0 = time.perf_counter()
            loss, acc = self._step(opt, dense=dense, bias=mode != "flash")
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            times.append(time.perf_counter() - t0)
            hist.append({"epoch": ep, "loss": float(loss),
                         "train_acc": float(acc)})
        acc = self.test_acc()
        # drop the first epochs' start-up from timing (paper: a warm-up)
        t_epoch = float(np.median(times[2:]))
        return hist, t_epoch, acc

    @torch.no_grad()
    def test_acc(self) -> float:
        """Accuracy on the held-out positions, read on the sparse path.
        The positions are the reference's: those whose sequence index the
        training mask (indexed by node id) leaves out, after the global
        tokens. They are the held-out nodes where the prep keeps the node
        order (``prep.perm`` the identity, as on the harness's graphs)
        and would take in trained-on nodes where it does not."""
        logits = graph_predict(self.model, self.eval_batch).float()
        pred = logits[0].argmax(-1).cpu().numpy()
        mask = self.eval_labels >= 0
        ng = self.cfg.n_global
        test = mask.copy()
        test[ng:ng + self.g.n] &= ~self.train_mask
        test[:ng] = False
        if test.sum() == 0:
            return 0.0
        return float((pred[test] == self.eval_labels[test]).mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.node_classification",
        description="GP-RAW, GP-FLASH and TorchGT trained on one synthetic "
                    "SBM graph: epoch time and held-out accuracy")
    ap.add_argument("--epochs", type=int, default=80)
    ap.add_argument("--nodes", type=int, default=768)
    ap.add_argument("--arch", default="graphormer_slim",
                    choices=["graphormer_slim", "graphormer_large", "gt"])
    ap.add_argument("--config", default="smoke", choices=CONFIGS,
                    help="the arch's smoke config (default) or the "
                         "published one")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without it)")
    args = ap.parse_args(argv)

    bench = GraphTrainBench(arch=args.arch, n=args.nodes, device=args.device,
                            config=args.config)
    print(f"{args.arch} ({bench.cfg.name}) on SBM(n={args.nodes}): "
          f"beta_G={bench.g.sparsity:.4f} "
          f"layout density={bench.prep.layout.density():.3f}")
    print(f"{'system':10s} {'t_epoch':>10s} {'test_acc':>9s}")
    results = {}
    for mode, label in SYSTEMS:
        _, t_epoch, acc = bench.train(mode, epochs=args.epochs)
        results[mode] = t_epoch
        print(f"{label:10s} {t_epoch*1e3:8.1f}ms {acc:9.3f}")
    where = (torch.cuda.get_device_name(bench.device)
             if bench.device.type == "cuda" else "the CPU")
    print(f"TorchGT speedup vs GP-FLASH: "
          f"{results['flash'] / results['torchgt']:.2f}x (median epoch wall "
          f"clock on {where})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
