#!/usr/bin/env python3
"""Time this tree's training loop (``runtime/trainer.py``) and its
cluster-op calls against other checkouts' on one CUDA card, at ``chip_smoke.py`` phase 8's GT
graph-level shape: ``GRAPH_TRAIN`` graphs (seed 1) in mini-batches of
``GRAPH_BATCH``, 16 x 16 blocks, ``GRAPH_STEPS`` steps, a dense step
every ``interleave_period`` and an AutoTuner epoch every
``elastic_every`` steps (the config's), no checkpoints. Its sparse steps
take a few milliseconds of device time each, so the loop's host cost
shows in them.

  git archive <commit> | tar -x -C _local/base
  python3 tools/ab_trainer.py --base _local/base [--base _local/other] \
      [--rounds 3] [--runs 4]

Each tree's package runs in processes of its own (``--child``), in turns
(each base, this tree, this tree, each base in reverse) for ``--rounds``
rounds; a process
builds the three 16 x 16 kernels' sources first, then trains ``--runs``
times, each on a fresh model and task. Every run reports its sparse-step
median (ms), its dense-step median (step 0 left out), and the median of
the loop's own host time a step (the step's ``seconds`` in ``history``
less the time inside ``Trainer.step``), and the median host time of one
``kernels/ops.cluster_attention`` call (its forward: the wall time of
the call, which waits for no kernel). The summary gives each tree's
median over all its runs, the range, and the ratio of this tree's
median to each base's. The record goes to ``--out``. Exits 2 without a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def child(tree: pathlib.Path, runs: int) -> dict:
    """``runs`` training runs of ``tree``'s package; one record each."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # the phase's constants, from this tree
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.core.graph_model import GraphModel
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import cluster_attention as tca
    from repro_torch.kernels import cluster_attention_bwd as tcab
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tasks import (GraphLevelTask,
                                   synthetic_graph_level_dataset)

    src = pathlib.Path(repro_torch.__file__).resolve()
    if not src.is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {src}, not {tree}'s package")
    dev = torch.device("cuda")
    from repro_torch.kernels import ops as kops

    kbuild.build_all((tca.LIBRARY_SM90, tcab.LIBRARY_DQ_SM90,
                      tcab.LIBRARY_DKV_SM90))
    gt = get_config("gt")
    op_s = []
    op = kops.cluster_attention

    def timed_op(*a, **kw):
        t0 = time.perf_counter()
        o = op(*a, **kw)
        op_s.append(time.perf_counter() - t0)
        return o
    kops.cluster_attention = timed_op
    out = []
    for _ in range(runs):
        op_s.clear()
        task = GraphLevelTask(
            synthetic_graph_level_dataset(cs.GRAPH_TRAIN, gt, seed=1), gt,
            batch_graphs=cs.GRAPH_BATCH, device=dev)
        tr = Trainer(GraphModel(gt, device=dev, seed=0), TrainerConfig(
            steps=cs.GRAPH_STEPS, lr=1e-3, warmup=2,
            interleave_period=gt.interleave_period,
            elastic_every=gt.elastic_every), task=task)
        inner = []
        step = tr.step

        def timed(*a, **kw):
            t0 = time.perf_counter()
            m = step(*a, **kw)
            inner.append(time.perf_counter() - t0)
            return m
        tr.step = timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        status = tr.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        hist = tr.history
        if status != "done" or len(hist) != cs.GRAPH_STEPS or any(
                h["skipped"] for h in hist):
            raise AssertionError(f"{tree}: status {status}, {len(hist)} "
                                 f"steps")
        ms = [h["seconds"] * 1e3 for h in hist]
        out.append({
            "run_s": run_s,
            "sparse_median_ms": float(np.median(
                [m for m, h in zip(ms, hist) if not h["dense"]])),
            "dense_median_ms": float(np.median(
                [m for m, h in zip(ms[1:], hist[1:]) if h["dense"]])),
            "loop_host_median_ms": float(np.median(
                [m - s * 1e3 for m, s in zip(ms, inner)])),
            "op_host_median_us": float(np.median(op_s)) * 1e6,
            "op_calls": len(op_s),
            "step_ms": ms, "moves": len(task.moves)})
        del tr, task
        torch.cuda.empty_cache()
    return {"tree": str(tree), "runs": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=pathlib.Path, action="append",
                    help="root of a checkout to compare against (may be "
                         "given more than once)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--runs", type=int, default=4,
                    help="training runs in each process")
    ap.add_argument("--out", default="chiprun_out/ab_trainer.json")
    ap.add_argument("--child", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_trainer: no CUDA device", file=sys.stderr)
        return 2
    if args.child is not None:
        print(json.dumps(child(args.child, args.runs)))
        return 0
    if not args.base:
        ap.error("--base is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    bases = [f"base{i}" if i else "base" for i in range(len(args.base))]
    trees = {**{b: p.resolve() for b, p in zip(bases, args.base)},
             "this": ROOT}
    results = {name: [] for name in trees}
    order = (bases + ["this", "this"] + bases[::-1]) * args.rounds
    for b in bases:
        print(f"{b}: {trees[b]}", flush=True)
    for i, name in enumerate(order):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, str(pathlib.Path(__file__).resolve()),
                 "--child", str(trees[name]), "--runs", str(args.runs)],
                capture_output=True, text=True, cwd=tmp, timeout=600,
                env={k: v for k, v in os.environ.items()
                     if k != "PYTHONPATH"})
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"ab_trainer: {name} process exited "
                             f"{proc.returncode}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        results[name].append(rec)
        for r in rec["runs"]:
            print(f"turn {i} {name:5s}: sparse median "
                  f"{r['sparse_median_ms']:.3f} ms, dense median "
                  f"{r['dense_median_ms']:.3f} ms, loop host median "
                  f"{r['loop_host_median_ms']:.4f} ms, cluster op host "
                  f"median {r['op_host_median_us']:.2f} us "
                  f"({r['op_calls']} calls), run "
                  f"{r['run_s']:.3f} s, {r['moves']} ladder moves",
                  flush=True)
        print(f"turn {i} {name:5s}: process "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    import numpy as np
    summary = {}
    for name, recs in results.items():
        runs = [r for rec in recs for r in rec["runs"]]
        summary[name] = {
            key: {"median": float(np.median([r[key] for r in runs])),
                  "min": float(min(r[key] for r in runs)),
                  "max": float(max(r[key] for r in runs))}
            for key in ("sparse_median_ms", "dense_median_ms",
                        "loop_host_median_ms", "op_host_median_us",
                        "run_s")}
        summary[name]["n_runs"] = len(runs)
    for key in ("sparse_median_ms", "dense_median_ms",
                "loop_host_median_ms", "op_host_median_us"):
        t = summary["this"][key]
        for b in bases:
            s = summary[b][key]
            print(f"{key}: {b} {s['median']:.4f} [{s['min']:.4f}, "
                  f"{s['max']:.4f}], this {t['median']:.4f} "
                  f"[{t['min']:.4f}, {t['max']:.4f}], ratio "
                  f"{t['median'] / s['median']:.4f}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": card, "trees": {k: str(v) for k, v in
                                           trees.items()},
                   "order": order, "summary": summary,
                   "results": results}, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
