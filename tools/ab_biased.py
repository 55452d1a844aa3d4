#!/usr/bin/env python3
"""Hold this tree's bf16 biased cluster-sparse forward, dQ and dK/dV
kernels (``cluster_attention_fwd_sm90.cu``,
``cluster_attention_bwd_dq_sm90.cu``, ``cluster_attention_bwd_dkv_sm90.cu``,
rows 1, 3 and 4 of PERF.md's kernel table) against the same sources of
other checkouts, side by side on one CUDA card. A checkout from before
the bf16 dQ kernel ran bf16 dQ on the CUDA-core kernel of
``cluster_attention_bwd.cu``: that one is built and launched in its
place.

  git archive <commit> | tar -x -C _local/base
  python3 tools/ab_biased.py --base _local/base [--base _local/other ...]

Every tree's three sources are built (one nvcc each, all started
together) and launched through this tree's wrappers on the same seeded
inputs at
Graphormer-Large's heads (32 heads, Dh 24): the serve shape (the
32768-node SBM, S=32800) and the nearly dense training rung of the
8192-node graph (S=8224, the ladder rung with the most visited blocks,
with the trainer's padded layout). Each output is compared with this
tree's: bit-identical, or its largest difference (O and lse within 2e-2
and 1e-4, dq, the bias gradient, dk and dv within 1e-2 of their largest
value). Each kernel is
timed with CUDA events in turns (base, this tree, this tree, base; the
median of ``--reps`` launches each) and the ratio of this tree's mean to
the base's printed. Exits 1 when an output is out of tolerance, 2
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = pathlib.Path("src/repro_torch/kernels/csrc")
KERNELS = (("fwd", "cluster_attention_fwd_sm90.cu", "LIBRARY_SM90"),
           ("dq", "cluster_attention_bwd_dq_sm90.cu", "LIBRARY_DQ_SM90"),
           ("dkv", "cluster_attention_bwd_dkv_sm90.cu", "LIBRARY_DKV_SM90"))
# the source (and its binder) that ran a kernel's bf16 work in trees
# without its source: the CUDA-core dQ of both dtypes
LEGACY = {"dq": ("cluster_attention_bwd.cu", "_bind")}
TOL = {"out": 2e-2, "lse": 1e-4, "dq": 1e-2, "dbias": 1e-2, "dk": 1e-2,
       "dv": 1e-2}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=pathlib.Path,
                    action="append", help="root of a checkout to compare "
                    "against (repeatable)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_biased: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data.graph_pipeline import prepare_node_task
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import cluster_attention as tca
    from repro_torch.kernels import cluster_attention_bwd as tcab
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import degree_scaled_sbm
    from repro_torch.tasks import NodeTask

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    mods = {"fwd": tca, "dq": tcab, "dkv": tcab}
    trees = {"this": None, **{str(b): b.resolve() for b in args.base}}

    def library(half, src, attr, root):
        """This tree's library of a kernel, or another tree's (its own
        source, or the one that ran the kernel's bf16 work there)."""
        if root is None:
            return getattr(mods[half], attr)
        if not (root / CSRC / src).exists() and half in LEGACY:
            old, bind = LEGACY[half]
            return kbuild.CudaLibrary(root / CSRC / old,
                                      getattr(mods[half], bind))
        return kbuild.CudaLibrary(root / CSRC / src,
                                  getattr(mods[half], attr)._bind)
    libs = {half: {t: library(half, src, attr, root)
                   for t, root in trees.items()}
            for half, src, attr in KERNELS}
    kbuild.build_all([lib for per in libs.values() for lib in per.values()])
    for half, per in libs.items():
        for tree, lib in per.items():
            for line in lib.log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {half} {tree}: {line.strip()}")

    def legacy_dq(lib, q, k, v, do, lse, delta, bi, bu, bias):
        """bf16 dQ on a tree's CUDA-core ``cluster_attention_bwd_dq``."""
        B, S, H, Dh = q.shape
        nq, mb = bi.shape[-2:]
        nb = bias.shape[1]
        dq = torch.empty_like(q)
        db = torch.empty((B, H, nq, nb), dtype=torch.float32, device=dev)
        err = lib.lib().cluster_attention_bwd_dq(
            *(x.data_ptr() for x in (q, k, v, do, lse, delta, bi, bu, bias,
                                     dq, db)),
            1, B, S, H, k.shape[2], Dh, nq, mb, 32, 32, nb,
            int(bi.dim() == 3), Dh ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"legacy dQ launch failed: CUDA error {err}")
        return dq, db

    def run(half, tree, *operands):
        _, src, attr = next(x for x in KERNELS if x[0] == half)
        lib = libs[half][tree]
        if half == "dq" and lib.source.name != src:
            dq, db = legacy_dq(lib, *operands)
            return dq, db.sum(dim=(0, 2))
        saved = getattr(mods[half], attr)
        setattr(mods[half], attr, lib)
        try:
            if half == "fwd":
                return tca.cluster_attention_fwd(*operands, return_lse=True)
            if half == "dq":
                dq, db = tcab.dq_kernel(*operands)
                return dq, db.sum(dim=(0, 2))
            return tcab.dkv_kernel(*operands)
        finally:
            setattr(mods[half], attr, saved)

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[len(times) // 2]

    dev = torch.device("cuda")
    large = get_config("graphormer_large")
    g = degree_scaled_sbm(32768, 32, large, seed=0)
    serve = prepare_node_task(g, large, bq=32, bk=32, d_b=8)
    g8 = degree_scaled_sbm(8192, 32, large, seed=0)
    task = NodeTask(g8, large, train_mask=np.random.default_rng(0).random(
        g8.n) < 0.5, bq=32, bk=32, d_b=8, device="cpu")
    rung = max((p[0] for p in task._preps.values()),
               key=lambda p: p.layout.stats["active_blocks"])
    layouts = {"serve shape": (serve.batch, serve.layout.n_buckets),
               "nearly dense rung": (rung.batch, rung.layout.n_buckets)}
    ok, rec = True, []
    for i, (tag, (batch, nb)) in enumerate(layouts.items()):
        bi, bu, bit = (torch.from_numpy(np.ascontiguousarray(batch[k]))
                       .to(dev) for k in ("block_idx", "buckets",
                                          "block_idx_t"))
        S = bi.shape[-2] * 32
        gen = torch.Generator(device=dev).manual_seed(200 + i)
        q, k, v, do = (torch.randn(1, S, large.n_heads, large.head_dim,
                                   generator=gen, device=dev).bfloat16()
                       for _ in range(4))
        bias = torch.randn(large.n_heads, nb, generator=gen,
                           device=dev) * 0.5
        o, lse = tca.cluster_attention_fwd(q, k, v, bi, bu, bias,
                                           return_lse=True)
        delta = ref.row_delta(do, o)
        operands = {"fwd": (q, k, v, bi, bu, bias),
                    "dq": (q, k, v, do, lse, delta, bi, bu, bias),
                    "dkv": (q, k, v, do, lse, delta, bi, bit, bu, bias)}
        names = {"fwd": ("out", "lse"), "dq": ("dq", "dbias"),
                 "dkv": ("dk", "dv")}
        for half, _, _ in KERNELS:
            outs = {t: run(half, t, *operands[half]) for t in trees}
            torch.cuda.synchronize()
            for tree in trees:
                if tree == "this":
                    continue
                r = {"shape": tag, "kernel": half, "base": tree,
                     "bit_identical": all(torch.equal(a, b) for a, b in zip(
                         outs[tree], outs["this"]))}
                for name, a, b in zip(names[half], outs[tree],
                                      outs["this"]):
                    d = (a.float() - b.float()).abs().max().item()
                    scale = 1.0 if name in ("out", "lse") else \
                        b.float().abs().max().item()
                    r[f"max_diff_{name}"] = d
                    ok = ok and d <= TOL[name] * max(scale, 1e-30)
                t = {"base": [], "this": []}
                for who in ("base", "this", "this", "base"):
                    t[who].append(ms(lambda: run(
                        half, tree if who == "base" else "this",
                        *operands[half])))
                r["base_ms"], r["this_ms"] = t["base"], t["this"]
                r["ratio"] = sum(t["this"]) / sum(t["base"])
                rec.append(r)
                print(f"[ab] {tag} {half} vs {tree}: "
                      + ("bit-identical" if r["bit_identical"] else
                         ", ".join(f"{k} {v:.3g}" for k, v in r.items()
                                   if k.startswith("max_diff")))
                      + f"; base {r['base_ms']} ms, this tree "
                      f"{r['this_ms']} ms, this/base {r['ratio']:.4f}",
                      flush=True)
        del q, k, v, do, o, lse, delta, bi, bu, bit
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi.splitlines()[0], "results": rec}))
    return 0 if ok else 1


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
