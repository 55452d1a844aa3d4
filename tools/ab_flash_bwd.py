#!/usr/bin/env python3
"""Hold this tree's bf16 flash dQ and dK/dV kernels
(``flash_attention_bwd_{dq,dkv}_sm90.cu``, rows 8 and 9 of PERF.md's
kernel table) against the same sources of another checkout, side by side
on one CUDA card.

  git archive <commit> | tar -x -C _local/base
  python3 tools/ab_flash_bwd.py --base _local/base

Both trees' sources are built (one nvcc each, all started together) and
launched through this tree's wrappers on the same seeded inputs: the
Qwen3-0.6B training shape of the flash kernels (S=16384, 16 q heads over
8, Dh 128, causal) and small cases (ragged S, GQA, Dh 32 and 64, B=2,
non-causal). Each output must be bit-identical between the trees. At
the training shape each kernel is timed with CUDA events in turns (base,
this tree, this tree, base; the median of ``--reps`` launches each), and
the ratio of this tree's mean to the base's is printed. Exits 1 when an
output differs, 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = pathlib.Path("src/repro_torch/kernels/csrc")
KERNELS = (("dq", "flash_attention_bwd_dq_sm90.cu", "LIBRARY_DQ_SM90"),
           ("dkv", "flash_attention_bwd_dkv_sm90.cu", "LIBRARY_DKV_SM90"))
# (B, S, H, KV, Dh, causal): the training shape first, then small cases
CASES = ((1, 16384, 16, 8, 128, True), (2, 1000, 4, 2, 64, True),
         (1, 77, 2, 1, 32, True), (1, 700, 4, 4, 128, False))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=pathlib.Path,
                    help="root of the checkout to compare against")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_flash_bwd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    libs = {}
    for half, src, attr in KERNELS:
        this = getattr(tfa, attr)
        base = kbuild.CudaLibrary(args.base.resolve() / CSRC / src,
                                  this._bind)
        libs[half] = {"base": base, "this": this}
    kbuild.build_all([lib for pair in libs.values()
                      for lib in pair.values()])
    for half, pair in libs.items():
        for tree, lib in pair.items():
            for line in lib.log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {half} {tree}: {line.strip()}")

    def run(half, tree, q, k, v, do, lse, delta, causal):
        _, _, attr = next(x for x in KERNELS if x[0] == half)
        saved = getattr(tfa, attr)
        setattr(tfa, attr, libs[half][tree])
        try:
            fn = tfa.dq_kernel if half == "dq" else tfa.dkv_kernel
            return fn(q, k, v, do, lse, delta, causal, False)
        finally:
            setattr(tfa, attr, saved)

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
    ok, rec = True, []
    for i, (B, S, H, KV, Dh, causal) in enumerate(CASES):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        q, do = (torch.randn(B, S, H, Dh, generator=gen, device=dev)
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(B, S, KV, Dh, generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                         block_q=128, block_k=128,
                                         return_lse=True)
        delta = ref.row_delta(do, o)
        operands = (q, k, v, do, lse, delta, causal)
        for half, _, _ in KERNELS:
            outs = {t: run(half, t, *operands) for t in ("base", "this")}
            torch.cuda.synchronize()
            outs = {t: x if isinstance(x, tuple) else (x,)
                    for t, x in outs.items()}
            same = all(torch.equal(a, b) for a, b in zip(outs["base"],
                                                         outs["this"]))
            ok = ok and same
            r = {"case": [B, S, H, KV, Dh, causal], "kernel": half,
                 "bit_identical": same}
            if i == 0:
                t = {"base": [], "this": []}
                for tree in ("base", "this", "this", "base"):
                    t[tree].append(ms(lambda: run(half, tree, *operands)))
                r["base_ms"], r["this_ms"] = t["base"], t["this"]
                r["ratio"] = sum(t["this"]) / sum(t["base"])
            rec.append(r)
            print(f"[ab] {half} B={B} S={S} H={H} KV={KV} Dh={Dh} "
                  f"causal={causal}: "
                  f"{'bit-identical' if same else 'DIFFERENT'}"
                  + (f"; base {r['base_ms']} ms, this tree {r['this_ms']} "
                     f"ms, this/base {r['ratio']:.4f}" if i == 0 else ""),
                  flush=True)
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi.splitlines()[0], "results": rec}))
    return 0 if ok else 1


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
