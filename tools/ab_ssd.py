#!/usr/bin/env python3
"""Hold this tree's Mamba2 SSD scan (``ssd.cu``, row 10 of PERF.md's
kernel table) against the same source of other checkouts, side by side on
one CUDA card.

  git archive <commit> | tar -x -C _local/base
  python3 tools/ab_ssd.py --base _local/base [--base _local/other ...]

Every tree's source is built (one nvcc each, all started together) and
launched on the same seeded inputs at Mamba2-2.7B's width (80 heads of
dh 64, N 128, S=16384, B=1), in bf16 and fp32, at the chunks the tuner
offers (64, 128, 256, 512). A source whose ``ssd_fwd`` takes no scratch
(the serial kernel before the chunk-parallel one) is called without it.
Each tree's y and final state are held to ``ssd_chunked`` (y within 2e-2
in bf16 and 1e-4 in fp32, the state within 1e-4, of their largest value)
and compared with this tree's (bit-identical or not). Each tree is timed
with CUDA events in turns (this tree first, then the bases, then in
reverse; the median of ``--reps`` calls each), its call's peak device
memory above what was allocated before it (outputs and scratch) is read
from the allocator, and this tree's four kernels are timed by the
profiler. Exits 1 when an output is out of tolerance, 2 without a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = pathlib.Path("src/repro_torch/kernels/csrc/ssd.cu")
TOL_Y = {"bfloat16": 2e-2, "float32": 1e-4}
TOL_STATE = 1e-4


def _takes_scratch(source: pathlib.Path) -> bool:
    """Whether the source's ``ssd_fwd`` takes the chunk-parallel kernels'
    scratch (its ``cb`` pointer)."""
    text = source.read_text()
    params = re.search(r"int\s+ssd_fwd\s*\(([^)]*)\)", text).group(1)
    return re.search(r"\bvoid\*\s*cb\b", params) is not None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=pathlib.Path,
                    action="append", help="root of a checkout to compare "
                    "against (repeatable)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_ssd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import ssd as tks
    from repro_torch.models.ssm import ssd_chunked

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)

    def bind_serial(lib):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_fwd.argtypes = [vp] * 7 + [i32] * 7 + [vp]
        lib.ssd_fwd.restype = i32

    libs = {"this": tks.LIBRARY}
    for base in args.base:
        src = base.resolve() / SOURCE
        libs[str(base)] = kbuild.CudaLibrary(
            src, tks._bind if _takes_scratch(src) else bind_serial)
    kbuild.build_all(list(libs.values()))
    for tree, lib in libs.items():
        used = [x.split(":")[-1].strip() for x in lib.log.splitlines()
                if "registers" in x]
        spills = [x.strip() for x in lib.log.splitlines()
                  if "spill stores" in x and not x.strip().startswith("0 ")]
        print(f"[build] {tree}: {'; '.join(used)}"
              + (f"; {'; '.join(spills)}" if spills else ""), flush=True)

    def run(tree, x, dt, a, b, c, chunk):
        lib = libs[tree]
        if lib._bind is tks._bind:
            saved = tks.LIBRARY
            tks.LIBRARY = lib
            try:
                return tks.ssd_fwd(x, dt, a, b, c, chunk=chunk)
            finally:
                tks.LIBRARY = saved
        B, S, H, dh = x.shape
        N = b.shape[-1]
        y = torch.empty_like(x)
        state = torch.empty((B, H, dh, N), device=x.device)
        err = lib.lib().ssd_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), state.data_ptr(),
            int(x.dtype == torch.bfloat16), B, S, H, dh, N, chunk,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{tree}: ssd_fwd launch failed: CUDA error "
                               f"{err}")
        return y, state

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return sorted(times)[len(times) // 2]

    def peak_bytes(fn):
        """Device memory one call allocates at its peak, above what was
        allocated before it (its outputs and scratch)."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        del out
        return torch.cuda.max_memory_allocated() - before

    def rel(u, v):
        return ((u.float() - v.float()).abs().max()
                / v.float().abs().max()).item()

    dev = torch.device("cuda")
    ok, rec = True, []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        gen = torch.Generator(device=dev).manual_seed(52)
        B, S, H, dh, N = 1, 16384, 80, 64, 128
        x = torch.randn(B, S, H, dh, generator=gen, device=dev).to(dtype)
        dt = torch.nn.functional.softplus(
            torch.randn(B, S, H, generator=gen, device=dev) - 2)
        a = -torch.exp(torch.randn(H, generator=gen, device=dev) * 0.3)
        b = torch.randn(B, S, N, generator=gen, device=dev).to(dtype)
        c = torch.randn(B, S, N, generator=gen, device=dev).to(dtype)
        for chunk in (64, 128, 256, 512):
            py, pstate = ssd_chunked(x, dt, a, b, c, chunk)
            outs = {t: run(t, x, dt, a, b, c, chunk) for t in libs}
            times = {t: [] for t in libs}
            for order in (list(libs), list(libs)[::-1]):
                for t in order:
                    times[t].append(ms(lambda: run(t, x, dt, a, b, c,
                                                   chunk)))
            for t, (y, state) in outs.items():
                r = {"dtype": name, "chunk": chunk, "tree": t,
                     "rel_y": rel(y, py), "rel_state": rel(state, pstate),
                     "bit_identical_to_this": torch.equal(
                         y, outs["this"][0]) and torch.equal(
                         state, outs["this"][1]),
                     "ms": times[t],
                     "ratio_this": sum(times["this"]) / sum(times[t]),
                     "peak_bytes": peak_bytes(
                         lambda: run(t, x, dt, a, b, c, chunk))}
                ok = ok and r["rel_y"] <= TOL_Y[name] \
                    and r["rel_state"] <= TOL_STATE
                rec.append(r)
                same = ", bit-identical" if r["bit_identical_to_this"] \
                    else ""
                print(f"[ab] {name} chunk {chunk} {t}: rel y "
                      f"{r['rel_y']:.3g}, state {r['rel_state']:.3g}{same}"
                      f"; {r['ms']} ms, this/it {r['ratio_this']:.4f}; "
                      f"peak {r['peak_bytes'] / 2**20:.1f} MiB",
                      flush=True)
            del py, pstate, outs
        # a mean over the launches the profiler caught in three calls (it
        # may miss the first kernels of a session)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run("this", x, dt, a, b, c, 256)
            torch.cuda.synchronize()
        parts = {}
        for k in ("ssd_cb", "ssd_states", "ssd_scan", "ssd_y"):
            evs = [e for e in prof.key_averages()
                   if f"{k}<" in e.key or f"{k}(" in e.key]
            parts[k] = sum(e.device_time_total for e in evs) / max(
                1, sum(e.count for e in evs)) / 1e3
        rec.append({"dtype": name, "chunk": 256, "tree": "this",
                    "ms_by_kernel": parts})
        print(f"[ab] {name} chunk 256 this, by kernel: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()),
              flush=True)
        del x, dt, a, b, c
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi.splitlines()[0], "results": rec}))
    return 0 if ok else 1


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
