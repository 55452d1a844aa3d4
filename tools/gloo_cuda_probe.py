#!/usr/bin/env python3
"""Check which collectives a gloo group takes for CUDA tensors, with
``--ranks`` processes sharing card 0, and time them.

  python3 tools/gloo_cuda_probe.py [--ranks 2]

Each rank calls ``dist.all_to_all_single``, ``dist.all_reduce`` (sum and
max) and ``dist.broadcast`` on small CUDA tensors (the values checked),
then times a 128 MiB bf16 all-to-all on CUDA tensors, the same through
an explicit host copy, and a 256 MiB fp32 all-reduce (wall clock around
each call, the card synchronised), and builds the (data, model)
``DeviceMesh`` ``launch/mesh.make_host_mesh`` builds. Prints one JSON
line per rank: each collective "ok" with its ms and result, or
"refused" with the error. The port's collectives
(``src/repro_torch/parallel/collectives.py``) hand CUDA tensors to gloo
as they are because this probe found none refused. Exits 2 without a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def _rank(rank, world, path):
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    res = {"rank": rank}

    def probe(name, fn):
        try:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            res[name] = ["ok", (time.perf_counter() - t0) * 1e3, out]
        except RuntimeError as e:
            res[name] = ["refused", repr(e)[:300]]

    def a2a(n, dtype, host=False):
        x = torch.arange(n, device=dev, dtype=dtype) + 100 * rank
        src = x.cpu() if host else x
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src)
        out = out.to(dev)
        return out[:8].tolist() if n <= 64 else n

    def reduce(op):
        x = torch.ones(4, device=dev) * (rank + 1)
        dist.all_reduce(x, op=op)
        return x.tolist()

    def bcast():
        x = torch.ones(2, device=dev) * (rank + 5)
        dist.broadcast(x, 0)
        return x.tolist()

    def big_reduce():
        x = torch.ones(64 << 20, device=dev)
        dist.all_reduce(x)
        return x.numel()

    probe("all_to_all_single", lambda: a2a(8 * world, torch.float32))
    probe("all_reduce_sum", lambda: reduce(dist.ReduceOp.SUM))
    probe("all_reduce_max", lambda: reduce(dist.ReduceOp.MAX))
    probe("broadcast", bcast)
    probe("all_to_all_128MiB_bf16", lambda: a2a(64 << 20, torch.bfloat16))
    probe("all_to_all_128MiB_bf16_via_host",
          lambda: a2a(64 << 20, torch.bfloat16, host=True))
    probe("all_reduce_256MiB_fp32", big_reduce)
    from torch.distributed.device_mesh import init_device_mesh
    res["device_mesh"] = str(init_device_mesh(
        "cpu", (1, world), mesh_dim_names=("data", "model")))
    print(json.dumps(res), flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(args.ranks, os.path.join(tmp, "rdzv")),
                 nprocs=args.ranks, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
