"""Serving CLI on the port — the port of ``repro.launch.serve``.

Token LMs (the dense and MoE archs) go through
:class:`repro_torch.serve.ServeEngine`: chunked prefill + paged KV cache
+ continuous batching, two programs for the engine's life (audited on
every run), optionally under the TorchGT cluster-sparse decode mask
(``--sparse``), on one device or on a mesh of ``--mesh-model`` ranks
over ``--backend`` (``gloo`` or ``nccl``, required with a mesh): under
torchrun each process is one rank, else the CLI spawns its ranks
(``launch/mesh.spawn``), which serve the same requests, each holding its
share of the KV heads (every head where they do not split) and
experts, and rank 0 prints. The SSM and
hybrid archs have no paged serving path and are refused here, as in
the reference.

Graph archs go through :class:`repro_torch.serve.GraphServe`: the CLI
builds a degree-scaled SBM graph (expected intra-cluster degree
``DEG_IN``, inter-cluster degree ``DEG_OUT``), answers node and link
queries, answers them again from the layout cache, and reports prep and
forward times.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0_6b \
      --requests 12 --batch 4 --chunk 16 --page 16 [--sparse] --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3_moe_235b_a22b --requests 6 --batch 2 --chunk 16 \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3_moe_235b_a22b --mesh-model 2 --backend gloo --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0_6b \
      --full --requests 32 --batch 8 --prompt-len 2048 --max-tokens 128 \
      --max-len 4096 --chunk 256
  PYTHONPATH=src python -m repro_torch.launch.serve --arch graphormer_large \
      --full --graph-nodes 32768
  PYTHONPATH=src python -m repro_torch.launch.serve --arch graphormer_slim \
      --graph-nodes 96 --queries 8 --device cpu

``--device`` defaults to ``cuda`` and raises without CUDA.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.graph import sbm_graph
from repro_torch.core.graph_model import GraphModel
from repro_torch.launch import mesh as lmesh
from repro_torch.models.api import lm_model_class
from repro_torch.serve import GraphServe, ServeEngine


# the served graph's recipe (PERF.md, section 4): each node expects 16
# neighbours inside its cluster and 2 outside, whatever the graph's size
DEG_IN = 16.0
DEG_OUT = 2.0


def degree_scaled_sbm(n: int, clusters: int, cfg, *, seed: int = 0):
    """SBM whose expected degrees stay fixed as ``n`` grows:
    ``p_in = DEG_IN / (n / clusters)``, ``p_out = DEG_OUT / n``."""
    return sbm_graph(n, clusters, p_in=min(1.0, DEG_IN * clusters / n),
                     p_out=min(1.0, DEG_OUT / n), feat_dim=cfg.feat_dim,
                     n_classes=cfg.n_classes, seed=seed)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(model, args) -> int:
    eng = ServeEngine(model, batch_slots=args.batch, page=args.page,
                      max_len=args.max_len, chunk=args.chunk,
                      sparse=args.sparse, mesh_model=args.mesh_model)
    rng = np.random.default_rng(0)
    cfg = model.cfg
    for rid in range(args.requests):
        plen = int(rng.integers(4, args.prompt_len + 1))
        eng.submit(rid, rng.integers(1, cfg.vocab_size // 8, plen).tolist(),
                   args.max_tokens,
                   arrival=rid * args.arrival_gap)
    stats = eng.run()
    if dist.is_initialized() and dist.get_rank() != 0:
        return 0
    lat = sorted(r["latency_s"] for r in eng.request_stats)
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
    if args.mesh_model > 1:
        print(f"mesh={{'data': 1, 'model': {args.mesh_model}}} "
              f"recipe={eng.recipe.name} pool_bytes_per_rank="
              f"{eng.pool_bytes()}")
    print(f"served {stats['requests']} requests / {stats['tokens']} tokens "
          f"in {stats['seconds']:.2f}s ({stats['tok_per_s']:.1f} tok/s, "
          f"{stats['prefill_calls']} prefill + {stats['decode_calls']} "
          f"decode calls, {stats['traced_programs']} traced programs, "
          f"{args.batch} slots, page={args.page}, sparse={args.sparse}; "
          f"{cfg.name} on {model.device})")
    print(f"latency p50={p50 * 1e3:.1f}ms p99={p99 * 1e3:.1f}ms "
          f"(free blocks at drain: {eng.allocator.n_free}/"
          f"{eng.allocator.num_blocks - 1})")
    for rid in sorted(eng.done)[:3]:
        print(f"  req {rid}: {eng.done[rid][:10]}")
    return 0


def serve_graph(cfg, args) -> int:
    model = GraphModel(cfg, device=args.device, seed=args.seed)
    dev = model.device
    g = degree_scaled_sbm(args.graph_nodes, args.graph_clusters, cfg,
                          seed=args.seed)
    srv = GraphServe(model)
    rng = np.random.default_rng(args.seed)
    nodes = rng.integers(0, g.n, args.queries)
    eidx = rng.integers(0, len(g.src), args.queries)
    rnd = rng.integers(0, g.n, (2, args.queries))
    passes = []
    for _ in range(2):          # the second pass answers from the cache
        _sync(dev)
        t0 = time.perf_counter()
        out = srv.node(g, nodes)
        link_pos = srv.link(g, g.src[eidx], g.dst[eidx])
        link_rnd = srv.link(g, rnd[0], rnd[1])
        _sync(dev)
        passes.append(time.perf_counter() - t0)
    prep = srv.prepared(g)[0]
    st = prep.layout.stats
    print(f"GraphServe[{cfg.name} on {dev}]: {g.n}-node graph, "
          f"{g.e} directed edges; {args.queries} node + "
          f"{2 * args.queries} link queries: first pass {passes[0]:.3f}s "
          f"(prep {prep.prep_seconds:.3f}s), cached pass {passes[1]:.3f}s "
          f"({srv.n_cached_layouts()} cached layout)")
    print(f"  layout: S={prep.layout.seq_len} nq={prep.layout.nq} "
          f"mb={prep.layout.mb} active_blocks={st['active_blocks']} "
          f"density={st['density']:.5f}")
    print(f"  node labels: {out['labels'][:8].tolist()}")
    print(f"  link score (edges):  mean {link_pos['scores'].mean():+.3f}")
    print(f"  link score (random): mean {link_rnd['scores'].mean():+.3f}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="graphormer_slim", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    # token-LM engine knobs
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--page", type=int, default=16)
    ap.add_argument("--arrival-gap", type=float, default=0.0,
                    help="seconds between request arrivals (offered load)")
    ap.add_argument("--sparse", action="store_true")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="ranks the KV heads and experts are sharded over")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="torch.distributed backend of a mesh (required "
                         "with one)")
    # graph endpoint knobs
    ap.add_argument("--graph-nodes", type=int, default=96)
    ap.add_argument("--graph-clusters", type=int, default=4)
    ap.add_argument("--queries", type=int, default=8)
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.mesh_model > 1:
        if cfg.family == "graph":
            ap.error("--mesh-model serves token LMs; GraphServe runs on one "
                     "device")
        if args.backend is None:
            ap.error("--mesh-model needs --backend (gloo or nccl)")
        if not dist.is_initialized():
            if not lmesh.torchrun_env():
                lmesh.spawn(main, args.mesh_model, backend=args.backend,
                            args=(argv,))
                return 0
            lmesh.from_torchrun(args.backend)
        args.device = lmesh.rank_device(args.device)
    if cfg.family == "graph":
        return serve_graph(cfg, args)
    model_cls = lm_model_class(cfg)
    if model_cls.paged_decode is None:
        # a recurrent decode state is not a positional KV cache — fail
        # at the CLI boundary, before building the model, with the
        # servable families
        ap.error(f"--arch {args.arch} (family {cfg.family!r}) has no "
                 f"paged serving path; servable: dense/moe/vlm token LMs "
                 f"and graph archs (GraphServe)")
    return serve_lm(model_cls(cfg, device=args.device, seed=args.seed), args)


if __name__ == "__main__":
    raise SystemExit(main())
