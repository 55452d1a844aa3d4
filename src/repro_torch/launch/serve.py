"""Serving CLI for the graph archs on the port (the graph half of
``repro.launch.serve``).

Builds a degree-scaled SBM graph (expected intra-cluster degree
``DEG_IN``, inter-cluster degree ``DEG_OUT``), answers node and link
queries through :class:`repro_torch.serve.GraphServe`, answers them again
from the layout cache, and reports prep and forward times.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch graphormer_large \\
      --full --graph-nodes 32768
  PYTHONPATH=src python -m repro_torch.launch.serve --arch graphormer_slim \\
      --graph-nodes 96 --queries 8 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import GRAPH_ARCHS, get_config, get_smoke_config
from repro_torch.core.graph import sbm_graph
from repro_torch.core.graph_model import GraphModel
from repro_torch.serve import GraphServe


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


def serve_graph(args) -> None:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="graphormer_slim",
                    choices=GRAPH_ARCHS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--graph-nodes", type=int, default=96)
    ap.add_argument("--graph-clusters", type=int, default=4)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    serve_graph(ap.parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
