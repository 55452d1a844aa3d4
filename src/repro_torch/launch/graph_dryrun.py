"""The paper's scale run (Fig. 9a: "graph sequence lengths of up to
1M"): Graphormer trained at S = 262,144 and 1,048,576 graph tokens in
mask-free cluster-sparse mode, on the card.

The port of ``repro.launch.graph_dryrun``. The reference compiles one
training step for a TPU mesh and reads its memory and roofline from the
compiled artifact; on the card the counterpart of compiling the step is
running it. :func:`run` builds the config with ``graph_bias=None`` (no
bias table: the reformed layout at 1M tokens is pure dense sub-blocks,
the bias rides the degree encodings) and ``remat="block"`` (the
default), and takes ``steps`` steps of ``launch/steps.make_train_step``
(the reference's ``make_train_step``): the sparse ``graph_loss``, its
gradients summed over the ranks of a mesh, and ``AdamW`` with
``warmup_cosine(3e-4, 100, 10_000)``. Its batch
(:func:`graph_batch`) is the reference spec's, drawn from a numpy
generator: no buckets, one layout for the one graph.

The record (one JSON line) holds the reference's keys ``arch``, ``seq``,
``mesh``, ``peak_gb`` and ``roofline``, and ``device`` (the card's name
and power limit), ``fits`` (the peak against the card's memory),
``step_ms`` (the median of the steps after the first, each to a
synchronisation), ``model_flops`` and ``mfu``, the losses and the FLOP
counts. Device numbers are None when the run is on the CPU.

Roofline convention. FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s
count of one step's products (forward, the recomputed forward, backward)
plus an analytic count of the cluster op, which the counter cannot see
inside the kernels: live blocks x bq x bk x Dh x H x (4 forward + 4
recomputed forward + 10 backward: S, dP, dV, dQ and dK, 2 each) a layer.
Bytes, a floor: the batch read once, each layer boundary's hidden state
written once and read once in bf16 (what ``remat="block"`` keeps), and
AdamW's fp32 parameters, gradients and two moments (28 bytes a
parameter: p, m, v read and written, g read). ``mfu`` is
``model_flops`` (``launch/roofline.py``: 6 N S) over the step time and
the card's bf16 peak.

  PYTHONPATH=src python -m repro_torch.launch.graph_dryrun \\
      --arch graphormer_large --seq 262144 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.graph_dryrun \\
      --arch graphormer_large --seq 2048 --steps 2 --device cpu --smoke

Without ``--device`` it runs on CUDA and raises without it. With
``--mesh-model P`` and ``--backend`` it spawns P ranks
(``launch/mesh.py``) and trains the sequence sharded P ways, rank 0
printing. It writes a file only with ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
from repro_torch.core.graph_model import GraphModel, graph_loss
from repro_torch.core.reformation import transpose_block_idx
from repro_torch.device import resolve
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import steps as lsteps
from repro_torch.launch.roofline import (PEAK_FLOPS, active_params,
                                         model_flops, roofline_terms)
from repro_torch.parallel.sharding import recipe_for
from repro_torch.tasks.base import shard_rows

# the per-node arrays, sharded by sequence on a mesh; the layouts stay
# whole on every rank
SEQ_KEYS = ("feat", "in_deg", "out_deg", "labels")
LR = 3e-4


def block_layout(nq: int, mb: int, rng) -> np.ndarray:
    """``(nq, mb)`` int32: each q-block row its diagonal k-block and
    ``mb - 1`` other distinct k-blocks, sorted, all live (the reference's
    "pure dense sub-blocks" at their densest for this width)."""
    if not 1 <= mb <= nq:
        raise ValueError(f"mb={mb} live blocks a row need 1 <= mb <= "
                         f"nq={nq}")
    rows = np.empty((nq, mb), np.int32)
    for i in range(nq):
        others = rng.choice(nq - 1, mb - 1, replace=False)
        others += others >= i          # skip the diagonal
        rows[i, 0] = i
        rows[i, 1:] = others
    rows.sort(axis=1)
    return rows


def graph_batch(cfg, S: int, *, mb: int = 16, bq: int = 128,
                seed: int = 0) -> dict:
    """The reference spec's node-level batch at sequence ``S``
    (``graph_batch_spec``), drawn from ``np.random.default_rng(seed)``, as
    CPU tensors: ``feat`` bf16 ``(1, S, feat_dim)``, ``in_deg`` and
    ``out_deg`` below ``max_degree``, ``labels`` in ``[0, n_classes)``,
    ``block_idx`` ``(1, S / bq, mb)`` (:func:`block_layout`) and the
    tight transposed layout ``block_idx_t`` ``(1, S / bq, mt, 2)``
    (``core/reformation.transpose_block_idx``; the dense bound ``mt =
    nq`` would be 537 MB of int32 at 1M)."""
    if S % bq:
        raise ValueError(f"S={S} is not tiled by bq={bq}")
    nq = S // bq
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((1, S, cfg.feat_dim), dtype=np.float32)
    bi = block_layout(nq, mb, rng)
    return {
        "feat": torch.from_numpy(feat).to(torch.bfloat16),
        "in_deg": torch.from_numpy(rng.integers(0, cfg.max_degree, (1, S))),
        "out_deg": torch.from_numpy(rng.integers(0, cfg.max_degree,
                                                 (1, S))),
        "labels": torch.from_numpy(rng.integers(0, cfg.n_classes, (1, S))),
        "block_idx": torch.from_numpy(bi[None]),
        "block_idx_t": torch.from_numpy(transpose_block_idx(bi, nq)[None]),
    }


def scale_config(arch: str, *, smoke: bool = False):
    """``arch``'s config (its smoke config with ``smoke``) in the scale
    run's mode: no bias table, ``remat="block"``."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.family != "graph":
        raise ValueError(f"the scale run trains a graph arch, got "
                         f"{arch!r} ({cfg.family})")
    return cfg.replace(graph_bias=None, remat="block")


def loss_and_grads(model, batch: dict, *, impl: str | None = None):
    """The sparse ``graph_loss`` and the gradient of every parameter,
    summed over the ranks of the axis context's mesh: the train step's
    own (``launch/steps.loss_and_grads``)."""
    return lsteps.loss_and_grads(model, batch, loss=graph_loss, impl=impl)


def cluster_flops(cfg, batch: dict) -> float:
    """The cluster op's FLOPs in one step (module docstring): live blocks
    x bq x bk x Dh x H x 18 a layer."""
    bi = batch["block_idx"]
    S = batch["feat"].shape[1] * _model_ranks()
    bq = S // bi.shape[-2]
    live = int((bi >= 0).sum())
    return (float(live) * bq * bq * cfg.head_dim * cfg.n_heads
            * (4 + 4 + 10) * cfg.n_layers)


def floor_bytes(cfg, batch: dict, n_params: int) -> float:
    """The step's bytes floor (module docstring)."""
    read = sum(x.numel() * x.element_size() for x in batch.values())
    S = batch["feat"].shape[1] * _model_ranks()
    hidden = 2 * (cfg.n_layers + 1) * S * cfg.d_model * 2
    return float(read + hidden + 28 * n_params)


def _model_ranks() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` gives them (None
    off the card, or where nvidia-smi cannot say)."""
    if not torch.cuda.is_available():
        return {"name": "cpu", "power_limit": None}
    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        if out:
            limit = out[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return {"name": torch.cuda.get_device_name(0), "power_limit": limit}


def run(arch: str, S: int, *, steps: int = 3, device="cuda",
        mesh_model: int = 1, smoke: bool = False,
        batch: dict | None = None) -> dict:
    """``steps`` training steps of ``arch`` at sequence ``S`` (module
    docstring) from the seeded init; returns the record. ``batch`` is
    :func:`graph_batch`'s (drawn here from seed 0 when None);
    ``mesh_model`` > 1 needs this process to be a rank of an initialised
    group of that size, and trains this rank's sequence shard."""
    if steps < 1:
        raise ValueError(f"steps={steps} (at least one)")
    dev = resolve(device)
    cfg = scale_config(arch, smoke=smoke)
    mesh = recipe = None
    if mesh_model > 1:
        if not dist.is_initialized() or dist.get_world_size() != mesh_model:
            raise ValueError(f"mesh_model={mesh_model} needs a process "
                             f"group of {mesh_model} ranks")
        mesh = lmesh.make_host_mesh(model=mesh_model, data=1)
        recipe = recipe_for(ShapeConfig(f"graph_{S}", "train", S, 1), mesh)
    if batch is None:
        batch = graph_batch(cfg, S)
    batch = {k: shard_rows(v, mesh, seq_dim=k in SEQ_KEYS).contiguous()
             .to(dev) for k, v in batch.items()}
    model = GraphModel(cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    step = lsteps.make_train_step(model, recipe, mesh, lr=LR,
                                   loss=graph_loss)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    losses, times, counted = [], [], 0.0
    for i in range(steps):
        t0 = time.perf_counter()
        if i == 0:   # count the first step's products
            with FlopCounterMode(display=False) as fc:
                out = step(batch)
            counted = float(fc.get_total_flops())
        else:
            out = step(batch)
        losses.append(float(out["loss"]))
        if on_card:
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        del out
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    counted *= _model_ranks()
    cluster = cluster_flops(cfg, batch)
    terms = roofline_terms(counted + cluster,
                           floor_bytes(cfg, batch, n_params), {})
    step_s = statistics.median(times[1:] if steps > 1 else times)
    mflops = model_flops(cfg, ShapeConfig(f"graph_{S}", "train", S, 1))
    total = torch.cuda.get_device_properties(dev).total_memory \
        if on_card else None
    return {
        "arch": arch, "seq": S, "mesh": f"1x{mesh_model}",
        "peak_gb": None if peak is None else peak / 1e9,
        "roofline": terms,
        "device": card() if on_card else {"name": dev.type,
                                          "power_limit": None},
        "fits": None if peak is None else bool(peak <= total),
        "step_ms": step_s * 1e3,
        "step_ms_all": [t * 1e3 for t in times],
        "losses": losses,
        "flops": {"counted": counted, "cluster": cluster},
        "active_params": active_params(cfg),
        "model_flops": mflops,
        "mfu": mflops / step_s / PEAK_FLOPS if on_card else None,
        "layers": cfg.n_layers, "d_head": cfg.head_dim,
        "heads": cfg.n_heads, "dtype": cfg.dtype, "remat": cfg.remat,
    }


def main(argv=None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="graphormer_large")
    ap.add_argument("--seq", type=int, default=262_144)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without it) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (a CPU rehearsal)")
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend of a mesh (gloo or "
                         "nccl; required with --mesh-model > 1)")
    ap.add_argument("--out", default=None,
                    help="append the record to this file (JSON lines)")
    args = ap.parse_args(argv)
    if args.mesh_model > 1 and not dist.is_initialized():
        if args.backend is None:
            raise ValueError("--mesh-model > 1 needs --backend")
        lmesh.spawn(main, args.mesh_model, backend=args.backend,
                    args=(argv,))
        return None
    dev = lmesh.rank_device(args.device)
    rec = run(args.arch, args.seq, steps=args.steps, device=dev,
              mesh_model=args.mesh_model, smoke=args.smoke)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return rec


if __name__ == "__main__":
    main()
