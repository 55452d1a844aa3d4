"""The per-cell fit-and-roofline sweep, the port of
``repro.launch.dryrun``: every (arch x shape) cell of ``configs.cells()``
(10 archs x 4 shapes) on the production mesh, 16 x 16 or 2 x 16 x 16
over pods, with what one rank holds, what bounds its step, and whether
it fits on the card.

The reference compiles each cell for a TPU mesh and reads its memory and
cost from the compiled artifact. The port's counterpart of compiling is
tracing: :func:`run_cell` joins a fake process group of the mesh's size
as rank 0 (``torch.testing._internal.distributed.fake_pg``: collectives
move nothing), builds the mesh, builds the cell's model, state and batch
(``launch/steps.build_cell``) under ``torch._subclasses.FakeTensorMode``
(``repro_torch.fake``: shapes without storage, nothing launched) and
runs one step under ``FlopCounterMode`` and :class:`StepTrace`, a
dispatch mode that counts each storage's bytes once from its allocation
to its release (rounded up to the CUDA caching allocator's 512 bytes on
the card's device).

``device="cuda"`` (the default) traces the card's program: fake CUDA
tensors take the kernel dispatch path, where the cluster op's launches
are custom ops whose fake implementations give their outputs. Nothing is
allocated or launched, so it traces on a machine without a card too, in
a CUDA build of torch, and the record then says ``"device": null``; a
CPU-only build of torch cannot run autograd on fake CUDA tensors, so
there the sweep takes ``device="cpu"``, which traces the plain path.

The record keeps the reference's keys where they mean the same thing:
``arch``, ``shape``, ``mesh``, ``devices``, ``note``, ``recipe``,
``compile_s`` (here the seconds to build and trace), ``memory``
(``argument_bytes``: the state and the step's arguments one rank holds
as the port's runtime holds them; ``output_bytes``: what the step
returns beside them; ``alias_bytes``: the state it updates in place;
``temp_bytes``: the trace's peak above the arguments;
``peak_est_bytes``: the trace's peak of live bytes, outputs included),
``flops_per_dev`` (``FlopCounterMode``'s products, ``flops_counted``,
plus where the step reaches the cluster op's kernels the analytic count
``launch/graph_dryrun.cluster_flops`` uses, ``flops_cluster``: live
blocks x bq x bk x Dh x H x 4 a forward launch, 6 a dQ and 4 a dK/dV
launch, the 4 + 4 + 10 a recomputed layer), ``bytes_per_dev`` (every
non-view op's operands and results: the eager program's traffic, which
holds the products' own, ``dot_io_bytes_per_dev``; the reference takes
the larger of its raw and dot-I/O counts), ``collectives`` (the payloads
``parallel/collectives.BYTES`` counted in the step, under
``roofline.COLLECTIVES``' names), ``roofline``, ``model_flops_total``,
``model_flops_per_dev``, ``useful_compute_ratio``, ``n_params`` and
``n_active_params``. It adds ``state_bytes_recipe`` (the parameter and
moment bytes a rank would hold under ``recipe.params``, what sharded
storage would buy against the whole copies the trace holds; and
``cache_bytes_recipe`` for a decode cell), ``fits`` (``peak_est_bytes``
against the card's memory: the card's own where there is one, else
:data:`CARD_MEMORY`), ``device`` (``graph_dryrun.card()`` on the
card, else null) and ``launches`` (each cluster-op launch's output
shapes and dtypes, which ``chip_smoke.py`` holds to the real step's).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_1_7b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
      [--out DIR] [--jobs N]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu

It appends each record to ``DIR/dryrun_{16x16,2x16x16}.jsonl`` (default
``experiments``), skips the cells a file already holds, prints the
``FAILURES:`` and exits 1 if any cell failed.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import math
import multiprocessing
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import fake
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, cells
from repro_torch.kernels.ops import host_layout
from repro_torch.launch.graph_dryrun import card
from repro_torch.launch.mesh import PRODUCTION_SHAPE, make_production_mesh
from repro_torch.launch.roofline import (active_params, model_flops,
                                         roofline_terms)
from repro_torch.launch.steps import (arg_tensors, build_cell,
                                      cache_bytes_recipe, expert_part,
                                      n_params, state_bytes_recipe)
from repro_torch.parallel import collectives as C

# the card's memory where there is no card to ask:
# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 at a 700 W power limit
CARD_MEMORY = 85_017_493_504
# the caching allocator's granule (CUDACachingAllocator's kMinBlockSize)
ALLOC_GRANULE = 512
# the collectives' counters under the reference's names
_COLL_NAMES = {"all_to_all": "all-to-all", "all_gather": "all-gather",
               "reduce_scatter": "reduce-scatter", "all_reduce": "all-reduce",
               "pipeline": "collective-permute"}
_DOTS = ("aten.mm.", "aten.addmm.", "aten.bmm.", "aten.baddbmm.",
         "aten.convolution.", "aten._scaled_dot_product")
# the cluster op's launches: (layout argument, buckets argument or None,
# FLOPs a live element and head dim) of each custom op
# (``kernels/cluster_attention*.py``)
_CLUSTER_OPS = {
    "repro_torch.cluster_fwd_biased.default": (3, 4, 4),
    "repro_torch.cluster_fwd_unbiased.default": (3, None, 4),
    "repro_torch.cluster_dq_biased.default": (6, 7, 6),
    "repro_torch.cluster_dq_unbiased.default": (6, None, 6),
    "repro_torch.cluster_dkv_biased.default": (6, 8, 4),
    "repro_torch.cluster_dkv_unbiased.default": (6, None, 4),
}


class StepTrace(TorchDispatchMode):
    """Counts what one step moves through the dispatcher: the live bytes
    of every storage from its allocation to its release and their peak
    (each storage once, views and in-place updates adding nothing; a
    CUDA storage rounded up to ``ALLOC_GRANULE``), the bytes every
    non-view op reads and writes and those of the products alone, the
    cluster op's analytic FLOPs, and ``[op, [[shape, dtype]]]`` of each
    cluster-op launch. :meth:`hold` counts the tensors alive before the
    step."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.op_bytes = self.dot_bytes = 0
        self.cluster_flops = 0.0
        self.launches = []
        self._refs = {}

    def _track(self, t) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()
        if t.device.type == "cuda":
            n = -(-n // ALLOC_GRANULE) * ALLOC_GRANULE
        self.live += n
        self._refs[key] = (weakref.ref(st, lambda _, k=key: self._free(k)),
                           n)

    def _free(self, key) -> None:
        ref = self._refs.pop(key, None)
        if ref is not None:
            self.live -= ref[1]

    def hold(self, tensors) -> int:
        """Count ``tensors`` as live; returns the live bytes."""
        for t in tensors:
            self._track(t)
        self.peak = max(self.peak, self.live)
        return self.live

    def bytes_of(self, tensors) -> int:
        """The tracked bytes of the storages under ``tensors``, each
        once."""
        keys = {id(t.untyped_storage()) for t in tensors}
        return sum(self._refs[k][1] for k in keys if k in self._refs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not getattr(func, "is_view", False) and outs:
            moved = sum(t.numel() * t.element_size() for t in
                        tree_leaves((args, kwargs, out))
                        if isinstance(t, torch.Tensor))
            self.op_bytes += moved
            if name.startswith(_DOTS):
                self.dot_bytes += moved
        if name in _CLUSTER_OPS:
            self._cluster(name, args)
            self.launches.append([name, [[list(t.shape), str(t.dtype)]
                                         for t in outs]])
        for t in outs:
            self._track(t)
        self.peak = max(self.peak, self.live)
        return out

    def _cluster(self, name, args) -> None:
        at, buckets, per = _CLUSTER_OPS[name]
        q, layout = args[0], args[at]
        B, S, H, Dh = q.shape
        bq = S // layout.shape[-2]
        bk = bq if buckets is None else args[buckets].shape[-1]
        live = int((host_layout(layout) >= 0).sum())
        if layout.dim() == 2:
            live *= B
        self.cluster_flops += float(per) * live * bq * bk * Dh * H


def join_fake_group(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world``
    ranks (none other exists; collectives move nothing), leaving a fake
    group of another size first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(f"this process is already a rank of a "
                               f"{dist.get_backend()!r} group; the sweep "
                               f"joins a fake one")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def leave_fake_group() -> None:
    """Leave the fake process group :func:`join_fake_group` joined."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def _mesh(multi_pod: bool, mesh_shape=None):
    """The production mesh (``launch/mesh.make_production_mesh``) over a
    fake group of its size, joined as rank 0; or ``mesh_shape``, a mesh
    of one rank, as a dict of its sizes (no group)."""
    shape, names = PRODUCTION_SHAPE[multi_pod]
    if mesh_shape is None:
        join_fake_group(math.prod(shape))
        return make_production_mesh(multi_pod=multi_pod)
    if math.prod(mesh_shape) != 1:
        raise ValueError(f"mesh_shape {tuple(mesh_shape)}: only a mesh of "
                         f"one rank stands in for the production mesh")
    return dict(zip(names, mesh_shape))


def trace_step(cell: dict) -> dict:
    """One step of a built cell under ``FlopCounterMode`` and a
    :class:`StepTrace` (a fake cell: nothing runs; a real one: the step
    runs): ``{"trace", "flops", "args", "output", "alias", "out"}``."""
    trace = StepTrace()
    held = cell["state"] + arg_tensors(cell["args"])
    args_bytes = trace.hold(held)
    with FlopCounterMode(display=False) as fc, trace:
        out = cell["fn"](*cell["args"])
    mine = {id(t.untyped_storage()) for t in held}
    new = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
           and id(t.untyped_storage()) not in mine]
    return {"trace": trace, "flops": float(fc.get_total_flops()),
            "args": args_bytes, "output": trace.bytes_of(new),
            "alias": trace.bytes_of(cell["alias"]), "out": out}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             overrides=None, ulysses=None, device="cuda", mesh_shape=None,
             global_batch: int | None = None, verbose: bool = True) -> dict:
    """The record of one cell (module docstring), traced as rank 0 of the
    production mesh (``multi_pod``: 2 x 16 x 16), or of ``mesh_shape``
    (``(1, 1)``: one rank, no group); ``overrides`` config fields,
    ``global_batch`` a cut batch. Its ``launches`` hold each cluster-op
    launch's outputs (:class:`StepTrace`)."""
    t0 = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError("tracing on fake CUDA tensors needs a CUDA build "
                           "of torch (autograd asks the device for its "
                           "streams); this one is CPU-only: pass "
                           "device='cpu'")
    shape_t = tuple(mesh_shape or PRODUCTION_SHAPE[multi_pod][0])
    mesh = _mesh(multi_pod, mesh_shape)
    n_dev = math.prod(shape_t)
    C.reset_bytes()
    with fake.mode():
        cell = build_cell(arch, shape_name, mesh, overrides=overrides,
                          ulysses=ulysses, global_batch=global_batch,
                          device=dev)
        C.reset_bytes()
        got = trace_step(cell)
        cfg, shape, recipe = cell["cfg"], cell["shape"], cell["recipe"]
        cache_recipe = None
        if shape.kind == "decode":
            cache_recipe = cache_bytes_recipe(cell["model"].cache_defs(
                shape.global_batch, shape.seq_len), recipe, mesh)
    trace = got["trace"]
    coll = {_COLL_NAMES[k]: v for k, v in C.BYTES.items()}
    flops = got["flops"] + trace.cluster_flops
    bytes_accessed = float(trace.op_bytes)
    mf = model_flops(cfg, shape)
    note = cell["note"]
    if cfg.moe_experts and expert_part(cfg, mesh) is None:
        # the dropless path: no count to read, the routes split evenly
        note = (note + " " if note else "") + "moe_routes=balanced"
    on_card = torch.cuda.is_available()
    total = torch.cuda.get_device_properties(0).total_memory if on_card \
        else CARD_MEMORY
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(map(str, shape_t)),
        "devices": n_dev,
        "note": note,
        "recipe": recipe.name,
        "compile_s": round(time.perf_counter() - t0, 1),
        "memory": {
            "argument_bytes": got["args"],
            "output_bytes": got["output"],
            "temp_bytes": trace.peak - got["args"],
            "alias_bytes": got["alias"],
            "peak_est_bytes": trace.peak,
        },
        "state_bytes_recipe": state_bytes_recipe(cfg, shape, recipe, mesh),
        "cache_bytes_recipe": cache_recipe,
        "fits": trace.peak <= total,
        "device": card() if on_card else None,
        "trace_device": dev.type,
        "flops_per_dev": flops,
        "flops_counted": got["flops"],
        "flops_cluster": trace.cluster_flops,
        "bytes_per_dev": bytes_accessed,
        "dot_io_bytes_per_dev": float(trace.dot_bytes),
        "collectives": coll,
        "roofline": roofline_terms(flops, bytes_accessed, coll),
        "model_flops_total": mf,
        "model_flops_per_dev": mf / n_dev,
        "useful_compute_ratio": (mf / n_dev / flops) if flops else 0.0,
        "n_params": n_params(cfg),
        "n_active_params": active_params(cfg),
        "launches": trace.launches,
    }
    if verbose:
        m, r = rec["memory"], rec["roofline"]
        print(f"== {arch} x {shape_name} ({rec['mesh']}) recipe="
              f"{rec['recipe']} {note}")
        print(f"  memory: args={m['argument_bytes']:.4e} temp="
              f"{m['temp_bytes']:.4e} peak={m['peak_est_bytes']:.4e} "
              f"state_recipe={rec['state_bytes_recipe']:.4e} "
              f"fits={rec['fits']}")
        print(f"  flops/dev={flops:.4e} bytes/dev={bytes_accessed:.4e} "
              f"collectives={ {k: v for k, v in coll.items() if v} }")
        print(f"  roofline: compute={r['compute_s']:.4f}s memory="
              f"{r['memory_s']:.4f}s collective={r['collective_s']:.4f}s "
              f"dominant={r['dominant']} useful_compute_ratio="
              f"{rec['useful_compute_ratio']:.3f} trace={rec['compile_s']}s",
              flush=True)
    return rec


def _run_one(job: tuple):
    """A worker's cell: ``(arch, shape, multi_pod, device)`` -> ``(record
    or None, error or None)``."""
    arch, shape, multi_pod, device = job
    try:
        return run_cell(arch, shape, multi_pod=multi_pod, device=device,
                        verbose=False), None
    # one cell's failure is the sweep's record of it: the traceback goes
    # to the worker's stderr and the cell lands in the FAILURES summary
    except Exception as e:  # noqa: BLE001  # repro-lint: disable=REP008
        traceback.print_exc()
        return None, repr(e)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card's program, fake CUDA "
                         "tensors; needs a CUDA build of torch, not a "
                         "card) or cpu (the plain path)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each")
    args = ap.parse_args(argv)

    if args.all:
        todo = [(a, s) for a, s, _ in cells()]
    else:
        archs = [args.arch] if args.arch else ASSIGNED_ARCHS
        shapes = [args.shape] if args.shape else list(SHAPES)
        todo = [(a, s) for a in archs for s in shapes]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    pool = cf.ProcessPoolExecutor(
        args.jobs, mp_context=multiprocessing.get_context("spawn")) \
        if args.jobs > 1 else None
    try:
        for multi_pod in meshes:
            tag = "2x16x16" if multi_pod else "16x16"
            path = os.path.join(args.out, f"dryrun_{tag}.jsonl")
            done = set()
            if os.path.exists(path):
                with open(path) as f:
                    done = {(r["arch"], r["shape"])
                            for r in map(json.loads, f)}
            jobs = []
            for arch, shape in todo:
                if (arch, shape) in done:
                    print(f"-- skip (cached) {arch} x {shape} ({tag})")
                else:
                    jobs.append((arch, shape, multi_pod, args.device))
            runs = pool.map(_run_one, jobs) if pool else map(_run_one, jobs)
            with open(path, "a") as f:
                for (arch, shape, *_), (rec, err) in zip(jobs, runs):
                    if err is not None:
                        failures.append((arch, shape, tag, err))
                        continue
                    r = rec["roofline"]
                    print(f"{arch} x {shape} ({tag}): peak="
                          f"{rec['memory']['peak_est_bytes']:.4e} fits="
                          f"{rec['fits']} dominant={r['dominant']} "
                          f"useful_compute_ratio="
                          f"{rec['useful_compute_ratio']:.3f} trace="
                          f"{rec['compile_s']}s", flush=True)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
    finally:
        if pool is not None:
            pool.shutdown()
        leave_fake_group()
    if failures:
        print("FAILURES:")
        for fl in failures:
            print(" ", fl)
        return 1
    print("dry-run complete.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
