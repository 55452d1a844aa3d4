"""Meshes and process groups, the port of ``repro.launch.mesh``.

The port runs one process a rank (SPMD) on ``torch.distributed``. A mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` of axes ``("data",
"model")``: ranks ``d * model + m``, the sequence sharded over "model",
the batch over "data".

* :func:`init_distributed` joins a process group: the backend is always
  the caller's choice. NCCL needs a card a rank; gloo runs on the CPU,
  and on one card several ranks can share it over gloo (the bytes go
  through the host).
* :func:`make_host_mesh` is the (data, model) mesh over the ranks of
  the initialised default group.
* :func:`spawn` starts ``world`` ranks as processes of this host, each
  with its process group joined, and :func:`from_torchrun` joins the one
  torchrun's environment describes.
* :func:`make_production_mesh` keeps the reference's production shapes
  (16 x 16, and 2 x 16 x 16 over pods); it needs that many ranks.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

PRODUCTION_SHAPE = {False: ((16, 16), ("data", "model")),
                    True: ((2, 16, 16), ("pod", "data", "model"))}


def init_distributed(backend: str, rank: int, world: int,
                     init_method: str) -> None:
    """Join the default process group as ``rank`` of ``world`` over
    ``backend`` ("gloo" or "nccl") at ``init_method`` (``tcp://host:port``
    or ``file:///path``). NCCL binds the rank to card ``rank % cards``
    and raises without CUDA."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r} not in ('gloo', 'nccl')")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs CUDA, and "
                               "torch.cuda.is_available() is False")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)


def torchrun_env() -> bool:
    """True when torchrun (or another launcher) put RANK and WORLD_SIZE
    in the environment."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def from_torchrun(backend: str) -> None:
    """Join the process group torchrun's environment describes."""
    init_distributed(backend, int(os.environ["RANK"]),
                     int(os.environ["WORLD_SIZE"]), "env://")


def rank_device(device) -> torch.device:
    """This rank's device for ``device``: "cuda" becomes card ``rank %
    cards`` (every rank on card 0 of a one-card machine), anything else
    stays as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized() \
            and torch.cuda.is_available():
        return torch.device("cuda", dist.get_rank()
                            % torch.cuda.device_count())
    return dev


def make_host_mesh(model: int = 1, data: int | None = None):
    """The (data, model) mesh over the default group's ranks; ``data``
    defaults to world // model. Raises without an initialised process
    group, or when data * model is not the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (init_distributed, spawn or torchrun)")
    world = dist.get_world_size()
    data = data or max(1, world // model)
    if data * model != world:
        raise ValueError(f"mesh (data={data}, model={model}) needs "
                         f"{data * model} ranks, the group has {world}")
    # the mesh's own device type only places DTensors, which the port
    # does not use: the groups follow the default group's backend
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (data, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh: (data 16, model 16), or (pod 2,
    data 16, model 16); needs 256 or 512 ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = PRODUCTION_SHAPE[multi_pod]
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, shape, mesh_dim_names=names)


def _entry(rank, fn, world, backend, init_method, args):
    # the host's cores shared out between its ranks
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_distributed(backend, rank, world, init_method)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *, backend: str, args: tuple = (),
          init_method: str | None = None) -> None:
    """Run ``fn(*args)`` in ``world`` new processes of this host, each a
    rank of a new process group over ``backend`` (a ``file://``
    rendezvous in a fresh temporary directory unless ``init_method`` is
    given). ``fn`` must be importable by name (the processes are
    spawned, not forked). Raises when any rank fails."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        method = init_method or f"file://{os.path.join(tmp, 'rdzv')}"
        mp.spawn(_entry, args=(fn, world, backend, method, args),
                 nprocs=world, join=True)
