"""The Task protocol: one contract between workloads and the Trainer —
the port of ``repro.tasks.base.Task``.

* ``prepare(model, mesh=None, recipe=None) -> self``  bind the model,
                               and the mesh its batches are sharded on
* ``batches(step) -> dict``    the device batch for an absolute step
* ``loss_variants``            ``{"sparse": fn, ...}`` from the model; each
                               ``fn(model, batch) -> (loss, metrics)``
* ``variant(step, period)``    which variant this step runs (the
                               dual-interleave schedule)
* ``on_epoch(loss, s, step)``  epoch-boundary signal (AutoTuner feeding)
* ``eval(model) -> metrics``   held-out evaluation
* ``state_dict`` / ``load_state_dict``  durable task state
* ``log_extras() -> dict``     per-step scalars for the history record

``BatchFnTask`` wraps a seekable ``step -> numpy batch`` stream (the LM
families).

On a mesh (one process a rank) ``batches`` returns this rank's shard:
the sequence dim of the per-token arrays split over "model" (S/P
contiguous tokens), the batch dim of every array over "data" where it
divides (the per-graph layouts of packed mini-graphs follow their
graphs); a task runs its own model calls (``eval``) inside
:meth:`Task.context`. A graph task whose sequence does not split over
"model" keeps it whole on every rank (``parallel.sharding.fit_sequence``,
the reference's ``fit_spec`` rule): ``seq_sharded`` is then False.
Every task of the port is ``shardable``; one that is not refuses a
mesh.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.dual_attention import use_dense_step
from repro_torch.parallel import axes as pax
from repro_torch.parallel.ulysses import _fit_dp


def shard_rows(x, mesh, seq_dim: bool = True):
    """This rank's shard of a per-token array ``x`` (B, S, ...), numpy or
    torch, on ``mesh`` (None: ``x`` itself), a view: dim 1 split into
    ``model`` contiguous pieces (``seq_dim``), dim 0 into ``data`` pieces
    where it divides."""
    if mesh is None:
        return x
    shape = pax.mesh_shape(mesh)
    if _fit_dp(("data",), shape, x.shape[0]):
        n = x.shape[0] // shape["data"]
        i = mesh.get_local_rank("data")
        x = x[i * n:(i + 1) * n]
    if seq_dim and shape.get("model", 1) > 1:
        p = shape["model"]
        if x.shape[1] % p:
            raise ValueError(f"sequence of {x.shape[1]} tokens does not "
                             f"split {p} ways")
        n = x.shape[1] // p
        i = mesh.get_local_rank("model")
        x = x[:, i * n:(i + 1) * n]
    return x


class Task:
    """Protocol base with shared defaults. The default schedule
    interleaves the ``"dense"`` variant (when the model has one) every
    ``period`` steps, forcing it when the C1-C3 condition check failed
    (paper §III-B)."""

    name: str = "task"
    model: Any = None
    mesh: Any = None
    recipe: Any = None
    shardable: bool = False

    def prepare(self, model, mesh=None, recipe=None) -> "Task":
        cfg = getattr(self, "cfg", None)
        mcfg = getattr(model, "cfg", None)
        if cfg is not None and mcfg is not None and mcfg != cfg:
            raise ValueError(
                f"task prepared for config {cfg.name!r} but the model was "
                f"built from {mcfg.name!r}")
        if mesh is not None and not self.shardable:
            raise ValueError(f"the {self.name} task has no mesh form")
        self.model = model
        self.mesh, self.recipe = mesh, recipe
        return self

    @property
    def seq_sharded(self) -> bool:
        """Whether this rank's batch holds a shard of the sequence: a mesh
        whose recipe maps "seq_outer" onto a "model" axis of more than
        one rank."""
        return self.mesh is not None and \
            self.recipe.acts.get("seq_outer") == "model" and \
            pax.mesh_shape(self.mesh).get("model", 1) > 1

    def context(self):
        """The mesh's axis rules (``parallel.axes.axis_rules``) for a model
        call on this task's sharded batches; nothing without a mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return pax.axis_rules(self.recipe, self.mesh)

    def batches(self, step: int) -> dict:
        raise NotImplementedError

    @property
    def loss_variants(self) -> dict[str, Callable]:
        return dict(self.model.loss_variants)

    @property
    def conditions_ok(self) -> bool:
        return True

    def variant(self, step: int, interleave_period: int) -> str:
        if "dense" in self.loss_variants and use_dense_step(
                step, interleave_period, self.conditions_ok):
            return "dense"
        return "sparse"

    def on_epoch(self, loss: float, epoch_seconds: float,
                 step: int) -> bool:
        """Epoch-boundary feed; returns True iff the task re-laid out."""
        return False

    def log_extras(self) -> dict:
        return {}

    def eval(self, model) -> dict:
        return {}

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict) -> None:
        pass


class BatchFnTask(Task):
    """The trivial task: a seekable ``step -> host batch`` stream (numpy
    arrays, e.g. ``data/lm_pipeline.lm_batch``) and the model's primary
    ("sparse") loss, as the reference's ``BatchFnTask``. Integer arrays
    reach the model's device as int64 (token ids, labels), float arrays
    as they are.

    On a mesh each array is cut as the reference's ``batch_shardings``
    cuts it: ``patches`` and ``frames`` by batch over "data" only, whole
    over "model"; every other array of two or more dims by batch over
    "data" and by sequence over "model". The VLM's sequence is its Tp
    patches and then its T tokens, so with ``patches`` in the batch and
    a sharded sequence, ``tokens`` and ``labels`` are first put at their
    positions in that sequence (Tp leading placeholders: token 0, label
    -1) and then cut: a rank holds the tokens and labels of its S/P
    positions of the Tp + T, and one whose positions are all patches
    holds placeholders only."""

    name = "stream"
    shardable = True

    def __init__(self, batch_fn: Callable[[int], dict]):
        self.batch_fn = batch_fn

    def batches(self, step: int) -> dict:
        host = self.batch_fn(step)
        tp = host["patches"].shape[1] \
            if "patches" in host and self.seq_sharded else 0
        out = {}
        for key, arr in host.items():
            if tp and key in ("tokens", "labels"):
                fill = np.full((arr.shape[0], tp), 0 if key == "tokens"
                               else -1, arr.dtype)
                arr = np.concatenate([fill, arr], 1)
            arr = shard_rows(arr, self.mesh, seq_dim=arr.ndim >= 2 and key
                             not in ("patches", "frames"))
            x = torch.from_numpy(np.ascontiguousarray(arr))
            if not x.is_floating_point():
                x = x.long()
            out[key] = x.to(self.model.device)
        return out

    @property
    def loss_variants(self) -> dict[str, Callable]:
        # streams train the primary variant only: the interleave schedule
        # belongs to tasks that own a layout to interleave against
        return {"sparse": self.model.loss_variants["sparse"]}
