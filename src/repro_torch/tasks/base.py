"""The Task protocol: one contract between workloads and the Trainer —
the port of ``repro.tasks.base.Task``.

* ``prepare(model) -> self``   bind the model
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
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.dual_attention import use_dense_step


class Task:
    """Protocol base with shared defaults. The default schedule
    interleaves the ``"dense"`` variant (when the model has one) every
    ``period`` steps, forcing it when the C1-C3 condition check failed
    (paper §III-B)."""

    name: str = "task"
    model: Any = None

    def prepare(self, model) -> "Task":
        cfg = getattr(self, "cfg", None)
        mcfg = getattr(model, "cfg", None)
        if cfg is not None and mcfg is not None and mcfg != cfg:
            raise ValueError(
                f"task prepared for config {cfg.name!r} but the model was "
                f"built from {mcfg.name!r}")
        self.model = model
        return self

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
    as they are."""

    name = "stream"

    def __init__(self, batch_fn: Callable[[int], dict]):
        self.batch_fn = batch_fn

    def batches(self, step: int) -> dict:
        out = {}
        for key, arr in self.batch_fn(step).items():
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
