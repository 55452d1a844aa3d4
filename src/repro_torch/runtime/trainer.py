"""Training loop, generic over the Task protocol — the port of the
single-device core of ``repro.runtime.trainer``.

* each of the task's ``loss_variants`` is a step of its own (node tasks
  have two: ``sparse`` and ``dense``);
* ``task.variant(step, interleave_period)`` is the dual-interleave
  schedule (paper §III-B), keyed off the absolute step;
* every ``elastic_every`` steps the epoch's (mean loss, wall time) feed
  ``task.on_epoch`` (paper §III-D: the AutoTuner ladder and
  re-reformation). The first two steps of a run are left out of the
  feed, as in the reference, so start-up cost (kernel builds, first
  uploads) does not poison the loss-descent rate;
* a non-finite guard: a step whose loss or any gradient is not finite
  leaves the parameters and moments as they were and counts in
  ``bad_steps``.

Every step appends a ``history`` record: ``step``, ``loss``, ``xent``,
``acc``, ``bad_steps``, ``skipped``, ``seconds``, ``variant``, ``dense``
and the task's extras (``beta_thre`` for elastic tasks).

Not ported yet, each waiting for the slice that brings its package
(``ROADMAP.md``): checkpoints and restart, rollback after a bad streak,
fault injection, the IR audit, kernel retuning, the straggler policy,
meshes and the reference's reduced-precision optimizer moments.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.optim.adamw import AdamW, warmup_cosine


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 10
    weight_decay: float = 0.1
    interleave_period: int = 0   # dense step every k steps (0 = never)
    elastic_every: int = 0       # steps per task epoch (0 = frozen layout)


class Trainer:
    """Trains ``model`` (its parameters in place) on ``task``."""

    def __init__(self, model, cfg: TrainerConfig, *, task):
        self.model = model
        self.cfg = cfg
        self.task = task.prepare(model)
        self.params = list(model.parameters())
        self.opt = AdamW(self.params,
                         lr=warmup_cosine(cfg.lr, cfg.warmup, cfg.steps),
                         weight_decay=cfg.weight_decay)
        self.history: list[dict] = []
        self.bad = 0     # consecutive non-finite steps

    def step(self, variant: str, batch: dict) -> dict:
        """One training step of ``variant`` on ``batch``; returns the
        step's metrics as floats."""
        loss, metrics = self.task.loss_variants[variant](self.model, batch)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        # a parameter the variant does not reach gets a zero gradient, as
        # under jax.grad (weight decay still applies to it)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, self.params)]
        ok = torch.isfinite(loss.detach())
        for g in grads:
            ok = ok & torch.isfinite(g).all()
        ok = bool(ok)
        if ok:
            self.opt.update(grads)
            self.bad = 0
        else:
            self.bad += 1
        return {"loss": float(loss.detach()), "bad_steps": self.bad,
                "skipped": int(not ok),
                **{k: float(v.detach()) for k, v in metrics.items()}}

    def run(self) -> str:
        cfg = self.cfg
        task = self.task
        epoch_losses: list[float] = []
        epoch_seconds = 0.0
        for step in range(cfg.steps):
            t0 = time.perf_counter()
            variant = task.variant(step, cfg.interleave_period)
            metrics = self.step(variant, task.batches(step))
            dt = time.perf_counter() - t0   # float() above synchronised
            self.history.append({"step": step + 1, **metrics,
                                 "seconds": dt, "variant": variant,
                                 "dense": variant == "dense",
                                 **task.log_extras()})
            if cfg.elastic_every > 0:
                if step >= 2 and np.isfinite(metrics["loss"]):
                    epoch_losses.append(metrics["loss"])
                    epoch_seconds += dt
                if (step + 1) % cfg.elastic_every == 0:
                    if epoch_losses:
                        task.on_epoch(float(np.mean(epoch_losses)),
                                      epoch_seconds, step=step + 1)
                    epoch_losses, epoch_seconds = [], 0.0
        return "done"
