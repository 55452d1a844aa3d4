"""Fault-tolerant training loop, generic over the Task protocol — the
port of ``repro.runtime.trainer`` on one device.

* each of the task's ``loss_variants`` is a step of its own (node tasks
  have two: ``sparse`` and ``dense``);
* ``task.variant(step, interleave_period)`` is the dual-interleave
  schedule (paper §III-B), keyed off the absolute step, so the cadence
  survives a restart;
* every ``elastic_every`` steps the epoch's (mean loss, wall time) feed
  ``task.on_epoch`` (paper §III-D: the AutoTuner ladder and
  re-reformation). The first two steps of a run are left out of the
  feed, as in the reference, so start-up cost (kernel builds, first
  uploads) does not poison the loss-descent rate;
* a non-finite guard: a step whose loss or any gradient is not finite
  leaves the parameters and moments as they were and counts in
  ``bad_steps``;
* checkpoints (``ckpt_dir``): the reference's state tree
  ``{"params", "opt": {"m", "v", "step"}, "step", "bad"}`` with the
  reference's parameter layout (``convert.params_to_jax``), so either
  package resumes the other's run; the moments in ``state_dtype``
  (``float32 | bfloat16 | int8``, the reference's ``AdamW``), bf16 leaves
  as bf16 and an int8 moment as ``{"q", "s"}`` per reference leaf
  (``convert.leaf_groups``); the task's state rides the manifest
  under ``"task"``. Async saves every ``ckpt_every`` steps, a blocking
  one at the end and on SIGTERM (status ``"preempted"``), a crash save on
  any uncaught failure, and a restart resumes at the newest verified
  generation — tasks are seekable, so it replays nothing and skips
  nothing;
* the recovery ladder: after ``max_bad_steps`` consecutive bad steps the
  loop rolls back to the newest verified checkpoint saved outside the
  streak and replays (re-init when none qualifies), at most
  ``max_rollbacks`` times;
* the seeded ``FaultPlan`` (``fault_plan`` / ``REPRO_FAULTS``) and
  ``fail_at_step`` drive every recovery path; a straggler EMA flags slow
  steps; ``retune_every`` reloads the kernel winner table.

The port updates parameters in place and has no buffer donation, so its
worst crash instant is inside ``AdamW.update`` (the ``preempt`` hook
point), with some parameters written and some not. The state counts as
torn from the first in-place write until the step counter has advanced;
the crash save never writes torn state: it saves the last rescue copy
(``rescue_every``) instead, or nothing, and the restart resumes from the
last periodic checkpoint.

Every step appends a ``history`` record: ``step``, ``loss``, ``xent``,
``acc``, ``bad_steps``, ``skipped``, ``seconds``, ``variant``, ``dense``
and the task's extras (``beta_thre`` for elastic tasks).

On a mesh (``mesh=`` from ``launch/mesh.make_host_mesh`` and ``recipe=``
from ``parallel/sharding.recipe_for``; one process a rank, every rank
running this loop) the task hands each rank its shard of the batch and
every variant's loss runs under ``parallel.axes.axis_rules``, which
shards the sequence over "model" (``core/graph_model.py``,
``models/lm.py``). Parameters are replicated (``recipe.params`` is kept
as data, as the reference's Trainer keeps it: its parameters and
moments are initialised without a sharding), apart from the MoE's
expert stacks of a model built with ``experts=(m, P)``, which hold
rank m's experts only.
A variant's loss is the mean over every rank's tokens (its numerator
and count summed over the mesh; a batch the data axis cannot split is
counted once a data group, which leaves the mean as it is), and each
rank backpropagates its own share of it, so one all-reduce that sums
the gradients over every rank gives the gradient of the global mean:
summed over the model group, averaged over the data groups. The expert
stacks' gradients are summed over the data group only (the model group
holds other experts). Its checkpoints hold the whole stacks: every rank
joins an all-gather of the stacks and of their moments over the model
group and rank 0 writes the tree a P = 1 run of the same parameters
would write (an int8 moment's blocks put back in the whole leaf's
order; a part must fill whole 256-blocks, which is checked), so either
package, and a run on any mesh, resumes from it; a restore takes each
rank's E/P rows (blocks) of them. A crash save of such a model writes
its rescue copy only (the gather needs every rank). The non-finite
guard's flag and a SIGTERM are
all-reduced, so every rank skips or stops together; rank 0 writes every
checkpoint, every rank restores (a rollback waits for rank 0's writes
first). The checkpoints hold whole tensors, so a run resumes on another
mesh, or on none. There is no gradient clipping to reduce, in the port
or in the reference.

Not ported: the IR audit (JAX-specific).
"""

from __future__ import annotations

import dataclasses
import signal
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt.checkpoint import (CheckpointCorrupt, Checkpointer,
                                         snapshot)
from repro_torch.convert import (insert, leaf_groups, lookup,
                                 params_from_jax, params_to_jax)
from repro_torch.optim.adamw import Q_BLOCK, AdamW, warmup_cosine
from repro_torch.parallel import axes as pax
from repro_torch.parallel import collectives as C
from repro_torch.resilience.faults import FaultPlan, Preempted

KEEP = 3                 # checkpoint generations kept on disk
STRAGGLER_FACTOR = 3.0   # a step this many times the EMA is a straggler
REDUCE_BUCKET = 1 << 26  # elements of one gradient all-reduce (256 MiB)


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    # None = no checkpoints and no restore, so a caller that names no
    # directory runs as it did before checkpoints existed. The reference
    # defaults to one shared directory (/tmp/repro_ckpt); here that would
    # make concurrent runs (tests under xdist, the chip phases) resume one
    # another's state.
    ckpt_dir: str | None = None
    lr: float = 3e-4
    warmup: int = 10
    weight_decay: float = 0.1
    # AdamW's moments: float32 | bfloat16 | int8 (blockwise, per
    # reference leaf)
    state_dtype: str = "float32"
    fail_at_step: int = -1          # failure injection (tests)
    interleave_period: int = 0   # dense step every k steps (0 = never)
    elastic_every: int = 0       # steps per task epoch (0 = frozen layout)
    # kernel autotuning (repro_torch.tune): reload the winner table from
    # disk every k steps (0 = never); "" = the table's default path
    retune_every: int = 0
    tune_table: str = ""
    # crash rescue: a host copy of params, moments, counters and the
    # task's state every k steps (0 = off), which the crash save writes
    # when the crash tore the live state. Each refresh copies the whole
    # state to the host synchronously (chip_smoke.py times it at
    # Graphormer-Large's size); without it a crash inside the update
    # resumes from the last periodic checkpoint
    rescue_every: int = 0
    # deterministic fault injection (repro_torch.resilience.faults): a
    # seeded FaultPlan spec like "nonfinite@5,preempt@7,ckpt_corrupt@10,
    # seed=3"; REPRO_FAULTS wins when set. Empty = no faults
    fault_plan: str = ""
    # after this many CONSECUTIVE non-finite steps (each already skipped
    # by the guard) roll back to the newest verified checkpoint outside
    # the streak and replay; 0 = skip only
    max_bad_steps: int = 3
    # a fault that survives this many rollbacks is not transient: raise
    max_rollbacks: int = 3


def host_copy(tensors) -> list[torch.Tensor]:
    """A synchronous host copy of each tensor (never an alias, also of a
    CPU tensor)."""
    return [t.detach().to("cpu", copy=True) for t in tensors]


@dataclasses.dataclass
class StragglerReport:
    step: int
    seconds: float
    ema: float


@dataclasses.dataclass
class RollbackReport:
    at_step: int   # loop step the escalation fired at
    to_step: int   # verified checkpoint step replay resumed from


class Trainer:
    """Trains ``model`` (its parameters in place) on ``task``, on one
    device or, with ``mesh`` and ``recipe``, as this process's rank of
    the mesh."""

    def __init__(self, model, cfg: TrainerConfig, *, task, mesh=None,
                 recipe=None):
        if mesh is not None and recipe is None:
            raise ValueError("a mesh needs a recipe (parallel.sharding."
                             "recipe_for)")
        self.model = model
        self.cfg = cfg
        self.mesh, self.recipe = mesh, recipe
        # rank 0 writes checkpoints; every rank of a mesh restores
        self.writer = mesh is None or dist.get_rank() == 0
        self.task = task.prepare(model, mesh, recipe)
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        # the expert stacks holding one rank's experts: reduced over the
        # data group alone, gathered over the model group for a checkpoint
        self._parted = [hasattr(p, "expert_part") for p in self.params]
        if any(self._parted) and mesh is None:
            raise ValueError(
                "a model holding part of its experts trains on the mesh "
                "whose model axis it was built for")
        # the reference's parameter leaves: the unit of an int8 moment
        self.leaves = leaf_groups(self.names)
        if cfg.state_dtype == "int8":
            for leaf, idx in self.leaves:
                if self._parted[idx[0]] and \
                        self.params[idx[0]].numel() % Q_BLOCK:
                    raise ValueError(
                        f"{leaf}: an expert part of "
                        f"{self.params[idx[0]].numel()} elements is no "
                        f"whole number of {Q_BLOCK}-blocks, so its int8 "
                        f"moments cannot take the blocks of the whole leaf")
        self.opt = AdamW(self.params,
                         lr=warmup_cosine(cfg.lr, cfg.warmup, cfg.steps),
                         weight_decay=cfg.weight_decay,
                         state_dtype=cfg.state_dtype,
                         groups=[idx for _, idx in self.leaves])
        # the re-init rung of the ladder: a host copy of the parameters
        # as they stand at the first restore_or_init() (run() calls it),
        # taken when a re-init is reachable; Trainers driven only through
        # step() never pay for it
        self._init_params: list[torch.Tensor] | None = None
        self.ckpt = (Checkpointer(cfg.ckpt_dir, keep=KEEP)
                     if cfg.ckpt_dir else None)
        self.faults = FaultPlan.resolve(cfg.fault_plan)
        self.history: list[dict] = []
        self.stragglers: list[StragglerReport] = []
        self.rollbacks: list[RollbackReport] = []
        self.fault_log: list[dict] = []
        self.bad = 0          # consecutive non-finite steps
        self.steps_done = 0   # the state's step counter
        self._torn = False
        self._rescue: tuple[int, dict, dict | None] | None = None
        self._preempted = False

    # ------------------------------------------------------------ step

    def step(self, variant: str, batch: dict, *, poison: bool = False,
             midway=None) -> dict:
        """One training step of ``variant`` on ``batch``; returns the
        step's metrics as floats. ``poison`` is the ``nonfinite`` fault
        hook (the loss times NaN); ``midway`` the ``preempt`` one, called
        halfway through the update (or, on a skipped step, in its
        place)."""
        with self.task.context():
            loss, metrics = self.task.loss_variants[variant](self.model,
                                                             batch)
            if poison:
                loss = loss * float("nan")
            grads = torch.autograd.grad(loss, self.params,
                                        allow_unused=True)
        # a parameter the variant does not reach gets a zero gradient, as
        # under jax.grad (weight decay still applies to it)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, self.params)]
        if self.mesh is not None:
            grads = self._reduce(grads)
        ok = torch.isfinite(loss.detach())
        for g in grads:
            ok = ok & torch.isfinite(g).all()
        if self.mesh is not None:   # every rank skips together
            flag = ok.to(C.control_device(), torch.float32).reshape(1)
            ok = C.all_reduce_(flag, None, op=dist.ReduceOp.MIN)[0] > 0
        ok = bool(ok)
        if ok:
            self._torn = True
            self.opt.update(grads, midway=midway)
            self.bad = 0
        else:
            if midway is not None:
                midway()
            self.bad += 1
        self.steps_done += 1
        self._torn = False
        return {"loss": float(loss.detach()), "bad_steps": self.bad,
                "skipped": int(not ok),
                **{k: float(v.detach()) for k, v in metrics.items()}}

    def _reduce(self, grads: list) -> list:
        """The gradients summed over every rank of the mesh
        (:func:`reduce_gradients`)."""
        return reduce_gradients(grads, self.mesh, self._parted)

    def _barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier()

    def _any_rank(self, flag: bool) -> bool:
        """``flag`` of any rank (every rank's own without a mesh)."""
        if self.mesh is None:
            return flag
        t = torch.tensor([float(flag)], device=C.control_device())
        return bool(C.all_reduce_(t, None, op=dist.ReduceOp.MAX)[0] > 0)

    # ------------------------------------------------------------ state

    def _moments_tree(self, moments: list) -> dict:
        """One moment (``m`` or ``v``) in the reference's layout: stacked
        per-parameter tensors, or an int8 ``{"q", "s"}`` per leaf."""
        if self.opt.state_dtype != "int8":
            return params_to_jax(dict(zip(self.names, moments)))
        tree: dict = {}
        for (leaf, _), qs in zip(self.leaves, moments):
            insert(tree, leaf, dict(qs))
        return tree

    def _moments_from(self, tree: dict) -> list:
        """The inverse of :meth:`_moments_tree`, in the checkpoint's dtypes
        (``AdamW.load_state_dict`` checks them)."""
        if self.opt.state_dtype != "int8":
            got = params_from_jax(tree, dtype=None)
            if sorted(got) != sorted(self.names):
                raise ValueError(
                    f"checkpoint moment names "
                    f"{sorted(set(got) ^ set(self.names))} differ from the "
                    f"model's")
            return [got[n] for n in self.names]
        out = []
        for leaf, _ in self.leaves:
            qs = lookup(tree, leaf)
            if not isinstance(qs, dict) or sorted(qs) != ["q", "s"]:
                raise ValueError(f"checkpoint moment {leaf!r} is no int8 "
                                 f"{{'q', 's'}} pair")
            out.append({k: params_from_jax({k: qs[k]}, dtype=None)[k]
                        for k in ("q", "s")})
        return out

    def _whole(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Parameter ``i``'s tensor ``t`` (the parameter or a moment of it)
        whole: gathered over the model group where it is an expert part."""
        if not self._parted[i]:
            return t
        return C.gather_rows(t, self.mesh.get_group("model"))

    def _part(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`_whole`: this rank's rows of ``t``."""
        if not self._parted[i]:
            return t
        m, parts = self.params[i].expert_part
        n = t.shape[0] // parts
        return t[m * n:(m + 1) * n]

    def _whole_blocks(self, k: int, qs: dict) -> dict:
        """Leaf ``k``'s int8 moment whole: where its layers hold expert
        parts, every rank's blocks gathered and put in the whole leaf's
        order (each layer's parts in rank order)."""
        idx = self.leaves[k][1]
        if not self._parted[idx[0]]:
            return qs
        group = self.mesh.get_group("model")
        out = {}
        for key, t in qs.items():
            got = C.gather_rows(t, group)               # (P L nb, ...)
            parts = C.size(group)
            out[key] = got.view(parts, len(idx), -1, t.shape[-1]).transpose(
                0, 1).reshape(-1, t.shape[-1])
        return out

    def _part_blocks(self, k: int, qs: dict) -> dict:
        """The inverse of :meth:`_whole_blocks`: this rank's blocks of a
        whole leaf's int8 moment."""
        idx = self.leaves[k][1]
        if not self._parted[idx[0]]:
            return qs
        m, parts = self.params[idx[0]].expert_part
        return {key: t.reshape(len(idx), parts, -1, t.shape[-1])[:, m]
                .reshape(-1, t.shape[-1]) for key, t in qs.items()}

    def state_tree(self) -> dict:
        """The reference's state tree over the live tensors (parameters
        and moments in the reference's layout, counters as 0-d int32).
        With expert parts, whole: a collective that every rank of the
        mesh must join."""
        opt = self.opt.state_dict()
        whole = lambda ts: [self._whole(i, t)  # noqa: E731
                            for i, t in enumerate(ts)]
        if self.opt.state_dtype == "int8":
            m, v = ([self._whole_blocks(k, qs) for k, qs in enumerate(x)]
                    for x in (opt["m"], opt["v"]))
        else:
            m, v = whole(opt["m"]), whole(opt["v"])
        return {"params": params_to_jax(dict(zip(self.names,
                                                 whole(self.params)))),
                "opt": {"m": self._moments_tree(m),
                        "v": self._moments_tree(v),
                        "step": np.asarray(opt["step"], np.int32)},
                "step": np.asarray(self.steps_done, np.int32),
                "bad": np.asarray(self.bad, np.int32)}

    @torch.no_grad()
    def load_state_tree(self, tree: dict) -> None:
        """Copy a restored state tree (numpy or host torch leaves, either
        package's) into the live parameters, moments and counters. The
        names, shapes and moment dtypes must be this trainer's."""
        got = params_from_jax(tree["params"])
        if sorted(got) != sorted(self.names):
            raise ValueError(
                f"checkpoint names {sorted(set(got) ^ set(self.names))} "
                f"differ from the model's")
        params = [self._part(i, got[n]) for i, n in enumerate(self.names)]
        m, v = (self._moments_from(tree["opt"][k]) for k in ("m", "v"))
        if self.opt.state_dtype == "int8":
            m, v = ([self._part_blocks(k, qs) for k, qs in enumerate(x)]
                    for x in (m, v))
        else:
            m, v = ([self._part(i, t) for i, t in enumerate(x)]
                    for x in (m, v))
        # every shape before any copy: a mismatch leaves the state whole
        srcs = [params] if self.opt.state_dtype == "int8" else [params, m, v]
        for name, p, *got in zip(self.names, self.params, *srcs):
            for src in got:
                if p.shape != src.shape:
                    raise ValueError(f"checkpoint {name} has shape "
                                     f"{tuple(src.shape)}, the model "
                                     f"{tuple(p.shape)}")
        # checks every moment before it copies any
        self.opt.load_state_dict({"m": m, "v": v,
                                  "step": int(tree["opt"]["step"])})
        for p, src in zip(self.params, params):
            p.copy_(src)
        self.steps_done = int(tree["step"])
        # checkpoints predating the non-finite guard carry no counter
        self.bad = int(tree.get("bad", 0))

    def _reinit(self) -> None:
        """The ladder's last rung: the parameters as they stood at the
        first restore, zero moments, step 0."""
        with torch.no_grad():
            for p, p0 in zip(self.params, self._init_params):
                p.copy_(p0)
        self.opt.zero_()
        self.opt.step = 0
        self.steps_done = 0
        self.bad = 0

    def _adopt(self, tree: dict, step: int) -> None:
        """Load a restored tree and the task's state from its manifest."""
        self.load_state_tree(tree)
        extra = self.ckpt.load_extra(step)
        if extra:
            # "elastic" is the reference's pre-Task manifest key
            sd = extra.get("task") or extra.get("elastic")
            if sd:
                self.task.load_state_dict(sd)

    def restore_or_init(self) -> int:
        """The step to start from: the newest generation that passes
        checksum verification (a corrupt or uncommitted latest falls back,
        with a RuntimeWarning, to an older retained one), else re-init at
        0. Without ``ckpt_dir``: 0, from the state as it stands."""
        # re-init (here, or in a rollback with no generation to go to)
        # goes back to the parameters as they stand at the first call
        if self._init_params is None and (self.ckpt is not None
                                          or self.cfg.max_bad_steps > 0):
            self._init_params = host_copy(self.params)
        if self.ckpt is None:
            self.steps_done = 0
            return 0
        got = self.ckpt.restore_latest_verified(device="cpu")
        if got is None:
            self._reinit()
            return 0
        tree, step = got
        self._adopt(tree, step)
        return step

    def _save(self, step: int, *, blocking: bool = False) -> None:
        """Rank 0 writes a checkpoint of the live state at ``step`` (every
        rank calls this: with expert parts the state is gathered
        first)."""
        if self.ckpt is None:
            return
        if self.writer:
            self.ckpt.save(step, self.state_tree(), blocking=blocking,
                           extra=self._ckpt_extra())
        elif any(self._parted):
            self.state_tree()        # this rank's part of the gather

    def _ckpt_extra(self) -> dict | None:
        sd = self.task.state_dict()
        return {"task": sd} if sd else None

    def rescue_copy(self) -> None:
        """Refresh the host rescue copy of the whole state (and the task's
        state) at the current step."""
        self._rescue = (self.steps_done, snapshot(self.state_tree()),
                        self._ckpt_extra())

    # ------------------------------------------------------------ loop

    def run(self) -> str:
        """Train to ``cfg.steps``; returns ``"done"`` or ``"preempted"``
        (SIGTERM). Restores first when ``ckpt_dir`` holds a checkpoint."""
        cfg = self.cfg
        task = self.task
        start = self.restore_or_init()
        old = signal.getsignal(signal.SIGTERM)

        def on_term(sig, frame):
            self._preempted = True

        try:
            signal.signal(signal.SIGTERM, on_term)
        except ValueError:
            pass  # not the main thread: no handler, as in the reference

        ema = None
        epoch_losses: list[float] = []
        epoch_seconds = 0.0
        try:
            step = start
            while step < cfg.steps:
                if step == cfg.fail_at_step:
                    raise RuntimeError(f"injected failure at step {step}")
                t0 = time.perf_counter()
                variant = task.variant(step, cfg.interleave_period)
                batch = task.batches(step)
                nf = self.faults.take("nonfinite", step)
                pre = self.faults.take("preempt", step)
                metrics = self.step(variant, batch, poison=nf is not None,
                                    midway=self._preempt_hook(step)
                                    if pre is not None else None)
                if nf is not None:
                    self.fault_log.append({"kind": "nonfinite",
                                           "step": step})
                dt = time.perf_counter() - t0   # float() above synchronised
                if step - start >= 2:  # skip start-up-dominated steps
                    prev_ema = ema
                    ema = dt if ema is None else 0.9 * ema + 0.1 * dt
                    if prev_ema is not None and \
                            dt > STRAGGLER_FACTOR * prev_ema:
                        self.stragglers.append(
                            StragglerReport(step, dt, prev_ema))
                self.history.append({"step": step + 1, **metrics,
                                     "seconds": dt, "variant": variant,
                                     "dense": variant == "dense",
                                     **task.log_extras()})
                if cfg.elastic_every > 0:
                    # non-finite (skipped) steps would poison the mean
                    if step - start >= 2 and np.isfinite(metrics["loss"]):
                        epoch_losses.append(metrics["loss"])
                        epoch_seconds += dt
                    if (step + 1) % cfg.elastic_every == 0:
                        if epoch_losses:
                            task.on_epoch(float(np.mean(epoch_losses)),
                                          epoch_seconds, step=step + 1)
                        epoch_losses, epoch_seconds = [], 0.0
                if cfg.retune_every > 0 and \
                        (step + 1) % cfg.retune_every == 0:
                    # warn-and-fall-back on a load problem (tune.runtime)
                    from repro_torch.tune import runtime as tune_runtime
                    tune_runtime.refresh(cfg.tune_table or None)
                # after the epoch feed, so the copy holds what a
                # checkpoint of this step would
                if cfg.rescue_every > 0 and \
                        (step + 1) % cfg.rescue_every == 0:
                    self.rescue_copy()
                # the final blocking save below covers step == cfg.steps
                if self.ckpt is not None and \
                        (step + 1) % cfg.ckpt_every == 0 and \
                        step + 1 != cfg.steps:
                    self._save(step + 1)
                    if self.writer:
                        self._maybe_corrupt(step + 1)
                if self._any_rank(self._preempted):
                    self._save(step + 1, blocking=True)
                    self._barrier()
                    return "preempted"
                # escalation: the guard already skipped each bad update;
                # a persistent streak means the state itself may be
                # poisoned — roll back to a verified checkpoint outside it
                if cfg.max_bad_steps > 0 and \
                        metrics["bad_steps"] >= cfg.max_bad_steps:
                    step = self._rollback(step + 1)
                    ema = None
                    epoch_losses, epoch_seconds = [], 0.0
                    continue
                step += 1
            if self.ckpt is not None:
                self._save(cfg.steps, blocking=True)
                if self.writer:
                    self._maybe_corrupt(cfg.steps)
            self._barrier()
            return "done"
        except Exception as err:
            # crash-consistent save so a restart resumes, then re-raise;
            # a failing save is attached to the crash, never in its place
            try:
                self._crash_save()
            # not swallowed: the save's error rides the crash as a note,
            # and the crash is re-raised below  # repro-lint: disable=REP008
            except Exception as save_err:
                err.add_note(f"repro_torch.runtime: the crash save failed "
                             f"too: {save_err!r}")
            raise
        finally:
            if self.ckpt is not None:
                self.ckpt.wait()
            try:
                signal.signal(signal.SIGTERM, old)
            except (ValueError, TypeError):
                pass

    def _preempt_hook(self, step: int):
        def hook():
            self.fault_log.append({"kind": "preempt", "step": step})
            raise Preempted(f"injected preemption at step {step} (inside "
                            f"the optimizer update)")
        return hook

    def _maybe_corrupt(self, step: int) -> None:
        """ckpt_corrupt fault hook: flip one seeded byte in the
        checkpoint just written (after the async write lands)."""
        if self.faults.take("ckpt_corrupt", step) is None:
            return
        self.ckpt.wait()
        fn, off = self.ckpt.corrupt(step, seed=self.faults.seed)
        self.fault_log.append({"kind": "ckpt_corrupt", "step": step,
                               "file": fn, "offset": off})

    def _rollback(self, at_step: int) -> int:
        """Roll back to the newest verified checkpoint outside the bad
        streak (saved counter ``bad == 0``) and return the step to replay
        from; re-init at 0 when no generation qualifies. Tasks are
        seekable, so replay recomputes the same batches."""
        cfg = self.cfg
        if len(self.rollbacks) >= cfg.max_rollbacks:
            raise RuntimeError(
                f"non-finite steps persist after {len(self.rollbacks)} "
                f"rollbacks (max_rollbacks={cfg.max_rollbacks}); "
                "refusing to loop")
        to = None
        if self.ckpt is not None:
            self.ckpt.wait()
            self._barrier()   # rank 0's writes have landed
            for s in self.ckpt.generations():
                try:
                    tree = self.ckpt.restore(s, device="cpu")
                except (CheckpointCorrupt, OSError, ValueError,
                        KeyError) as e:
                    warnings.warn(
                        f"repro_torch.runtime: rollback skipping checkpoint "
                        f"step {s} (failed verification: {e})",
                        RuntimeWarning, stacklevel=2)
                    continue
                if int(np.asarray(tree.get("bad", 0))) > 0:
                    # saved mid-streak: its step counter has advanced past
                    # updates the guard skipped, so replay from it would
                    # drop them forever
                    warnings.warn(
                        f"repro_torch.runtime: rollback skipping checkpoint "
                        f"step {s} (saved inside a bad streak)",
                        RuntimeWarning, stacklevel=2)
                    continue
                self._adopt(tree, s)
                to = s
                break
        if to is None:
            self._reinit()
            to = 0
        self._rescue = None  # the pre-rollback copy is stale
        self.rollbacks.append(RollbackReport(at_step, to))
        warnings.warn(
            f"repro_torch.runtime: {cfg.max_bad_steps} consecutive "
            f"non-finite steps at step {at_step}; rolled back to "
            f"verified checkpoint step {to} and replaying",
            RuntimeWarning, stacklevel=2)
        return to

    def _crash_save(self) -> None:
        """Rescue checkpoint after an uncaught failure: the live state when
        it is whole, else the last rescue copy, else nothing (the restart
        resumes from the last periodic checkpoint). Never torn state. A
        model holding expert parts writes its rescue copy only: gathering
        its live stacks needs every rank, which a crash on one cannot
        join."""
        if self.ckpt is None or not self.writer:
            return
        self.ckpt.wait()
        if not self._torn and not any(self._parted):
            self.ckpt.save(self.steps_done, self.state_tree(), blocking=True,
                           extra=self._ckpt_extra())
        elif self._rescue is not None:
            step, host, extra = self._rescue
            self.ckpt.save(step, host, blocking=True, extra=extra)


def reduce_gradients(grads: list, mesh, parted: list) -> list:
    """``grads`` summed over every rank of ``mesh``, those whose
    ``parted`` flag is set (expert stacks holding one rank's experts)
    over the "data" group only: fp32 all-reduces of buckets of up to
    ``REDUCE_BUCKET`` elements (the gradients flattened together), a
    larger fp32 gradient in place, so the reduction's own memory is one
    bucket."""
    out = list(grads)
    reductions = [(False, None)]
    if pax.mesh_shape(mesh).get("data", 1) > 1:
        reductions.append((True, mesh.get_group("data")))
    for part, group in reductions:
        bucket, size = [], 0
        idx = [i for i, p in enumerate(parted) if p == part]
        for n, i in enumerate(idx):
            g = grads[i]
            if g.numel() >= REDUCE_BUCKET and g.dtype == torch.float32:
                out[i] = C.all_reduce_(g.contiguous(), group)
            else:
                bucket.append(i)
                size += g.numel()
            if bucket and (size >= REDUCE_BUCKET or n == len(idx) - 1):
                flat = torch.cat([grads[j].reshape(-1).float()
                                  for j in bucket])
                C.all_reduce_(flat, group)
                for j, piece in zip(bucket, flat.split(
                        [grads[j].numel() for j in bucket])):
                    out[j] = piece.view(grads[j].shape).to(grads[j].dtype)
                bucket, size = [], 0
    return out
