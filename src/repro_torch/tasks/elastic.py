"""Elastic-ladder machinery for graph tasks (paper §III-D) — the port of
``repro.tasks.elastic``.

An AutoTuner walks a ``beta_thre`` ladder on the Loss-Descent-Rate signal
the Trainer feeds at epoch boundaries, and a ladder move swaps in a
re-reformed layout:

* every rung's layout is prepared ONCE at construction and padded to one
  shape budget (``mb``, ``mt``), so a move swaps array contents, never
  shapes;
* device uploads are deduped by host-array identity: rung-invariant
  arrays (features, degrees, labels) are aliased across rungs by the
  ladder preps and live on the device once;
* tuner state and the move log round-trip through
  ``state_dict``/``load_state_dict``;
* on a mesh every rank's batch is its sequence shard of the per-node
  arrays (``SEQ_KEYS``) and its data shard of every array, the
  per-graph layouts included (the layouts of a graph stay whole), cut
  on the host before the upload, so each rank uploads each shared
  array's shard once (a sequence that does not split over "model" stays
  whole on every rank, ``parallel.sharding.fit_sequence``); every rank
  feeds its AutoTuner rank 0's loss and
  the slowest rank's epoch seconds, so every rank makes the same ladder
  moves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.auto_tuner import AutoTuner
from repro_torch.core.graph_model import batch_to_torch
from repro_torch.device import resolve
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import fit_sequence
from repro_torch.tasks.base import Task, shard_rows

# the batch arrays with a per-node sequence dim (dim 1), sharded on a
# mesh; dense_buckets (B, S, S) by its rows
SEQ_KEYS = ("feat", "in_deg", "out_deg", "lap_pe", "labels",
            "dense_buckets")


@dataclasses.dataclass
class LadderMove:
    step: int           # trainer step after which the move happened
    pos: int            # new ladder position
    beta_thre: float    # new transfer threshold
    ldr: float          # the LDR value that triggered the move


class ElasticTask(Task):
    """A task whose layouts live on an AutoTuner ``beta_thre`` ladder.
    Subclasses provide the rung preps (``_set_rungs``) and ``eval``."""

    name = "elastic"

    def _init_ladder(self, beta_g: float, delta: int, device) -> list:
        """Create the tuner; returns the deduped rung thresholds to
        prepare (the top of the ladder can collapse to 1.0)."""
        self.device = resolve(device)
        self.tuner = AutoTuner(beta_g=beta_g, delta=delta)
        self.moves: list[LadderMove] = []
        self._batches_dev: dict[tuple, dict] = {}
        self._uploads: dict[int, object] = {}  # id(host arr) -> tensor
        return list(dict.fromkeys(self.tuner.ladder))

    def _set_rungs(self, preps: dict) -> None:
        """``preps``: beta_thre -> list[PreparedGraph] (one per
        mini-batch), all padded to one shape budget — validated here."""
        self._preps = {bt: list(ps) for bt, ps in preps.items()}
        first = next(iter(self._preps.values()))[0]
        shapes = {k: v.shape for k, v in first.batch.items()}
        self.n_batches = len(next(iter(self._preps.values())))
        for ps in self._preps.values():
            if len(ps) != self.n_batches:
                raise AssertionError("rungs have unequal mini-batch counts")
            for p in ps:
                got = {k: v.shape for k, v in p.batch.items()}
                if got != shapes:
                    raise AssertionError(
                        f"rung/mini-batch shape drift: {got} != {shapes}")
        self.mb_cap = first.layout.mb
        self.prep_seconds = sum(p.prep_seconds
                                for ps in self._preps.values() for p in ps)

    def prepare(self, model, mesh=None, recipe=None):
        if recipe is not None:
            # a sequence that does not split over "model" stays whole on
            # every rank (the rungs share one sequence length)
            recipe = fit_sequence(recipe, mesh, self.layout.seq_len)
        if mesh is not self.mesh or recipe is not self.recipe:
            # the cached uploads are another shard
            self._batches_dev.clear()
            self._uploads.clear()
        return super().prepare(model, mesh, recipe)

    def _shard(self, key: str, arr):
        """This rank's part of the host array ``arr`` of batch key ``key``
        (all of it without a mesh)."""
        if self.mesh is None:
            return arr
        return shard_rows(arr, self.mesh,
                          seq_dim=key in SEQ_KEYS and self.seq_sharded)

    def _upload(self, batch: dict, uploads: dict | None = None) -> dict:
        """``batch`` (host arrays) on the task's device, this rank's shard
        on a mesh."""
        return batch_to_torch(batch, self.device, uploads, self._shard)

    @property
    def beta_thre(self) -> float:
        return self.tuner.beta_thre

    @property
    def prep(self):
        """The active rung's first PreparedGraph."""
        return self._preps[self.tuner.beta_thre][0]

    @property
    def conditions_ok(self) -> bool:
        return all(p.report.ok for p in self._preps[self.tuner.beta_thre])

    @property
    def layout(self):
        return self.prep.layout

    def batches(self, step: int) -> dict:
        """The active rung's device batch for this step. Uploads are cached
        per (rung, mini-batch) and deduped by host-array identity, so a
        ladder move uploads only the pattern arrays."""
        bt = self.tuner.beta_thre
        idx = step % self.n_batches
        key = (bt, idx)
        if key not in self._batches_dev:
            self._batches_dev[key] = self._upload(
                self._preps[bt][idx].batch, self._uploads)
        return self._batches_dev[key]

    def on_epoch(self, loss: float, epoch_seconds: float,
                 step: int) -> bool:
        """Feed one epoch's (mean loss, wall seconds) to the AutoTuner;
        returns True iff the ladder moved. On a mesh every rank feeds rank
        0's loss and the slowest rank's seconds: rank-local timings would
        make the ranks' ladders diverge."""
        if self.mesh is not None:
            dev = C.control_device()
            t = torch.tensor([float(epoch_seconds)], dtype=torch.float64,
                             device=dev)
            C.all_reduce_(t, None, op=dist.ReduceOp.MAX)
            t = torch.tensor([float(loss), t.item()], dtype=torch.float64,
                             device=dev)
            C.broadcast_(t, 0)
            loss, epoch_seconds = t.tolist()
        before = self.tuner.pos
        self.tuner.update(float(loss), float(epoch_seconds))
        if self.tuner.pos == before:
            return False
        self.moves.append(LadderMove(step=step, pos=self.tuner.pos,
                                     beta_thre=self.tuner.beta_thre,
                                     ldr=float(self.tuner.last_ldr)))
        return True

    def log_extras(self) -> dict:
        return {"beta_thre": float(self.beta_thre)}

    def state_dict(self) -> dict:
        stats = {k: (int(v) if isinstance(v, (int, np.integer)) else
                     float(v))
                 for k, v in self.layout.stats.items()}
        return {"task": self.name,
                "tuner": self.tuner.state_dict(),
                "mb_cap": int(self.mb_cap),
                "layout_stats": stats,
                "moves": [dataclasses.asdict(m) for m in self.moves]}

    def load_state_dict(self, d: dict) -> None:
        if d.get("task", self.name) != self.name:
            raise ValueError(
                f"state belongs to task {d['task']!r}, not {self.name!r}")
        self.tuner.load_state_dict(d["tuner"])
        if int(d["mb_cap"]) != self.mb_cap:
            raise ValueError(
                f"state's mb capacity {d['mb_cap']} != this task's "
                f"{self.mb_cap}: graph or prep knobs changed")
        if self.tuner.beta_thre not in self._preps:
            raise ValueError(
                f"ladder rung {self.tuner.beta_thre} has no prepared "
                f"layout: graph changed")
        self.moves = [LadderMove(**m) for m in d.get("moves", [])]
