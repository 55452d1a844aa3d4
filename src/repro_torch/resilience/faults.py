"""Deterministic fault injection: the seeded FaultPlan — the port of
``repro.resilience.faults``, with the same spec, kinds, errors and
``REPRO_FAULTS`` precedence.

A plan is a comma-separated spec of ``kind@step`` (or ``kind@a-b`` for an
inclusive step range) entries plus an optional ``seed=N``::

    REPRO_FAULTS="nonfinite@5,preempt@7,ckpt_corrupt@10,seed=3"

Kinds (each maps to ONE explicit hook point — never monkeypatching):

* ``nonfinite``   — runtime/trainer.py multiplies the step loss by NaN on
  the armed step only (healthy steps run no extra op); gradients poison
  through and the non-finite guard must catch them.
* ``preempt``     — ``optim.adamw.AdamW.update`` calls the trainer's hook
  halfway through the parameter list, which raises :class:`Preempted`:
  the worst instant of an update in place, with some parameters and
  moments written and the rest not.
* ``ckpt_corrupt``— runtime/trainer.py calls ``Checkpointer.corrupt``
  on the checkpoint it just wrote (one seeded byte flip in one leaf
  blob; manifest and COMMITTED untouched, so only checksum verification
  can catch it).
* ``burst``       — serve-side arrival bursts. The spec parses; its hook
  (the serve engine's ``inject_burst``) comes with token serving.

Faults are *consumable*: :meth:`FaultPlan.take` hands a fault out exactly
once. A transient fault therefore does not re-fire on the replayed steps
after a rollback/resume — which is both what real transient faults do and
what keeps recovery convergent.
"""

from __future__ import annotations

import dataclasses
import os

ENV_VAR = "REPRO_FAULTS"

KINDS = ("nonfinite", "preempt", "ckpt_corrupt", "burst")


class Preempted(RuntimeError):
    """Injected preemption (``preempt@k``): raised by the trainer's hook
    inside the optimizer's in-place update."""


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str
    step: int


@dataclasses.dataclass
class FaultPlan:
    faults: tuple[Fault, ...] = ()
    seed: int = 0
    spec: str = ""

    def __post_init__(self):
        self._fired: set[tuple[str, int]] = set()

    # --------------------------------------------------------- parsing

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        faults: list[Fault] = []
        seed = 0
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            if part.startswith("seed="):
                seed = int(part[5:])
                continue
            kind, sep, at = part.partition("@")
            if not sep or not at:
                raise ValueError(
                    f"bad fault spec entry {part!r}: want kind@step "
                    f"or kind@a-b (spec {spec!r})")
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} in {part!r}; "
                    f"known kinds: {', '.join(KINDS)}")
            lo, dash, hi = at.partition("-")
            if dash and lo.isdigit() and hi.isdigit():
                steps = range(int(lo), int(hi) + 1)
            elif at.isdigit():
                steps = [int(at)]
            else:
                raise ValueError(
                    f"bad fault step {at!r} in {part!r}: want a "
                    f"non-negative step or an a-b range")
            for s in steps:
                faults.append(Fault(kind, s))
        faults.sort(key=lambda f: (f.step, f.kind))
        return cls(tuple(faults), seed, spec)

    @classmethod
    def resolve(cls, cfg_spec: str = "") -> "FaultPlan":
        """Env ``REPRO_FAULTS`` wins over the config spec when set, as in
        the reference."""
        return cls.parse(os.environ.get(ENV_VAR) or cfg_spec or "")

    # -------------------------------------------------------- consuming

    def take(self, kind: str, step: int) -> Fault | None:
        """Return the armed fault of ``kind`` at ``step`` and mark it
        fired, or None. Each fault fires exactly once per plan, so a
        replay after rollback/resume runs clean."""
        key = (kind, step)
        if key in self._fired:
            return None
        for f in self.faults:
            if f.kind == kind and f.step == step:
                self._fired.add(key)
                return f
        return None

    def pending(self) -> tuple[Fault, ...]:
        return tuple(f for f in self.faults
                     if (f.kind, f.step) not in self._fired)

    def __bool__(self) -> bool:
        return bool(self.faults)
