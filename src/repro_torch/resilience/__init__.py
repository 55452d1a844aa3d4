"""Fault-tolerance layer of the port: deterministic fault injection and
the chaos sweep — the port of ``repro.resilience``.

* :mod:`repro_torch.resilience.faults` — seeded :class:`FaultPlan`
  (``REPRO_FAULTS`` / ``TrainerConfig.fault_plan``) consumed through
  explicit hook points in the trainer, the optimizer and the
  checkpointer.
* :mod:`repro_torch.resilience.chaos` — ``python -m
  repro_torch.resilience`` runs the fault matrix end to end and writes
  ``RESILIENCE_report_torch.json``; every recovery that promises
  ``replay: exact`` is checked bitwise against an unfaulted run.
"""

from repro_torch.resilience.faults import (ENV_VAR, KINDS, Fault, FaultPlan,
                                           Preempted)

__all__ = ["ENV_VAR", "KINDS", "Fault", "FaultPlan", "Preempted"]
