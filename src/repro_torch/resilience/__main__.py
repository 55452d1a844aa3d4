"""CLI: ``python -m repro_torch.resilience`` — chaos sweep over the fault
matrix; exits non-zero when any injected fault is not recovered.

  PYTHONPATH=src python -m repro_torch.resilience --offline --device cpu
  PYTHONPATH=src python -m repro_torch.resilience            # on the card

``--device`` defaults to ``cuda`` and raises without CUDA.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.resilience",
        description="chaos sweep: inject the fault matrix (non-finite "
                    "steps, preemption inside the update, checkpoint "
                    "corruption, serve overload and deadlines) and verify "
                    "every recovery, bitwise where promised")
    ap.add_argument("--offline", action="store_true",
                    help="recorded as the report's mode (the sweep needs "
                         "nothing but the device)")
    ap.add_argument("--report", default="RESILIENCE_report_torch.json")
    ap.add_argument("--steps", type=int, default=8,
                    help="training steps per faulted run")
    ap.add_argument("--only", default=None,
                    help="substring filter over fault case names")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve
    from repro_torch.resilience.chaos import run_chaos
    doc = run_chaos(args.report, offline=args.offline, steps=args.steps,
                    only=args.only, device=resolve(args.device))
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
