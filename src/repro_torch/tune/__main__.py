"""Autotune CLI — search the port's kernel schedules, persist the winner
table, record the BENCH trajectory, optionally wall-clock-check a winner.

  PYTHONPATH=src python -m repro_torch.tune                  # on the card
  PYTHONPATH=src python -m repro_torch.tune --ops flash_attention,ssd
  PYTHONPATH=src python -m repro_torch.tune --offline --device cpu

Without ``--offline`` every candidate is timed on the card (CUDA events)
through the real dispatch path and gated kernel-vs-plain. ``--offline``
scores candidates with the reference's deterministic cost model; with
``--device cpu`` no kernel runs and the gate holds the plain version
under each candidate to the defaults (the table records ``backend:
cpu``, which CUDA dispatch treats as stale). ``--check R`` wall-clocks
the tuned cluster-attention schedule against the default and exits 1
beyond ``R``x; it needs the card. ``--device`` defaults to ``cuda`` and
raises without CUDA. Artifacts: ``TUNE_winners_torch.json`` (what
dispatch loads) and ``BENCH_autotune_torch.json`` (records per
``repro_torch.tune.search.AUTOTUNE_SCHEMA``), both gitignored."""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.device import resolve
from repro_torch.tune.runtime import DEFAULT_TABLE_PATH
from repro_torch.tune.search import (AUTOTUNE_SCHEMA, TUNABLE_OPS,
                                     check_regression, tune_all)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune")
    ap.add_argument("--offline", action="store_true",
                    help="deterministic cost-model scoring")
    ap.add_argument("--ops", default=None,
                    help=f"comma-separated subset of {','.join(TUNABLE_OPS)}")
    ap.add_argument("--out-table", default=DEFAULT_TABLE_PATH,
                    help="winner-table path (what dispatch loads)")
    ap.add_argument("--bench-json", default="BENCH_autotune_torch.json",
                    help="where to write the autotune bench records")
    ap.add_argument("--check", type=float, default=None, metavar="RATIO",
                    help="wall-clock the tuned cluster schedule vs the "
                         "default; exit 1 beyond RATIO x (needs CUDA)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    ops = tuple(s for s in (args.ops or "").split(",") if s) or None
    for op in ops or ():
        if op not in TUNABLE_OPS:
            ap.error(f"unknown op {op!r} (choose from {TUNABLE_OPS})")
    device = resolve(args.device)

    table, records = tune_all(ops, offline=args.offline, device=device,
                              log=print)
    table.save(args.out_table)
    print(f"# wrote {args.out_table} ({len(table.entries)} entries, gated "
          f"on {table.backend})", flush=True)

    payload = {"schema": list(AUTOTUNE_SCHEMA), "backend": table.backend,
               "records": records}
    ok = True
    if args.check is not None:
        result = check_regression(table, threshold=args.check, device=device,
                                  log=print)
        payload["check"] = result
        ok = result["ok"]
    with open(args.bench_json, "w") as fh:
        json.dump(payload, fh, indent=2)
    print(f"# wrote {args.bench_json} ({len(records)} records)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
