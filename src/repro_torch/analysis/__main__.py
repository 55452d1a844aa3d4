"""CLI: ``python -m repro_torch.analysis [paths...]``.

Lints every ``*.py`` under the given paths (default: ``src/repro_torch``)
against the port's policy rules (REP002, REP005, REP007, REP008),
subtracts the checked-in baseline (empty, and it stays so), optionally
writes the machine-readable report, and exits nonzero iff new
violations exist."""

from __future__ import annotations

import argparse
import pathlib
import sys

from repro_torch.analysis import lint

_BASELINE = pathlib.Path(__file__).parent / "baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's policy linter (rules REP002, REP005, "
                    "REP007, REP008, the reference's codes scoped to "
                    "repro_torch/)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--report", metavar="PATH", default=None,
                    help="write the machine-readable JSON report here")
    args = ap.parse_args(argv)

    rules = lint.default_rules()
    violations = lint.lint_paths(args.paths, rules=rules)
    baseline = lint.load_baseline(_BASELINE)
    fresh = lint.new_violations(violations, baseline)

    if args.report:
        lint.write_report(args.report, violations, fresh, rules=rules,
                          paths=[str(p) for p in args.paths])

    for v in fresh:
        print(v.format())
    n_base = len(violations) - len(fresh)
    print(f"repro_torch.analysis: {len(fresh)} new violation(s), "
          f"{n_base} baselined, {len(rules)} rules")
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
