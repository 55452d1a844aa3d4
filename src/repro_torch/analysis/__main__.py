"""CLI: ``python -m repro_torch.analysis [paths...]``.

Lints every ``*.py`` under the given paths (default: ``src/repro_torch``)
against the port's policy rules (REP002, REP005, REP007, REP008),
subtracts the baseline (default: the checked-in one, empty, and it stays
so), optionally writes the machine-readable report, and exits nonzero iff
new violations exist. ``--list-rules`` prints the rule registry;
``--update-baseline`` rewrites the given baseline to accept the current
tree (the checked-in one is meant to stay empty)."""

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
    ap.add_argument("--baseline", metavar="PATH",
                    default=str(_BASELINE),
                    help="baseline JSON (default: the checked-in one); "
                         "'none' disables baselining")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to accept the current tree")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    args = ap.parse_args(argv)

    rules = lint.default_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.code}  [{r.origin}]  {r.title}\n    fix: {r.fix_hint}")
        return 0

    baseline_path = None if args.baseline == "none" else args.baseline
    violations = lint.lint_paths(args.paths, rules=rules)

    if args.update_baseline:
        if baseline_path is None:
            print("--update-baseline needs a baseline path", file=sys.stderr)
            return 2
        lint.write_baseline(baseline_path, violations)
        print(f"baseline updated: {len(violations)} violation(s) accepted "
              f"-> {baseline_path}")
        return 0

    baseline = lint.load_baseline(baseline_path)
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
