"""Static enforcement of the port's policy invariants: the AST policy
linter (``repro_torch.analysis.lint``) with the reference's rules that are
not tied to JAX (REP002, REP005, REP007, REP008; ``rules/``), each
carrying the reference rule it carries over, a fix hint, the
per-line ``# repro-lint: disable=REPxxx`` suppression and a checked-in,
empty baseline. Run it with ``python -m repro_torch.analysis [paths...]``.
"""

from __future__ import annotations

from repro_torch.analysis.lint import (Rule, Violation, baseline_counts,
                                       default_rules, lint_paths,
                                       load_baseline, new_violations,
                                       write_baseline, write_report)

__all__ = ["Rule", "Violation", "baseline_counts", "default_rules",
           "lint_paths", "load_baseline", "new_violations",
           "write_baseline", "write_report"]
