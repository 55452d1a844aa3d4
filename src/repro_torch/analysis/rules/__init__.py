"""Rule registry and shared AST helpers of the port's policy linter.

One module per rule; each exposes a ``RULE``
(``repro_torch.analysis.lint.Rule``) and is listed here. The codes are
the reference's (``repro.analysis.rules``), scoped to ``repro_torch/``
paths; the reference's JAX and XLA rules (REP001, REP003, REP004,
REP006) have no counterpart.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.rules import (rep002_kernels, rep005_task_policy,
                                        rep007_schedule_literals,
                                        rep008_swallowed_except)

RULES = [
    rep002_kernels.RULE,
    rep005_task_policy.RULE,
    rep007_schedule_literals.RULE,
    rep008_swallowed_except.RULE,
]

RULES_BY_CODE = {r.code: r for r in RULES}

__all__ = ["RULES", "RULES_BY_CODE", "dotted", "walk_calls"]


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def walk_calls(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node
