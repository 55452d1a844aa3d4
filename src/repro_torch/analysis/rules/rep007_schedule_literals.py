"""REP007 — kernel block and tile sizes come from the schedule tables.

Origin: the reference's rule of the same code (its kernel autotuner). A
literal default
in a kernel signature silently shadows the winner table: the call runs
and never consults the tuned schedule. In the port the constants live in
one place, ``repro_torch.tune.schedule.DEFAULT_SCHEDULES`` (consulted by
``kernels/ops.resolve_schedule``, winner table first), and the kernel
modules take the sizes as required arguments. This rule forbids integer
literals for schedule-shaped parameters (``block_q``, ``block_k``,
``bq``, ``bk``, ``chunk``, ``row_chunk``), as signature defaults and as
call keywords, anywhere under ``repro_torch/kernels/``.
"""

from __future__ import annotations

import ast

from repro_torch.analysis import lint

_SCHEDULE_PARAMS = {"block_q", "block_k", "bq", "bk", "chunk", "row_chunk"}


def _applies(relpath: str) -> bool:
    return "repro_torch/kernels/" in relpath


def _is_int_literal(node: ast.AST) -> bool:
    # bool is an int subclass; True/False are not block sizes
    return isinstance(node, ast.Constant) \
        and isinstance(node.value, int) \
        and not isinstance(node.value, bool)


def _check(tree: ast.AST, relpath: str):
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            pos = a.posonlyargs + a.args
            pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
            pairs += [(arg, d) for arg, d in zip(a.kwonlyargs, a.kw_defaults)
                      if d is not None]
            for arg, default in pairs:
                if arg.arg in _SCHEDULE_PARAMS and _is_int_literal(default):
                    out.append((default.lineno,
                                f"literal default {arg.arg}="
                                f"{default.value} in a kernel signature"))
        elif isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg in _SCHEDULE_PARAMS and _is_int_literal(kw.value):
                    out.append((kw.value.lineno,
                                f"literal {kw.arg}={kw.value.value} at a "
                                f"kernel call site"))
    return out


RULE = lint.Rule(
    code="REP007",
    title="kernel block sizes resolve through the schedule tables",
    origin="the reference's REP007: its kernel autotuner",
    fix_hint="take the size as a required argument and let "
             "kernels/ops.resolve_schedule supply it (winner table first, "
             "repro_torch.tune.schedule.DEFAULT_SCHEDULES as the backstop) "
             "— a literal here silently shadows every tuned schedule",
    applies=_applies,
    check=_check,
)
