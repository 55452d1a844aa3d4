"""REP008 — no swallowed broad exception handlers in ``repro_torch/``.

Origin: the reference's rule of the same code (its fault-tolerance
layer). A recovery
story is only as honest as its error handling: a bare ``except:`` or a
broad ``except Exception:`` whose body neither re-raises nor warns turns
a real fault into silence. Every broad handler must do one of:

* re-raise (``raise`` anywhere in the handler body, including a typed
  re-wrap like ``raise CheckpointCorrupt(...) from e``);
* warn (a ``warnings.warn`` / ``logger.warning`` style call); or
* carry a justifying ``# repro-lint: disable=REP008`` suppression on the
  ``except`` line, with a comment saying why swallowing is correct
  there.

Narrow handlers (``except ValueError:`` etc.) are out of scope — naming
the exception is already a statement about what is safe to swallow.
"""

from __future__ import annotations

import ast

from repro_torch.analysis import lint

_BROAD = {"Exception", "BaseException"}
_WARN_CALLS = {"warn", "warning", "warn_explicit"}


def _applies(relpath: str) -> bool:
    # library code only: tests, tools and scripts may assert around broad
    # catches
    return "repro_torch/" in relpath


def _is_broad(handler: ast.ExceptHandler) -> bool:
    from repro_torch.analysis.rules import dotted
    if handler.type is None:  # bare except:
        return True
    nodes = handler.type.elts if isinstance(handler.type, ast.Tuple) \
        else [handler.type]
    for node in nodes:
        name = dotted(node)
        if name and name.split(".")[-1] in _BROAD:
            return True
    return False


def _handled(handler: ast.ExceptHandler) -> bool:
    from repro_torch.analysis.rules import dotted
    for stmt in handler.body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call):
                name = dotted(node.func)
                if name and name.split(".")[-1] in _WARN_CALLS:
                    return True
    return False


def _check(tree: ast.AST, relpath: str):
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and _is_broad(node) and \
                not _handled(node):
            what = "bare except" if node.type is None else \
                "broad except handler"
            out.append((node.lineno,
                        f"{what} swallows the exception (no raise, no "
                        f"warn)"))
    return out


RULE = lint.Rule(
    code="REP008",
    title="broad except handlers must re-raise, warn, or justify",
    origin="the reference's REP008: its fault-tolerance layer",
    fix_hint="re-raise (possibly as a typed error), emit a "
             "warnings.warn, or add '# repro-lint: disable=REP008' with "
             "a comment justifying the swallow",
    applies=_applies,
    check=_check,
)
