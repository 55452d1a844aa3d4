"""AST policy linter of the port: the reference's linter
(``repro.analysis.lint``) and its rules that are not tied to JAX, scoped
to ``repro_torch/`` paths, under the reference's codes.

Each rule (``repro_torch.analysis.rules``) walks a file's AST and reports
violations with a fix hint:

* REP002 — kernel modules are reached only through ``kernels/ops.py``;
* REP005 — no model-family branches in the Trainer, no ``loss_dense``;
* REP007 — no block-size literals under ``kernels/``: the constants live
  in ``tune/schedule.DEFAULT_SCHEDULES``;
* REP008 — no broad ``except`` that neither re-raises nor warns.

The reference's REP001, REP003, REP004 and REP006 police JAX, XLA and its
``kernels/policy.py``, which the port does not have; they are not ported.

Mechanics, as the reference's:

* **Suppression** is per line: ``# repro-lint: disable=REP008`` (comma-
  separate several codes) on the flagged physical line silences it; on a
  pure comment line it also covers the next line. Use a suppression only
  with a neighbouring comment saying *why* the contract does not apply.
* **Baseline**: a checked-in JSON file (``baseline.json`` next to this
  module) maps ``"path::code"`` to an allowed violation count; only
  violations beyond it fail a run. It is empty, and stays so.
* **Report**: ``write_report`` emits a machine-readable JSON document
  (rule registry, every violation, the new-vs-baseline verdict).

Entry points: ``python -m repro_torch.analysis`` (CLI, ``__main__.py``)
and ``lint_paths`` / ``new_violations`` for tests. Standard library only.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re
from typing import Callable, Iterable

SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=([A-Z0-9_,\s]+)")

# markers that identify the repo root when resolving rule-scoped
# relative paths (fixture trees in tests provide their own root)
_ROOT_MARKERS = ("ROADMAP.md", ".git")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One rule hit: ``path`` is root-relative posix, ``line`` 1-based."""

    path: str
    line: int
    code: str
    message: str
    fix_hint: str

    @property
    def key(self) -> str:
        """Baseline key — deliberately line-less so edits above a known
        violation do not churn the baseline."""
        return f"{self.path}::{self.code}"

    def format(self) -> str:
        return (f"{self.path}:{self.line}: {self.code} {self.message}\n"
                f"    hint: {self.fix_hint}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    """A policy rule: ``applies(relpath)`` scopes it, ``check(tree,
    relpath)`` yields ``(line, message)`` hits. ``origin`` names the
    reference rule and policy it carries over."""

    code: str
    title: str
    origin: str
    fix_hint: str
    applies: Callable[[str], bool]
    check: Callable[[ast.AST, str], list]

    def describe(self) -> dict:
        return {"code": self.code, "title": self.title,
                "origin": self.origin, "fix_hint": self.fix_hint}


def default_rules() -> list[Rule]:
    from repro_torch.analysis.rules import RULES
    return list(RULES)


def find_root(path: pathlib.Path) -> pathlib.Path:
    """Nearest ancestor carrying a repo marker; falls back to ``path``
    itself (or its parent for files) so fixture trees lint in isolation."""
    path = path.resolve()
    start = path if path.is_dir() else path.parent
    for cand in (start, *start.parents):
        if any((cand / m).exists() for m in _ROOT_MARKERS):
            return cand
    return start


def iter_py_files(paths: Iterable[pathlib.Path | str]):
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            yield from sorted(q for q in p.rglob("*.py")
                              if "__pycache__" not in q.parts)
        elif p.suffix == ".py":
            yield p


def _suppressions(text: str) -> dict[int, set[str]]:
    """Line -> suppressed codes. An inline ``# repro-lint: disable=...``
    covers its own line; one on a pure comment line also covers the next
    line (the long-statement style)."""
    out: dict[int, set[str]] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = SUPPRESS_RE.search(line)
        if not m:
            continue
        codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
        out.setdefault(i, set()).update(codes)
        if line.lstrip().startswith("#"):
            out.setdefault(i + 1, set()).update(codes)
    return out


def lint_file(path: pathlib.Path, relpath: str,
              rules: list[Rule]) -> list[Violation]:
    text = path.read_text()
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Violation(relpath, e.lineno or 1, "REP000",
                          f"file does not parse: {e.msg}",
                          "fix the syntax error")]
    suppressed = _suppressions(text)
    out = []
    for rule in rules:
        if not rule.applies(relpath):
            continue
        for line, message in rule.check(tree, relpath):
            if rule.code in suppressed.get(line, ()):
                continue
            out.append(Violation(relpath, line, rule.code, message,
                                 rule.fix_hint))
    return out


def lint_paths(paths: Iterable[pathlib.Path | str], *,
               rules: list[Rule] | None = None,
               root: pathlib.Path | str | None = None) -> list[Violation]:
    """Lint every ``*.py`` under ``paths``. Rule scoping matches on paths
    relative to ``root`` (auto-detected repo root when omitted)."""
    rules = default_rules() if rules is None else rules
    paths = [pathlib.Path(p) for p in paths]
    out: list[Violation] = []
    for f in iter_py_files(paths):
        base = pathlib.Path(root).resolve() if root is not None \
            else find_root(f)
        try:
            rel = f.resolve().relative_to(base).as_posix()
        except ValueError:
            rel = f.as_posix()
        out.extend(lint_file(f, rel, rules))
    return sorted(out, key=lambda v: (v.path, v.line, v.code))


# ------------------------------------------------------------- baseline

def load_baseline(path: pathlib.Path | str | None) -> dict[str, int]:
    if path is None:
        return {}
    path = pathlib.Path(path)
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    return {str(k): int(v) for k, v in data.get("allowed", {}).items()}


def baseline_counts(violations: Iterable[Violation]) -> dict[str, int]:
    counts: dict[str, int] = {}
    for v in violations:
        counts[v.key] = counts.get(v.key, 0) + 1
    return counts


def write_baseline(path: pathlib.Path | str,
                   violations: Iterable[Violation]) -> None:
    doc = {"comment": "repro_torch.analysis lint baseline: path::code -> "
                      "allowed count. Violations beyond these counts fail "
                      "the run.",
           "allowed": baseline_counts(violations)}
    pathlib.Path(path).write_text(json.dumps(doc, indent=2, sort_keys=True)
                                  + "\n")


def new_violations(violations: list[Violation],
                   baseline: dict[str, int]) -> list[Violation]:
    """Violations beyond the baselined per-(path, code) count. Which hit
    of an over-budget key is 'new' is ambiguous — all of them are
    reported so the operator sees the full set to choose from."""
    counts = baseline_counts(violations)
    return [v for v in violations if counts[v.key] > baseline.get(v.key, 0)]


# --------------------------------------------------------------- report

def write_report(path: pathlib.Path | str, violations: list[Violation],
                 fresh: list[Violation], *, rules: list[Rule] | None = None,
                 paths: list[str] | None = None) -> dict:
    rules = default_rules() if rules is None else rules
    doc = {
        "tool": "repro_torch.analysis",
        "paths": list(paths or []),
        "rules": [r.describe() for r in rules],
        "violations": [v.to_json() for v in violations],
        "new_violations": [v.to_json() for v in fresh],
        "counts": baseline_counts(violations),
        "ok": not fresh,
    }
    pathlib.Path(path).write_text(json.dumps(doc, indent=2) + "\n")
    return doc
