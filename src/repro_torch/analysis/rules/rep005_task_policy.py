"""REP005 — no per-family branches in the Trainer, no ``loss_dense``.

Origin: the reference's rule of the same code (its Task layer policy,
ROADMAP.md). All
workload behaviour enters the port's runtime through
``repro_torch.tasks.Task``: the Trainer runs one step per loss variant
and carries no model-family or task-type branches; ``loss_dense`` gave
way to the variants dict and must not come back.

Two checks:

* in ``runtime/trainer.py``: any ``.family`` / ``.model_family`` /
  ``.arch`` attribute read, and any ``isinstance`` test against a
  concrete Task subclass — both are family branches in disguise;
* in runtime, models and tasks code (and the graph model): any reference
  to ``loss_dense`` — the behaviour belongs in ``loss_variants["dense"]``.
"""

from __future__ import annotations

import ast

from repro_torch.analysis import lint

_TRAINER = "repro_torch/runtime/trainer.py"
_LOSS_DENSE_SCOPES = ("repro_torch/runtime/", "repro_torch/models/",
                      "repro_torch/tasks/")
_LOSS_DENSE_FILES = ("repro_torch/core/graph_model.py",)

_FAMILY_ATTRS = {"family", "model_family", "arch"}
_TASK_CLASSES = {"NodeTask", "GraphLevelTask", "LinkTask", "BatchFnTask",
                 "ElasticTask", "ElasticGraphTask"}


def _in_loss_dense_scope(relpath: str) -> bool:
    return any(s in relpath for s in _LOSS_DENSE_SCOPES) or \
        any(relpath.endswith(f) for f in _LOSS_DENSE_FILES)


def _applies(relpath: str) -> bool:
    return relpath.endswith(_TRAINER) or _in_loss_dense_scope(relpath)


def _check(tree: ast.AST, relpath: str):
    out = []
    for node in ast.walk(tree):
        name = node.attr if isinstance(node, ast.Attribute) else \
            node.id if isinstance(node, ast.Name) else None
        if name == "loss_dense":
            out.append((node.lineno,
                        "reference to the removed Model.loss_dense"))
    if relpath.endswith(_TRAINER):
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and \
                    node.attr in _FAMILY_ATTRS:
                out.append((node.lineno,
                            f"model-family branch in the Trainer "
                            f"(reads .{node.attr})"))
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id == "isinstance" and len(node.args) == 2:
                names = {n.id for n in ast.walk(node.args[1])
                         if isinstance(n, ast.Name)}
                hit = sorted(names & _TASK_CLASSES)
                if hit:
                    out.append((node.lineno,
                                f"Trainer branches on concrete task type "
                                f"{hit[0]}"))
    return out


RULE = lint.Rule(
    code="REP005",
    title="no per-family branches in the Trainer; loss_dense stays dead",
    origin="the reference's REP005: its Task layer policy",
    fix_hint="behaviour rides the Task protocol: add a loss variant "
             "(loss_variants) or a Task method — the Trainer runs one step "
             "per variant and must stay family-agnostic",
    applies=_applies,
    check=_check,
)
