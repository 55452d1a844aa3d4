"""REP002 — kernels are reached only through the dispatch layer.

Origin: the reference's rule of the same code (its kernel dispatch
policy, ROADMAP.md).
In the port, ``kernels/ops.py`` sends a CUDA tensor to the hand-written
kernel (or raises) and a CPU tensor to the plain version, resolves the
winner table's schedule, and keeps autograd on its ``torch.autograd.
Function`` wrappers. A direct call into a kernel module, its plain
versions (``kernels/ref.py``) or its nvcc build skips all of that. Only
``repro_torch/kernels/`` itself may import its own modules.
"""

from __future__ import annotations

import ast

from repro_torch.analysis import lint

_PKG = ["repro_torch", "kernels"]
_KERNEL_MODULES = {"build", "cluster_attention", "cluster_attention_bwd",
                   "flash_attention", "ref", "ssd"}


def _applies(relpath: str) -> bool:
    return "repro_torch/" in relpath and \
        "repro_torch/kernels/" not in relpath


def _check(tree: ast.AST, relpath: str):
    from repro_torch.analysis.rules import dotted

    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            parts = (node.module or "").split(".")
            if parts == _PKG:
                for alias in node.names:
                    if alias.name in _KERNEL_MODULES:
                        out.append((node.lineno,
                                    f"direct import of kernel module "
                                    f"repro_torch.kernels.{alias.name}"))
            elif parts[:2] == _PKG and len(parts) > 2 \
                    and parts[2] in _KERNEL_MODULES:
                out.append((node.lineno,
                            f"direct import from kernel module "
                            f"{node.module}"))
        elif isinstance(node, ast.Import):
            for alias in node.names:
                parts = alias.name.split(".")
                if parts[:2] == _PKG and len(parts) > 2 \
                        and parts[2] in _KERNEL_MODULES:
                    out.append((node.lineno,
                                f"direct import of kernel module "
                                f"{alias.name}"))
        elif isinstance(node, ast.Attribute):
            # only the exact repro_torch.kernels.<mod> node: ast.walk also
            # visits the nested Attributes of a longer chain
            parts = (dotted(node) or "").split(".")
            if parts[:2] == _PKG and len(parts) == 3 \
                    and parts[2] in _KERNEL_MODULES:
                out.append((node.lineno,
                            f"direct reference to repro_torch.kernels."
                            f"{parts[2]}"))
    return out


RULE = lint.Rule(
    code="REP002",
    title="kernel modules and plain versions are called only via "
          "repro_torch.kernels.ops",
    origin="the reference's REP002: its kernel dispatch policy",
    fix_hint="call repro_torch.kernels.ops.{cluster_attention,"
             "flash_attention,ssd,paged_attention} — dispatch picks the "
             "kernel or the plain version by device, resolves the winner "
             "table's schedule and stays differentiable",
    applies=_applies,
    check=_check,
)
