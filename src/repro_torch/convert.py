"""Parameters of the JAX package -> the port's module state.

The JAX graph model and the JAX LMs keep their parameters as a nested
dict with the per-layer leaves stacked on a leading ``layers`` axis
(``nn/param.stack`` in the reference). :func:`params_from_jax` takes such
a tree with numpy leaves (``jax.tree.map(np.asarray, params)``) and
returns the flat state dict of
:class:`repro_torch.core.graph_model.GraphModel`,
:class:`repro_torch.models.lm.LMModel` or
:class:`repro_torch.models.api.SSMLMModel`, with the layer axis unstacked
into ``layers.<i>.*`` entries. :func:`params_to_jax` is its inverse: the
port's state dict back to the reference's nested tree, the layout of the
``params`` and optimizer-moment subtrees of the checkpoints both packages
write.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    for key in sorted(tree):
        val = tree[key]
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def params_from_jax(tree: dict) -> dict:
    """Nested numpy parameter tree -> ``{name: fp32 tensor}`` for the
    ``load_state_dict`` of any of the port's models. Arrays
    are copied, so read-only views of JAX buffers are fine."""
    state = {}
    for name, arr in _flatten(tree):
        arr = np.array(arr, dtype=np.float32, copy=True)
        if name.startswith("layers."):
            rest = name[len("layers."):]
            for i in range(arr.shape[0]):
                state[f"layers.{i}.{rest}"] = torch.from_numpy(
                    np.ascontiguousarray(arr[i]))
        else:
            state[name] = torch.from_numpy(arr)
    return state


def params_to_jax(state: dict) -> dict:
    """``{name: tensor}`` (``named_parameters``, or the optimizer's
    moments under the same names) -> the reference's nested tree:
    ``layers.<i>.*`` entries stacked on a leading ``layers`` axis, every
    other name split on ``.`` into nested dicts. Dtypes and devices are
    kept; stacked leaves are new tensors, the others detached views of
    the given ones (``ckpt.snapshot`` copies them to the host)."""
    tree: dict = {}
    per_layer: dict[str, dict[int, torch.Tensor]] = {}
    for name, t in state.items():
        if name.startswith("layers."):
            i, rest = name[len("layers."):].split(".", 1)
            per_layer.setdefault(rest, {})[int(i)] = t.detach()
        else:
            _insert(tree, name.split("."), t.detach())
    for rest, by_layer in per_layer.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"layers of {rest!r} are not 0..n-1: "
                             f"{sorted(by_layer)}")
        _insert(tree, ["layers", *rest.split(".")],
                torch.stack([by_layer[i] for i in range(len(by_layer))]))
    return tree


def _insert(tree: dict, path: list, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf
