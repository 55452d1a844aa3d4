"""Parameters of the JAX package -> the port's module state.

The JAX graph model and the JAX LMs keep their parameters as a nested
dict with the per-layer leaves stacked on a leading ``layers`` axis, the
hybrid's per-period leaves on a leading ``periods`` axis
(``nn/param.stack`` in the reference); an LM's leading dense layers
(``dense_layer_<i>``) are not stacked. :func:`params_from_jax` takes such
a tree with numpy leaves (``jax.tree.map(np.asarray, params)``) and
returns the flat state dict of
:class:`repro_torch.core.graph_model.GraphModel`,
:class:`repro_torch.models.lm.LMModel`,
:class:`repro_torch.models.api.SSMLMModel` or
:class:`repro_torch.models.hybrid.HybridLMModel`, with the stacked axis
unstacked into ``layers.<i>.*`` or ``periods.<i>.*`` entries.
:func:`params_to_jax` is its inverse: the
port's state dict back to the reference's nested tree, the layout of the
``params`` and optimizer-moment subtrees of the checkpoints both packages
write.
"""

from __future__ import annotations

import numpy as np
import torch

STACKED = ("layers", "periods")   # top-level keys with a stacked axis


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
        top, _, rest = name.partition(".")
        if top in STACKED:
            for i in range(arr.shape[0]):
                state[f"{top}.{i}.{rest}"] = torch.from_numpy(
                    np.ascontiguousarray(arr[i]))
        else:
            state[name] = torch.from_numpy(arr)
    return state


def params_to_jax(state: dict) -> dict:
    """``{name: tensor}`` (``named_parameters``, or the optimizer's
    moments under the same names) -> the reference's nested tree:
    ``layers.<i>.*`` and ``periods.<i>.*`` entries stacked on a leading
    ``layers`` or ``periods`` axis, every other name split on ``.`` into
    nested dicts. Dtypes and devices are kept; stacked leaves are new
    tensors, the others detached views of the given ones
    (``ckpt.snapshot`` copies them to the host)."""
    tree: dict = {}
    stacked: dict[tuple, dict[int, torch.Tensor]] = {}
    for name, t in state.items():
        top, _, rest = name.partition(".")
        if top in STACKED:
            i, rest = rest.split(".", 1)
            stacked.setdefault((top, rest), {})[int(i)] = t.detach()
        else:
            _insert(tree, name.split("."), t.detach())
    for (top, rest), by_index in stacked.items():
        if sorted(by_index) != list(range(len(by_index))):
            raise ValueError(f"{top} of {rest!r} are not 0..n-1: "
                             f"{sorted(by_index)}")
        _insert(tree, [top, *rest.split(".")],
                torch.stack([by_index[i] for i in range(len(by_index))]))
    return tree


def _insert(tree: dict, path: list, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf
