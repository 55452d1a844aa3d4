"""Parameters of the JAX package -> the port's module state.

The JAX graph model and the JAX LMs keep their parameters as a nested
dict with the per-layer leaves stacked on a leading ``layers`` axis
(``nn/param.stack`` in the reference). :func:`params_from_jax` takes such
a tree with numpy leaves (``jax.tree.map(np.asarray, params)``) and
returns the flat state dict of
:class:`repro_torch.core.graph_model.GraphModel` or
:class:`repro_torch.models.lm.LMModel`, with the layer axis unstacked
into ``layers.<i>.*`` entries.
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
    """Nested numpy parameter tree -> ``{name: fp32 tensor}`` for
    ``GraphModel.load_state_dict`` or ``LMModel.load_state_dict``. Arrays
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
