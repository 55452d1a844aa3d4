"""Parameters of the JAX package -> the port's module state.

The JAX graph model and the JAX LMs keep their parameters as a nested
dict with the per-layer leaves stacked on a leading ``layers`` axis, the
hybrid's per-period leaves on a leading ``periods`` axis, the
encoder-decoder's on ``enc_layers`` and ``dec_layers``
(``nn/param.stack`` in the reference); an LM's leading dense layers
(``dense_layer_<i>``) are not stacked. :func:`params_from_jax` takes such
a tree with numpy leaves (``jax.tree.map(np.asarray, params)``) and
returns the flat state dict of
:class:`repro_torch.core.graph_model.GraphModel`,
:class:`repro_torch.models.lm.LMModel`,
:class:`repro_torch.models.api.SSMLMModel`,
:class:`repro_torch.models.hybrid.HybridLMModel` or
:class:`repro_torch.models.encdec.EncDecModel`, with the stacked axis
unstacked into ``<stack>.<i>.*`` entries. :func:`leaf_groups` groups the
port's per-layer names by the reference leaf they make up.
:func:`params_to_jax` is its inverse: the
port's state dict back to the reference's nested tree, the layout of the
``params`` and optimizer-moment subtrees of the checkpoints both packages
write.
"""

from __future__ import annotations

import numpy as np
import torch

# top-level keys with a stacked axis: the LMs' layers, the hybrid's
# periods, the encoder-decoder's two stacks
STACKED = ("layers", "periods", "enc_layers", "dec_layers")


def _flatten(tree, prefix=""):
    for key in sorted(tree):
        val = tree[key]
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def _tensor(arr, dtype) -> torch.Tensor:
    """A host copy of a numpy (``ml_dtypes`` bf16 included) or torch leaf,
    cast to ``dtype`` (``None`` keeps the leaf's)."""
    if torch.is_tensor(arr):
        t = arr.detach().to("cpu", copy=True)
    elif np.asarray(arr).dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr, copy=True).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t if dtype is None else t.to(dtype)


def params_from_jax(tree: dict, dtype=torch.float32) -> dict:
    """Nested parameter tree (numpy or torch leaves) -> ``{name: tensor}``
    for the ``load_state_dict`` of any of the port's models, in ``dtype``
    (``None`` keeps each leaf's: the optimizer's bf16 moments). Arrays
    are copied, so read-only views of JAX buffers are fine."""
    state = {}
    for name, arr in _flatten(tree):
        t = _tensor(arr, dtype)
        top, _, rest = name.partition(".")
        if top in STACKED:
            for i in range(t.shape[0]):
                state[f"{top}.{i}.{rest}"] = t[i]
        else:
            state[name] = t
    return state


def leaf_name(name: str) -> tuple[str, int]:
    """A port parameter's reference leaf and its index on the leaf's
    stacked axis: ``layers.3.attn.wq`` -> ``("layers.attn.wq", 3)``,
    ``embed.tok`` -> ``("embed.tok", 0)``."""
    top, _, rest = name.partition(".")
    if top in STACKED:
        i, rest = rest.split(".", 1)
        return f"{top}.{rest}", int(i)
    return name, 0


def leaf_groups(names) -> list[tuple[str, list[int]]]:
    """The port's parameter names (in order) grouped by reference leaf:
    ``(leaf, indices)``, the indices in the stacked axis's order, the
    groups in the order of their first parameter. A group's parameters,
    flattened and concatenated, are the C-order flatten of the
    reference's leaf (the unit of its int8 moments)."""
    groups: dict[str, dict[int, int]] = {}
    for k, name in enumerate(names):
        leaf, i = leaf_name(name)
        groups.setdefault(leaf, {})[i] = k
    return [(leaf, [by_i[i] for i in sorted(by_i)])
            for leaf, by_i in groups.items()]


def params_to_jax(state: dict) -> dict:
    """``{name: tensor}`` (``named_parameters``, or the optimizer's
    moments under the same names) -> the reference's nested tree:
    ``layers.<i>.*`` and ``periods.<i>.*`` entries stacked on a leading
    ``layers`` or ``periods`` axis, every other name split on ``.`` into
    nested dicts. Dtypes and devices are kept; stacked leaves are new
    tensors, the others detached views of the given ones
    (``ckpt.snapshot`` copies them to the host)."""
    tree: dict = {}
    stacked: dict[str, dict[int, torch.Tensor]] = {}
    for name, t in state.items():
        leaf, i = leaf_name(name)
        if leaf == name:
            insert(tree, name, t.detach())
        else:
            stacked.setdefault(leaf, {})[i] = t.detach()
    for leaf, by_index in stacked.items():
        if sorted(by_index) != list(range(len(by_index))):
            raise ValueError(f"{leaf!r}'s layers are not 0..n-1: "
                             f"{sorted(by_index)}")
        insert(tree, leaf,
               torch.stack([by_index[i] for i in range(len(by_index))]))
    return tree


def insert(tree: dict, leaf: str, value) -> None:
    """Put ``value`` at the dotted path ``leaf`` of a nested tree."""
    _insert(tree, leaf.split("."), value)


def lookup(tree: dict, leaf: str):
    """The value at the dotted path ``leaf`` of a nested tree."""
    for key in leaf.split("."):
        tree = tree[key]
    return tree


def _insert(tree: dict, path: list, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf
