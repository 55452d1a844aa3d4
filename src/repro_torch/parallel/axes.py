"""Logical-axis sharding context, the port of ``repro.parallel.axes``.

Model code annotates activations with *logical* axis names::

    h = logical(h, "batch", "seq_outer", "embed", full=(B, S, D))

Inside an ``axis_rules(recipe, mesh)`` context the port has no GSPMD to
hand the annotation to: every rank already holds its own shard (one
process a rank), so ``logical`` checks that the tensor's local shape is
the shard the recipe and the mesh give the global shape ``full`` (an
axis mapped onto mesh axes whose sizes divide it is split by their
product, any other stays whole, the reference's ``fit_spec`` rule), and
raises on a mismatch. Outside any context it is the identity, so the
same model code runs on one device.

``model_group()`` is the context mesh's "model" process group (None
outside a context or on a size-1 axis): the group a serving mesh splits
heads over and expert parallelism splits experts over. ``seq_group()``
is that group when the recipe also shards the sequence over it
("seq_outer" on "model"): the model code's question of whether its
sequence is sharded, and over which group. A recipe whose sequence
cannot split keeps it whole (``parallel.sharding.fit_sequence``), and
every rank then runs the whole sequence.
``mesh_group()`` spans every rank of the mesh: a loss is the mean over
all of their shards.
"""

from __future__ import annotations

import contextlib
import math

import torch.distributed as dist

# process-wide, not thread-local as in the reference: on the card the
# backward (and a checkpointed layer's recomputation inside it) runs on
# autograd's device thread, which must see the context the forward saw
_STATE = {"ctx": None}


def current():
    return _STATE["ctx"]


@contextlib.contextmanager
def axis_rules(recipe, mesh):
    prev = current()
    _STATE["ctx"] = (recipe, mesh)
    try:
        yield
    finally:
        _STATE["ctx"] = prev


def mesh_shape(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh`` (or of a dict of sizes)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _mapped_size(mapping, shape: dict) -> int:
    if mapping is None:
        return 1
    names = (mapping,) if isinstance(mapping, str) else mapping
    size = 1
    for n in names:
        size *= shape.get(n, 1)
    return size


def logical(x, *axes, full=None):
    """Check ``x``'s local shape against the context's recipe and mesh for
    the global shape ``full`` (rank only when ``full`` is None); returns
    ``x``."""
    ctx = current()
    if ctx is None:
        return x
    recipe, mesh = ctx
    if x.ndim != len(axes):
        raise ValueError(f"rank {x.ndim} != axes {axes}")
    if full is None:
        return x
    shape = mesh_shape(mesh)
    want = []
    for a, n in zip(axes, full):
        size = _mapped_size(recipe.acts.get(a), shape)
        want.append(n // size if size > 1 and n % size == 0 else n)
    if tuple(x.shape) != tuple(want):
        raise ValueError(
            f"local shape {tuple(x.shape)} of axes {axes} is not the shard "
            f"{tuple(want)} of global {tuple(full)} under recipe "
            f"{recipe.name!r} on mesh {shape}")
    return x


def mesh_axis_size(*logical_axes) -> int:
    """Product of mesh-axis sizes currently mapped to these activation axes
    (1 outside a context)."""
    ctx = current()
    if ctx is None:
        return 1
    recipe, mesh = ctx
    shape = mesh_shape(mesh)
    size = 1
    for a in logical_axes:
        size *= _mapped_size(recipe.acts.get(a), shape)
    return size


def model_group():
    """The context mesh's "model" process group (the sequence is sharded
    over it), or None."""
    ctx = current()
    if ctx is None or mesh_shape(ctx[1]).get("model", 1) <= 1:
        return None
    return ctx[1].get_group("model")


def seq_group():
    """The group this rank's sequence is a shard over: the "model" group
    when the context's recipe maps "seq_outer" onto it, else None."""
    ctx = current()
    if ctx is None or ctx[0].acts.get("seq_outer") != "model":
        return None
    return model_group()


def mesh_group():
    """The group of every rank of the context mesh (its losses are means
    over all of them), or None outside a context or on one rank."""
    ctx = current()
    if ctx is None or math.prod(mesh_shape(ctx[1]).values()) <= 1:
        return None
    return dist.group.WORLD
