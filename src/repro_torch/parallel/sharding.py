"""Sharding recipes: how logical axes map onto mesh axes, the port's
copy of ``repro.parallel.sharding`` (``Recipe``, ``recipe_for``,
``_PARAM_RULES``), equal to the reference's for every kind of shape on
single-pod (data, model) and multi-pod (pod, data, model) meshes.

The policy:

* parameters: FSDP over "data" (embed dim), TP over "model"
  (heads / mlp / vocab / experts);
* train:   batch over (pod, data); sequence sharded over "model" between
           layers ("seq_outer");
* prefill: batch over data, sequence over model: Ulysses a2a inside
           attention (the paper's graph parallelism, §III-C);
* decode:  batch over data, KV-cache sequence over model;
* long:    batch=1 -> sequence over (data, model) [+pod].

The port applies ``acts`` (the activations' sequence over "model", the
batch over "data") and ``ulysses``; ``params`` is kept as data and not
applied: every rank holds every parameter whole (the results are the
same, only the memory differs).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from repro_torch.parallel.axes import mesh_shape

# Parameter logical axes (see models/*.py):
#   embed, mlp, heads, kv_heads, head_dim, qkv, vocab, experts, expert_mlp,
#   layers, inner (ssm), state, conv, classes
_PARAM_RULES: dict[str, Any] = {
    "embed": ("pod", "data"),  # FSDP / ZeRO-3 shard (pod axis included:
                               # params must keep sharding down at 2+ pods)
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",       # expert parallelism
    "expert_mlp": None,
    "inner": "model",         # ssm d_inner
    "state": None,
    "conv": None,
    "layers": None,
    "classes": None,
    "bias_heads": None,
    "degree": None,
    "spd": None,
}


@dataclasses.dataclass(frozen=True)
class Recipe:
    name: str
    params: Mapping[str, Any]
    acts: Mapping[str, Any]
    ulysses: bool = False     # explicit a2a sequence parallelism in attention
    pp_stages: int = 1

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _acts(kind: str, multi_pod: bool) -> dict[str, Any]:
    dp = ("pod", "data") if multi_pod else ("data",)
    if kind == "train":
        return {
            "batch": dp, "seq": None, "seq_outer": "model",
            "embed": None, "heads": "model", "kv_heads": "model",
            "head_dim": None, "mlp": "model", "vocab": "model",
            "experts": "model", "kv_seq": None, "inner": "model",
            "state": None, "classes": None,
        }
    if kind == "prefill":
        return {
            "batch": dp, "seq": "model", "seq_outer": "model",
            "embed": None, "heads": "model", "kv_heads": "model",
            "head_dim": None, "mlp": "model", "vocab": "model",
            "experts": "model", "kv_seq": "model", "inner": "model",
            "state": None, "classes": None,
        }
    if kind == "decode":
        return {
            "batch": dp, "seq": None, "seq_outer": None,
            "embed": None, "heads": "model", "kv_heads": "model",
            "head_dim": None, "mlp": "model", "vocab": "model",
            "experts": "model", "kv_seq": "model", "inner": "model",
            "state": None, "classes": None,
        }
    if kind == "long":  # batch too small to shard; sequence everywhere
        seq = ("pod", "data", "model") if multi_pod else ("data", "model")
        return {
            "batch": None, "seq": seq, "seq_outer": seq,
            "embed": None, "heads": "model", "kv_heads": "model",
            "head_dim": None, "mlp": "model", "vocab": "model",
            "experts": "model", "kv_seq": seq, "inner": "model",
            "state": None, "classes": None,
        }
    raise ValueError(kind)


def recipe_for(shape_cfg, mesh, *, ulysses: bool | None = None) -> Recipe:
    """The recipe for ``shape_cfg`` on ``mesh`` (a ``DeviceMesh`` from
    ``launch/mesh.py`` or a dict of axis sizes)."""
    multi_pod = "pod" in mesh_shape(mesh)
    kind = shape_cfg.kind
    if kind == "decode" and shape_cfg.global_batch == 1:
        kind = "long"
    if ulysses is None:
        # a2a sequence parallelism for training too (the reference's
        # default: its collective term beat the all-gather pattern)
        ulysses = kind in ("prefill", "train")
    return Recipe(
        name=f"{kind}{'_mp' if multi_pod else ''}"
             f"{'_ulysses' if ulysses else ''}",
        params=dict(_PARAM_RULES),
        acts=_acts(kind, multi_pod),
        ulysses=ulysses,
    )


def fit_sequence(recipe: Recipe, mesh, seq_len: int) -> Recipe:
    """``recipe`` with the sequence kept whole ("seq" and "seq_outer"
    mapped onto no mesh axis) when ``seq_len`` does not split over the
    mesh axes "seq_outer" maps to: the reference's ``fit_spec`` rule,
    under which GSPMD then runs every op on the whole sequence. Any
    other recipe is returned as it is."""
    size = 1
    names = recipe.acts.get("seq_outer") or ()
    for n in (names,) if isinstance(names, str) else names:
        size *= mesh_shape(mesh).get(n, 1)
    if size <= 1 or seq_len % size == 0:
        return recipe
    return recipe.replace(name=recipe.name + "_seq_whole",
                          acts={**recipe.acts, "seq": None,
                                "seq_outer": None})


def fit_spec(shape, axes_map, mesh) -> tuple:
    """The port's copy of the reference's ``nn.param.fit_spec``: mapped
    mesh axes (per dim None, a mesh axis name or a tuple of them) turned
    into a partition spec (a tuple of the same kinds of entries), each
    mesh axis kept only where its size, times the sizes kept before it
    for that dim, divides the dim, and used for one dim only (the first
    that keeps it). ``mesh`` is a ``DeviceMesh`` or a dict of sizes."""
    sizes = mesh_shape(mesh)
    out, used = [], set()
    for dim, m in zip(shape, axes_map):
        if m is None:
            out.append(None)
            continue
        keep, sz = [], 1
        for name in (m,) if isinstance(m, str) else tuple(m):
            if name not in sizes or name in used:
                continue
            if dim % (sz * sizes[name]) == 0:
                keep.append(name)
                sz *= sizes[name]
        used.update(keep)
        out.append(None if not keep else keep[0] if len(keep) == 1
                   else tuple(keep))
    return tuple(out)


def shard_shape(shape, spec, mesh) -> tuple:
    """The per-rank shape of a ``shape`` partitioned by ``spec``
    (:func:`fit_spec`'s) on ``mesh``: each dim divided by the sizes of
    its mesh axes (``NamedSharding.shard_shape``)."""
    sizes = mesh_shape(mesh)
    out = []
    for dim, m in zip(shape, tuple(spec) + (None,) * len(shape)):
        for name in () if m is None else (m,) if isinstance(m, str) else m:
            dim //= sizes[name]
        out.append(dim)
    return tuple(out)
