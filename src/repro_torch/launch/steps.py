"""The steps of the fit-and-roofline sweep and the cells they run in, the
port of ``repro.launch.steps``.

A cell is one arch at one input shape (``configs.SHAPES``) on one mesh.
:func:`build_cell` builds everything one rank of the mesh holds for its
step, as the port's runtime holds it, and the step itself:

* train: the model's parameters (bf16 for archs of 100B parameters or
  more, :func:`pick_param_dtype`), ``AdamW`` with
  ``warmup_cosine(3e-4, 100, 10_000)`` and moments of
  :func:`pick_state_dtype`'s dtype (:func:`train_state`), and the rank's
  batch; the step (:func:`make_train_step`) takes the loss, the
  gradients, their sum over the mesh (the Trainer's reduction) and the
  update in place, the port's counterpart of the reference's donated
  state;
* prefill: serve-time bf16 weights and the rank's prompts; the step
  (:func:`make_prefill_step`) returns the logits and the caches, each
  rank's caches holding its own positions (``lm_prefill``'s
  ``shard_kv``);
* decode: bf16 weights, the caches and one token a sequence; the step
  (:func:`make_decode_step`) writes the caches in place. ``long_500k``
  decodes under the TorchGT cluster-sparse mask for every family but
  the SSM and the hybrid (the cell's ``note``).

What a rank holds is the port's runtime's layout, which differs from the
reference's recipe: parameters and moments are whole on every rank
(``parallel/sharding.py``: ``Recipe.params`` is kept as data), an
expert stack holds the rank's experts only on a model axis
(``models/moe.py``), the batch is split over the data axes and, to train
and prefill, the sequence over "model" (the VLM's tokens are the rank's
share of its Tp + T positions, ``tasks/base.BatchFnTask``), and the
decode caches keep the whole sequence of the rank's batch rows: the
port's contiguous decode has no sequence-sharded form. :func:`local_shape`
(the reference's ``fit_spec`` through ``state_shardings``,
``batch_shardings`` and ``cache_shardings``) gives the recipe's
per-rank shapes for the record (:func:`state_bytes_recipe`), not for
the runtime.

Build a full-width cell under a fake mode (``repro_torch.fake``, as
``launch/dryrun.py`` does): nothing is allocated. On real tensors the
batch is uninitialised (:func:`fill_batch` draws it) and the model takes
its seeded init.
"""

from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.launch.roofline import family_defs
from repro_torch.models.api import batch_spec, lm_model_class
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.parallel import axes as pax
from repro_torch.parallel.sharding import (fit_spec, recipe_for,
                                           shard_shape)
from repro_torch.runtime.trainer import reduce_gradients

LR = 3e-4
BF16_FROM = 100e9       # parameters from which state and weights are bf16

# the logical axes of a parameter by its last name, and for the FFN
# stacks by their rank too (an MLP's (D, F) or the experts' (E, D, F)):
# the reference's ParamDef axes; a stacked entry adds "layers" in front
_LEAF_AXES = {
    "tok": ("vocab", "embed"), "unembed": ("embed", "vocab"),
    "scale": ("embed",), "q_norm": ("head_dim",), "k_norm": ("head_dim",),
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    ("w_gate", 2): ("embed", "mlp"), ("w_up", 2): ("embed", "mlp"),
    ("w_down", 2): ("mlp", "embed"),
    ("w_gate", 3): ("experts", "embed", "expert_mlp"),
    ("w_up", 3): ("experts", "embed", "expert_mlp"),
    ("w_down", 3): ("experts", "expert_mlp", "embed"),
    "router": ("embed", None),
    "a_log": ("heads",), "d_skip": ("heads",), "dt_bias": ("heads",),
    "conv_b": ("inner",), "norm": ("inner",), "conv_w": ("conv", "inner"),
    "in_proj": ("embed", "inner"), "out_proj": ("inner", "embed"),
    "feat_proj": (None, "embed"), "pe_proj": (None, "embed"),
    "w": (None, "embed"), "global_tok": (None, "embed"),
    "head": ("embed", "classes"), "bias_table": ("bias_heads", None),
    "z_in": ("degree", "embed"), "z_out": ("degree", "embed"),
}
# the logical axes of a decode cache by its last name (the reference's
# cache defs): self-attention k/v, cross-attention ck/cv, Mamba states
_CACHE_AXES = {
    "k": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "ck": ("batch", None, "kv_heads", "head_dim"),
    "cv": ("batch", None, "kv_heads", "head_dim"),
    "conv": (None, None, "inner"),
    "ssm": (None, "heads", None, None),
}
# the batch's logical axes, by kind of step
_BATCH_AXES = {"tokens": ("batch", "seq_outer"),
               "labels": ("batch", "seq_outer"),
               "patches": ("batch", None, None),
               "frames": ("batch", None, None)}


def param_defs(cfg) -> list:
    """``[(name, shape, axes)]`` of every parameter leaf of ``cfg``'s
    model as the reference stacks it: a per-layer entry with the stack's
    length in front and ``"layers"`` before its axes."""
    defs, stacks = family_defs(cfg)
    out = []
    for name, (shape, _) in defs.items():
        leaf = name.rsplit(".", 1)[-1]
        axes = _LEAF_AXES.get((leaf, len(shape))) or _LEAF_AXES[leaf]
        n = stacks.get(name.split(".", 1)[0])
        if n is not None:
            shape, axes = (n, *shape), ("layers", *axes)
        out.append((name, tuple(shape), tuple(axes)))
    return out


def n_params(cfg) -> int:
    """Parameters of ``cfg``'s model, counted from its definitions."""
    return sum(math.prod(shape) for _, shape, _ in param_defs(cfg))


def pick_state_dtype(cfg) -> str:
    """bf16 AdamW moments for archs of 100B parameters or more (halves the
    optimizer's memory, standard at that scale); fp32 otherwise."""
    return "bfloat16" if n_params(cfg) >= BF16_FROM else "float32"


def pick_param_dtype(cfg) -> str:
    """bf16 live parameters for archs of 100B parameters or more; fp32
    otherwise (cheap, better numerics)."""
    return "bfloat16" if n_params(cfg) >= BF16_FROM else "float32"


def local_shape(shape, axes, rules, mesh) -> tuple:
    """The per-rank shape of a leaf of ``shape`` and logical ``axes`` under
    ``rules`` (a recipe's ``params`` or ``acts``) on ``mesh`` (a
    ``DeviceMesh`` or a dict of sizes): the reference's ``fit_spec`` and
    ``NamedSharding.shard_shape``."""
    mapped = tuple(None if a is None else rules.get(a) for a in axes)
    return shard_shape(shape, fit_spec(shape, mapped, mesh), mesh)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def state_bytes_recipe(cfg, shape: ShapeConfig, recipe, mesh) -> int:
    """The per-rank bytes of the cell's state under ``recipe.params``:
    the parameters (bf16 to serve, :func:`pick_param_dtype` to train),
    and to train the two AdamW moments of :func:`pick_state_dtype` and
    the reference's two int32 step counters; the reference's bytes
    summed over ``state_shardings``."""
    train = shape.kind == "train"
    p_dt = getattr(torch, pick_param_dtype(cfg) if train else "bfloat16")
    m_dt = getattr(torch, pick_state_dtype(cfg))
    total = 0
    for _, full, axes in param_defs(cfg):
        local = local_shape(full, axes, recipe.params, mesh)
        total += _nbytes(local, p_dt)
        if train:
            total += 2 * _nbytes(local, m_dt)
    return total + (8 if train else 0)


def cache_leaves(tree: dict, prefix: str = ""):
    """``(name, tensor)`` of every leaf of a cache tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from cache_leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def cache_axes(name: str, ndim: int) -> tuple:
    """A cache leaf's logical axes (``"layers"`` in front of a stacked
    one)."""
    axes = _CACHE_AXES[name.rsplit(".", 1)[-1]]
    return ("layers",) * (ndim - len(axes)) + axes


def cache_bytes_recipe(cache: dict, recipe, mesh) -> int:
    """The per-rank bytes of the whole-mesh caches ``cache`` (leaves of
    the global shapes) under ``recipe.acts``, the reference's
    ``cache_shardings``."""
    return sum(_nbytes(local_shape(tuple(t.shape), cache_axes(n, t.dim()),
                                   recipe.acts, mesh), t.dtype)
               for n, t in cache_leaves(cache))


def rank_batch(cfg, shape: ShapeConfig, recipe, mesh, *,
               device="cuda") -> dict:
    """This rank's share of :func:`models.api.batch_spec`'s batch as the
    port's runtime feeds it: split by the recipe's "batch" and, to train
    and prefill, "seq_outer" axes (``local_shape``), ints as int64. The
    VLM's tokens and labels on a sharded sequence are the rank's share of
    its Tp + T positions."""
    glob = batch_spec(cfg, shape, device="meta")
    S = shape.seq_len
    seq_sharded = local_shape((S,), ("seq_outer",), recipe.acts, mesh) \
        != (S,)
    out = {}
    for name, t in glob.items():
        full = tuple(t.shape)
        if shape.kind == "decode":
            axes = ("batch", None)
        else:
            axes = _BATCH_AXES[name]
            if cfg.family == "vlm" and name in ("tokens", "labels") \
                    and seq_sharded:
                full = (full[0], S)
        dtype = torch.int64 if not t.dtype.is_floating_point else t.dtype
        out[name] = torch.empty(local_shape(full, axes, recipe.acts, mesh),
                                dtype=dtype, device=device)
    return out


def fill_batch(cfg, batch: dict, *, seed: int = 0) -> dict:
    """Draw a real batch in place from ``seed``: token ids and labels in
    ``[0, vocab_size)``, patches and frames from a normal; returns it."""
    gen = torch.Generator(device=next(iter(batch.values())).device)
    gen.manual_seed(seed)
    for t in batch.values():
        if t.dtype.is_floating_point:
            t.normal_(generator=gen)
        else:
            t.random_(0, cfg.vocab_size, generator=gen)
    return batch


# ------------------------------------------------------------ step builders

def _rules(recipe, mesh):
    """The axis context of a mesh of more than one rank, else none (one
    rank runs the port's single-device path)."""
    if mesh is None or math.prod(pax.mesh_shape(mesh).values()) <= 1:
        return contextlib.nullcontext()
    return pax.axis_rules(recipe, mesh)


def cast_params(model, dtype) -> None:
    """Cast ``model``'s floating parameters to ``dtype`` in place (each
    ``Parameter`` keeps its identity and attributes, such as an expert
    stack's ``expert_part``)."""
    with torch.no_grad():
        for p in model.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype)


def train_state(model, *, lr: float = LR) -> AdamW:
    """The training state of ``model``: its parameters cast to
    :func:`pick_param_dtype`'s dtype (in place of the fp32 ones) and an
    ``AdamW`` of ``warmup_cosine(lr, 100, 10_000)`` with moments of
    :func:`pick_state_dtype`'s dtype; returns the optimizer."""
    cfg = model.cfg
    if pick_param_dtype(cfg) == "bfloat16":
        cast_params(model, torch.bfloat16)
    return AdamW(list(model.parameters()),
                 lr=warmup_cosine(lr, 100, 10_000),
                 state_dtype=pick_state_dtype(cfg))


def loss_and_grads(model, batch: dict, *, loss=None, impl: str | None = None,
                   recipe=None, mesh=None):
    """``(loss, metrics, grads)``: the loss (``loss``, default the model's
    ``"sparse"`` variant, called as ``loss(model, batch)``, with ``impl``
    where one is given) and the gradient of every parameter under the
    mesh's axis context (``recipe`` and ``mesh``, default the context
    already entered), a zero for one the loss does not reach (as
    ``jax.grad``), summed over the mesh's ranks
    (``runtime.trainer.reduce_gradients``, the expert stacks over "data"
    only)."""
    if mesh is None and pax.current() is not None:
        recipe, mesh = pax.current()
    loss = loss or model.loss_variants["sparse"]
    params = list(model.parameters())
    with _rules(recipe, mesh):
        value, metrics = loss(model, batch, **(
            {"impl": impl} if impl is not None else {}))
        grads = torch.autograd.grad(value, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    if mesh is not None and math.prod(pax.mesh_shape(mesh).values()) > 1:
        grads = reduce_gradients(grads, mesh, [
            getattr(p, "expert_part", None) is not None for p in params])
    return value, metrics, grads


def make_train_step(model, recipe, mesh, *, lr: float = LR, loss=None):
    """``step(batch) -> {"loss", ...metrics}``: :func:`loss_and_grads`
    on the mesh and the update in place of :func:`train_state`'s
    optimizer (the parameters cast as it casts them), which the step
    holds as ``step.opt``."""
    opt = train_state(model, lr=lr)

    def train_step(batch: dict) -> dict:
        value, metrics, grads = loss_and_grads(model, batch, loss=loss,
                                               recipe=recipe, mesh=mesh)
        opt.update(grads)
        return {"loss": value.detach(),
                **{k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}}

    train_step.opt = opt
    return train_step


def make_prefill_step(model, recipe, mesh):
    """``step(batch) -> (logits, caches)``: the model's prefill without
    grad under the mesh's axis context; on a sharded sequence each rank's
    caches hold its positions (``lm_prefill``'s ``shard_kv``)."""
    kw = {"shard_kv": True} if model.cfg.family in ("dense", "moe",
                                                     "vlm") else {}

    @torch.no_grad()
    def prefill_step(batch: dict):
        with _rules(recipe, mesh):
            return model.prefill(batch, **kw)

    return prefill_step


def make_decode_step(model, recipe, mesh, *, sparse: bool = False):
    """``step(cache, tokens, pos) -> (logits, cache)``: one decode step
    without grad under the mesh's axis context, the caches written in
    place; ``sparse`` applies the cluster-sparse decode mask."""
    @torch.no_grad()
    def serve_step(cache: dict, tokens, pos):
        with _rules(recipe, mesh):
            return model.decode(cache, tokens, pos, sparse=sparse)

    return serve_step


# ------------------------------------------------------------ cell assembly

def expert_part(cfg, mesh):
    """``experts=(m, P)`` of the model on a P-way model axis (the rank's
    expert stacks only), else None."""
    p = pax.mesh_shape(mesh).get("model", 1) if mesh is not None else 1
    if not cfg.moe_experts or p <= 1 or cfg.moe_experts % p:
        return None
    return (mesh.get_local_rank("model"), p)


def build_cell(arch: str, shape_name: str, mesh, *, overrides=None,
               ulysses=None, global_batch: int | None = None,
               device="cuda", seed: int = 0) -> dict:
    """Everything one rank holds for the step of one (arch x shape x
    mesh) cell, and the step. ``mesh``: a ``DeviceMesh`` of this
    process's group, or a dict of sizes that are all 1 (one rank, the
    single-device path). ``overrides``: config fields (the reference's);
    ``global_batch`` cuts the shape's batch. Returns ``{"cfg", "shape",
    "recipe", "model", "fn", "args", "state", "alias", "note"}``:
    ``fn(*args)`` is the step, ``state`` the tensors it holds besides
    ``args`` (parameters, moments), ``alias`` those it updates in
    place."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    if global_batch is not None:
        shape = ShapeConfig(shape.name, shape.kind, shape.seq_len,
                            global_batch)
    if isinstance(mesh, dict) and math.prod(mesh.values()) > 1:
        raise ValueError(f"a mesh of {math.prod(mesh.values())} ranks "
                         f"needs a process group and its DeviceMesh "
                         f"(launch/dryrun.run_cell joins a fake one)")
    sparse_decode = shape_name == "long_500k" and cfg.family not in (
        "ssm", "hybrid")
    recipe = recipe_for(shape, mesh, ulysses=ulysses)
    kw = {"experts": expert_part(cfg, mesh)} if cfg.moe_experts else {}
    model = lm_model_class(cfg)(cfg, device=device, seed=seed, **kw)
    batch = rank_batch(cfg, shape, recipe, mesh, device=device)
    if shape.kind == "train":
        fn = make_train_step(model, recipe, mesh)
        args = (batch,)
        state = list(model.parameters()) + fn.opt.state_tensors()
        alias = state
    else:
        cast_params(model, torch.bfloat16)      # serve-time weights
        state = list(model.parameters())
        if shape.kind == "prefill":
            fn = make_prefill_step(model, recipe, mesh)
            args, alias = (batch,), []
        else:
            fn = make_decode_step(model, recipe, mesh, sparse=sparse_decode)
            rows = batch["tokens"].shape[0]
            cache = model.cache_defs(rows, shape.seq_len)
            pos = torch.full((), shape.seq_len - 1, dtype=torch.int64,
                             device=device)
            args = (cache, batch["tokens"], pos)
            alias = [t for _, t in cache_leaves(cache)]
    return {"cfg": cfg, "shape": shape, "recipe": recipe, "model": model,
            "fn": fn, "args": args, "state": state, "alias": alias,
            "note": "attn=cluster_sparse" if sparse_decode else ""}


def input_specs(arch: str, shape_name: str, mesh, **kw) -> list:
    """``[(shape, dtype)]`` of every tensor one rank holds for the cell's
    step (state, then its arguments), built under a fake mode: the
    reference's ``input_specs`` stand-ins."""
    from repro_torch import fake

    with fake.mode():
        cell = build_cell(arch, shape_name, mesh, **kw)
        return [(tuple(t.shape), t.dtype)
                for t in cell["state"] + arg_tensors(cell["args"])]


def arg_tensors(args) -> list:
    """Every tensor of a step's arguments (the leaves of dicts)."""
    out = []
    for a in args:
        if isinstance(a, dict):
            out += [t for _, t in cache_leaves(a)]
        elif torch.is_tensor(a):
            out.append(a)
    return out
