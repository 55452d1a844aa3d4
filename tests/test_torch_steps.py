"""The sweep's cells and what a rank holds in them (``repro_torch.launch
.steps``, ``configs.cells``, ``models.api.batch_spec``), against the JAX
reference on the same configs: equal, not close.

The reference side builds its full-width parameter definitions, which
allocate nothing, and its shardings on a ``jax.sharding.AbstractMesh``
of the production shapes, which needs no devices; the port's side takes
a dict of the same sizes. Nothing here traces a step (that is
``test_torch_dryrun.py``), so the file runs in a few seconds.
"""

import math

import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.launch import steps as tst
from repro_torch.models.api import batch_spec
from repro_torch.parallel import sharding as tsh

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _abstract(tag):
    from jax.sharding import AbstractMesh

    shape, names = MESHES[tag]
    return AbstractMesh(shape, names)


def _sizes(tag):
    shape, names = MESHES[tag]
    return dict(zip(names, shape))


def _at(tree, path):
    """The leaf of a nested dict at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def _jdtype(dt):
    import jax.numpy as jnp

    return {jnp.dtype(jnp.int32): torch.int32,
            jnp.dtype(jnp.bfloat16): torch.bfloat16,
            jnp.dtype(jnp.float32): torch.float32}[jnp.dtype(dt)]


def test_cells_shapes_and_arch_lists_equal_the_reference():
    from repro import configs as jcfg

    assert tcfg.ASSIGNED_ARCHS == jcfg.ASSIGNED_ARCHS
    assert tcfg.PAPER_ARCHS == jcfg.PAPER_ARCHS
    assert tcfg.ALL_ARCHS == jcfg.ALL_ARCHS
    assert list(tcfg.SHAPES) == list(jcfg.SHAPES)
    for name, s in tcfg.SHAPES.items():
        j = jcfg.SHAPES[name]
        assert (s.name, s.kind, s.seq_len, s.global_batch, s.is_train) == \
            (j.name, j.kind, j.seq_len, j.global_batch, j.is_train)
    assert tcfg.cells() == jcfg.cells()
    assert len(tcfg.cells()) == 40
    sub = (["qwen3_0_6b", "mamba2_2_7b"], ["long_500k", "train_4k"])
    assert tcfg.cells(*sub) == jcfg.cells(*sub)


@pytest.mark.parametrize("arch", tcfg.ALL_ARCHS)
def test_dtype_picks_and_params_equal_the_reference(arch):
    from repro.configs import get_config
    from repro.launch import steps as jst
    from repro.models import build

    model = build(get_config(arch))
    cfg = tcfg.get_config(arch)
    assert tst.n_params(cfg) == model.n_params()
    assert tst.pick_state_dtype(cfg) == jst.pick_state_dtype(model)
    assert tst.pick_param_dtype(cfg) == jst.pick_param_dtype(model)


@pytest.mark.parametrize("arch", tcfg.ALL_ARCHS)
def test_param_defs_equal_the_reference_leaf_by_leaf(arch):
    """Names, stacked shapes and logical axes of every parameter leaf."""
    from repro.configs import get_config
    from repro.models import build
    from repro.nn import param as nnp

    want = {".".join(map(str, p)): (tuple(d.shape), tuple(d.axes))
            for p, d in nnp._walk(build(get_config(arch)).param_defs)}
    got = {n: (s, a) for n, s, a in tst.param_defs(tcfg.get_config(arch))}
    assert got == want


def test_batch_spec_equals_the_reference_for_every_cell():
    from repro.configs import SHAPES, get_config
    from repro.models import batch_spec as jbatch_spec

    for arch, shape, _ in tcfg.cells():
        want = jbatch_spec(get_config(arch), SHAPES[shape])
        got = batch_spec(tcfg.get_config(arch), tcfg.SHAPES[shape],
                         device="meta")
        assert list(got) == list(want), (arch, shape)
        for k, t in got.items():
            assert tuple(t.shape) == tuple(want[k].shape), (arch, shape, k)
            assert t.dtype == _jdtype(want[k].dtype), (arch, shape, k)


# leaves that cover every rule of fit_spec: divisible dims, a dim that
# no mesh axis divides (9 heads, 3 kv heads, 49152 / 512 = 96 rows), a
# tuple of mesh axes of which only some divide, an axis used twice (the
# first dim keeps it), an unmapped axis and a scalar
LEAVES = [
    ((576, 9, 64), ("embed", "heads", "head_dim")),
    ((30, 576, 3, 64), ("layers", "embed", "kv_heads", "head_dim")),
    ((49152, 576), ("vocab", "embed")),
    ((96, 1536), ("vocab", "mlp")),
    ((8, 1024, 16, 64), ("batch", "kv_seq", "kv_heads", "head_dim")),
    ((1, 524288, 3, 64), ("batch", "kv_seq", "kv_heads", "head_dim")),
    ((48, 4096), ("batch", "seq_outer")),
    ((128, 7), (None, "classes")),
    ((), ()),
]


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("kind", ["train", "prefill", "decode", "long"])
def test_local_shape_equals_the_reference_fit_spec(tag, kind):
    """``local_shape`` against ``NamedSharding(mesh, fit_spec(...))
    .shard_shape`` under the recipe's params and acts, for the leaves
    above and for every parameter leaf of SmolLM and Qwen3-235B-A22B."""
    from jax.sharding import NamedSharding
    from repro.nn import param as nnp
    from repro.parallel.sharding import recipe_for as jrecipe_for

    from repro.configs import ShapeConfig as JShape

    B = 1 if kind == "long" else 8
    jshape = JShape("s", "decode" if kind == "long" else kind, 4096, B)
    mesh, sizes = _abstract(tag), _sizes(tag)
    jr = jrecipe_for(jshape, mesh)
    tr = tsh.recipe_for(tcfg.ShapeConfig("s", jshape.kind, 4096, B), sizes)
    assert tr.name == jr.name
    leaves = list(LEAVES)
    for arch in ("smollm_135m", "qwen3_moe_235b_a22b"):
        leaves += [(s, a) for _, s, a in tst.param_defs(
            tcfg.get_config(arch))]
    for rules, jrules in ((tr.params, jr.params), (tr.acts, jr.acts)):
        for shape, axes in leaves:
            mapped = tuple(None if a is None else jrules.get(a)
                           for a in axes)
            spec = nnp.fit_spec(shape, mapped, mesh)
            want = NamedSharding(mesh, spec).shard_shape(shape)
            assert tst.local_shape(shape, axes, rules, sizes) == \
                tuple(want), (tag, kind, shape, axes)
            assert tsh.fit_spec(shape, mapped, sizes) == tuple(spec)


@pytest.mark.parametrize("arch", ["qwen3_4b", "qwen3_moe_235b_a22b",
                                  "kimi_k2_1t_a32b"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_state_bytes_recipe_equals_the_reference(arch, shape):
    """A dense arch, a MoE and one of >= 100B parameters: the reference's
    state (``train_state_defs`` to train, the bf16 serve weights
    otherwise) summed over ``state_shardings`` on both meshes."""
    import jax.numpy as jnp
    from repro.configs import SHAPES, get_config
    from repro.launch import steps as jst
    from repro.models import build
    from repro.nn import param as nnp
    from repro.parallel.sharding import recipe_for as jrecipe_for

    model = build(get_config(arch))
    for tag in MESHES:
        mesh, sizes = _abstract(tag), _sizes(tag)
        jr = jrecipe_for(SHAPES[shape], mesh)
        defs = jst.train_state_defs(model) if shape == "train_4k" \
            else jst._bf16_params(model.param_defs)
        shards = jst.state_shardings(defs, jr, mesh)
        want = sum(math.prod(_at(shards, p).shard_shape(d.shape))
                   * jnp.dtype(d.dtype).itemsize
                   for p, d in nnp._walk(defs))
        tr = tsh.recipe_for(tcfg.SHAPES[shape], sizes)
        got = tst.state_bytes_recipe(tcfg.get_config(arch),
                                     tcfg.SHAPES[shape], tr, sizes)
        assert got == want, (arch, shape, tag)


@pytest.mark.parametrize("arch", ["smollm_135m", "jamba_v0_1_52b",
                                  "seamless_m4t_medium", "kimi_k2_1t_a32b",
                                  "mamba2_2_7b"])
def test_cache_bytes_recipe_equals_the_reference(arch):
    """The port's caches at the whole mesh's shapes under
    ``cache_shardings``' rule, against the reference's cache defs summed
    over ``cache_shardings`` (every family's cache tree)."""
    import jax.numpy as jnp
    from repro.configs import SHAPES, get_config
    from repro.launch import steps as jst
    from repro.models import build
    from repro.nn import param as nnp
    from repro.parallel.sharding import recipe_for as jrecipe_for

    from repro_torch import fake
    from repro_torch.models.api import lm_model_class

    cfg = tcfg.get_config(arch)
    for shape in ("decode_32k", "long_500k"):
        s = tcfg.SHAPES[shape]
        with fake.mode():
            model = lm_model_class(cfg)(cfg, device="cpu")
            cache = model.cache_defs(s.global_batch, s.seq_len)
        jmodel = build(get_config(arch))
        c_defs = jmodel.cache_defs(s.global_batch, s.seq_len)
        for tag in MESHES:
            mesh, sizes = _abstract(tag), _sizes(tag)
            jr = jrecipe_for(SHAPES[shape], mesh)
            shards = jst.cache_shardings(c_defs, jr, mesh)
            want = sum(math.prod(_at(shards, p).shard_shape(d.shape))
                       * jnp.dtype(d.dtype).itemsize
                       for p, d in nnp._walk(c_defs))
            got = tst.cache_bytes_recipe(
                cache, tsh.recipe_for(s, sizes), sizes)
            assert got == want, (arch, shape, tag)


def test_rank_batch_is_the_ports_runtime_shard():
    """The rank's batch: the recipe's local shapes (int64 ids), the VLM's
    tokens the rank's share of its Tp + T positions, decode one token a
    row, and the 1 x 1 mesh the whole batch."""
    sizes = _sizes("16x16")
    train = tcfg.SHAPES["train_4k"]
    r = tsh.recipe_for(train, sizes)
    b = tst.rank_batch(tcfg.get_config("qwen3_0_6b"), train, r, sizes,
                       device="meta")
    assert {k: (tuple(v.shape), v.dtype) for k, v in b.items()} == {
        "tokens": ((16, 256), torch.int64),
        "labels": ((16, 256), torch.int64)}
    vlm = tcfg.get_config("internvl2_76b")
    b = tst.rank_batch(vlm, train, r, sizes, device="meta")
    assert tuple(b["patches"].shape) == (16, vlm.frontend_tokens,
                                         vlm.d_model)
    assert tuple(b["tokens"].shape) == (16, 4096 // 16)
    dec = tcfg.SHAPES["decode_32k"]
    b = tst.rank_batch(vlm, dec, tsh.recipe_for(dec, sizes), sizes,
                       device="meta")
    assert tuple(b["tokens"].shape) == (8, 1)
    long = tcfg.SHAPES["long_500k"]
    b = tst.rank_batch(vlm, long, tsh.recipe_for(long, sizes), sizes,
                       device="meta")
    assert tuple(b["tokens"].shape) == (1, 1)
    one = {"data": 1, "model": 1}
    b = tst.rank_batch(vlm, train, tsh.recipe_for(train, one), one,
                       device="meta")
    assert tuple(b["tokens"].shape) == (256, 4096 - vlm.frontend_tokens)


def test_traced_train_flops_match_the_reference_compiled_count():
    """Qwen3-0.6B's smoke config at train_4k's full shape (256 x 4096) on
    a 1 x 1 mesh: the port's traced ``flops_per_dev`` against the
    reference's compiled count within ``FLOPS_RTOL``, once the chunk
    pairs only the reference computes are added (``test_torch_dryrun``'s
    prefill case says why). Training counts each skipped pair 5 times:
    the forward, the layer's recomputation (``remat="block"``), the
    chunk's recomputation in the backward and its four backward
    products. 5.50e12 of the reference's 2.56e13; with them the counts
    are equal."""
    from test_torch_dryrun import _compare_flops

    try:
        got, skipped, want = _compare_flops("train_4k", 5)
    finally:
        from repro_torch.launch.dryrun import leave_fake_group
        leave_fake_group()
    assert got + skipped == want


@pytest.mark.parametrize("arch", ["smollm_135m", "jamba_v0_1_52b"])
def test_input_specs_hold_the_references_state_and_caches(arch):
    """``input_specs`` of a decode_32k cell on one rank: the bf16 serve
    weights and the caches in the same bytes as the reference's
    ``input_specs`` stand-ins (the port holds a tensor a layer where the
    reference stacks them), one int64 token a row and the position."""
    import jax
    import jax.numpy as jnp
    from repro import compat
    from repro.launch import steps as jst

    mesh = compat.make_mesh((1, 1), ("data", "model"),
                            devices=jax.devices()[:1])
    params, cache, tokens, pos = jst.input_specs(arch, "decode_32k", mesh)

    def nbytes(tree):
        return sum(math.prod(x.shape) * jnp.dtype(x.dtype).itemsize
                   for x in jax.tree_util.tree_leaves(tree))

    got = tst.input_specs(arch, "decode_32k", {"data": 1, "model": 1})
    n_params = len(list(jax.tree_util.tree_leaves(params)))
    want = nbytes(params) + nbytes(cache)
    assert sum(math.prod(s) * d.itemsize for s, d in got[:-2]) == want
    assert len(got) - 2 > n_params
    assert got[-2:] == [((128, 1), torch.int64), ((), torch.int64)]
    assert tuple(tokens.shape) == (128, 1)
