"""The port's token serving against the JAX package, on the CPU: the block
allocator, the paged attention op, decode attention, the LM's prefill,
contiguous decode, chunked prefill and paged decode, the Mamba2 decode,
the continuous-batching ``ServeEngine`` and the serve CLI. Inputs are
seeded numpy arrays, and one JAX parameter tree loaded into the port
through ``convert.params_from_jax``.

Tolerances: fp32 layers and ops within 2e-5 (of the largest entry);
logits within 1e-4 of the largest |logit|; KV pools and caches, which
both packages keep in bf16, within one bf16 ulp of each entry plus the
fp32 layers' 2e-5 of the largest entry (the fp32 k and v they round
differ in the last fp32 bits, so a value near a rounding boundary may
round either way, and near zero the fp32 difference itself shows); token
streams, block lists and the engines' counters exact. The pools' scratch
block 0 is left out: padding rows and idle slots all write there, in an
order neither package fixes.

The decode and paged paths read the caches they write, so one entry
rounded to the other bf16 neighbour (2^-8 of itself) reaches their
logits. They run twice: with the caches cast to fp32 in both packages
(the same code path, no rounding), logits within 1e-4 and caches within
2e-5; and with the bf16 caches as served, caches within one ulp and
logits within 1e-2 of the largest |logit|.

The second half holds the port's engine to the reference's own serving
contracts (``tests/test_serve_engine.py``,
``tests/test_serve_consistency.py``) in the default bf16 smoke config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.kernels import ops as jops
from repro.models import build
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.nn import param as nnp
from repro.serve import BlockAllocator as JBlockAllocator
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops as kops
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import api as tapi
from repro_torch.models import layers as L
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.serve import (Admitted, BlockAllocator, Rejected,
                               ServeEngine)

from _hypothesis_compat import given, settings, st
from _torch_cases import t

TOL_F32 = 2e-5
TOL_LOGITS = 1e-4
TOL_LOGITS_BF16_CACHE = 1e-2
RAGGED = [5, 12, 17, 9]       # deliberately not multiples of chunk/page
# a window and sink count that bind at the smoke engine's lengths
SPARSE_KW = dict(window=8, n_global=2)


def _np(x) -> np.ndarray:
    """A JAX or torch array as fp32 numpy."""
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def assert_bf16_close(a, b, drop_block0: bool = False):
    """Entry by entry within one bf16 ulp of the larger magnitude, plus
    TOL_F32 of the largest entry."""
    a, b = _np(a), _np(b)
    if drop_block0:
        a, b = a[:, 1:], b[:, 1:]
    assert a.shape == b.shape
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    err = np.abs(a - b) - ulp
    assert (err <= TOL_F32 * np.abs(b).max()).all(), float(err.max())


def _cfgs(arch="qwen3_0_6b", **kw):
    return (get_smoke_config(arch).replace(**kw),
            jcfgs.get_smoke_config(arch).replace(**kw))


def _world(arch="qwen3_0_6b", **kw):
    """(port model, JAX model handle, JAX params) from one JAX init."""
    cfg, jcfg = _cfgs(arch, **kw)
    jmodel = build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.array(x, copy=True), params)
    cls = tapi.SSMLMModel if cfg.family == "ssm" else tlm.LMModel
    model = cls(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model, jmodel, params


def _as(caches, dtype):
    """A port cache dict ({"layers": {...}}) or JAX one, cast to
    ``dtype`` ("float32") or left as it is ("bfloat16")."""
    if dtype == "bfloat16":
        return caches
    if torch.is_tensor(next(iter(caches["layers"].values()))):
        return {"layers": {k: v.float() for k, v in caches["layers"].items()}}
    return jax.tree.map(lambda x: x.astype(jnp.float32), caches)


def _assert_caches(got, want, cache_dtype, drop_block0=False):
    for key in want["layers"]:
        a, b = got["layers"][key], want["layers"][key]
        assert str(a.dtype).endswith(cache_dtype)
        if cache_dtype == "bfloat16":
            assert_bf16_close(a, b, drop_block0=drop_block0)
        else:
            a, b = _np(a), _np(b)
            if drop_block0:
                a, b = a[:, 1:], b[:, 1:]
            assert _rel(a, b) < TOL_F32, key


def _logit_tol(cache_dtype) -> float:
    return TOL_LOGITS if cache_dtype == "float32" else TOL_LOGITS_BF16_CACHE


@pytest.fixture(scope="module")
def f32_world():
    return _world(dtype="float32")


@pytest.fixture(scope="module")
def f32_sparse_world():
    return _world(dtype="float32", **SPARSE_KW)


# ------------------------------------------------------ block allocator

@pytest.mark.parametrize("num_blocks,page,seed", [(9, 4, 0), (33, 16, 1),
                                                  (64, 1, 2)])
def test_allocator_trace_matches_reference(num_blocks, page, seed):
    """The same alloc/free trace gives the same block lists, counts and
    errors in both packages."""
    rng = np.random.default_rng(seed)
    a, b = BlockAllocator(num_blocks, page), JBlockAllocator(num_blocks, page)
    live = []
    for _ in range(120):
        if live and rng.random() < 0.45:
            blocks = live.pop(int(rng.integers(len(live))))
            a.free(blocks)
            b.free(blocks)
        else:
            n = a.blocks_for(int(rng.integers(1, 3 * page + 1)))
            assert n == b.blocks_for(n * page)
            if not a.can_alloc(n):
                assert not b.can_alloc(n)
                for alloc in (a, b):
                    with pytest.raises(RuntimeError, match="exhausted"):
                        alloc.alloc(n)
                continue
            got = a.alloc(n)
            assert got == b.alloc(n)
            live.append(got)
        assert (a.n_free, a.n_live) == (b.n_free, b.n_live)
    for bad in ([0], [num_blocks]):
        for alloc in (a, b):
            with pytest.raises(RuntimeError, match="not live"):
                alloc.free(bad)
    for args in ((1, 4), (4, 0)):
        for cls in (BlockAllocator, JBlockAllocator):
            with pytest.raises(ValueError):
                cls(*args)


@settings(max_examples=8)
@given(num_blocks=st.integers(4, 40), page=st.integers(1, 16),
       seed=st.integers(0, 10_000))
def test_allocator_properties(num_blocks, page, seed):
    """The reference's property test on the port's allocator: no aliasing
    across live allocations, free + live conserved, the scratch block
    never handed out, a full drain restores the whole free list."""
    rng = np.random.default_rng(seed)
    alloc = BlockAllocator(num_blocks, page)
    usable = num_blocks - 1
    live: dict[int, list] = {}
    for op in range(60):
        if live and (rng.random() < 0.4 or alloc.n_free == 0):
            rid = list(live)[int(rng.integers(len(live)))]
            alloc.free(live.pop(rid))
        else:
            n = alloc.blocks_for(int(rng.integers(1, 4 * page + 1)))
            if not alloc.can_alloc(n):
                with pytest.raises(RuntimeError, match="exhausted"):
                    alloc.alloc(n)
                continue
            blocks = alloc.alloc(n)
            assert 0 not in blocks          # scratch is never allocated
            live[op] = blocks
        flat = [b for bs in live.values() for b in bs]
        assert len(flat) == len(set(flat))  # no aliasing across live reqs
        assert alloc.n_free + alloc.n_live == usable
        assert alloc.n_live == len(flat)
    for blocks in live.values():
        alloc.free(blocks)
    assert alloc.n_free == usable and alloc.n_live == 0


def test_allocator_double_free_raises():
    alloc = BlockAllocator(8, 4)
    blocks = alloc.alloc(3)
    alloc.free(blocks)
    with pytest.raises(RuntimeError, match="not live"):
        alloc.free(blocks)
    with pytest.raises(RuntimeError, match="not live"):
        alloc.free([0])                     # the scratch block


# ----------------------------------------------------------- attention

def _paged_inputs(B, Sq, H, KV, Dh, NB, page, nmax, dtype, seed):
    """q, bf16 pools, tables whose unused entries point at scratch block
    0, ragged cache lengths."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, Dh)).astype(np.float32)
    kp = rng.standard_normal((NB, page, KV, Dh)).astype(np.float32)
    vp = rng.standard_normal((NB, page, KV, Dh)).astype(np.float32)
    lens = rng.integers(Sq, nmax * page + 1, B)
    bt = np.zeros((B, nmax), np.int64)
    perm = rng.permutation(np.arange(1, NB))
    at = 0
    for b in range(B):
        n = -(-int(lens[b]) // page)
        bt[b, :n] = perm[at:at + n]
        at += n
    jq = jnp.asarray(q, dtype)
    jk, jv = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
    tq = t(q).to(getattr(torch, jnp.dtype(dtype).name))
    tk, tv = t(_np(jk)).bfloat16(), t(_np(jv)).bfloat16()
    return (jq, jk, jv, tq, tk, tv, bt, lens.astype(np.int64))


@pytest.mark.parametrize("Sq", [1, 6])
@pytest.mark.parametrize("H,KV", [(4, 2), (3, 3)])
@pytest.mark.parametrize("window,n_global", [(0, 0), (5, 2)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_paged_attention_matches_reference(Sq, H, KV, window, n_global,
                                           dtype):
    """Decode (Sq 1, no offset) and prefill chunks (``q_offset``), GQA,
    ragged cache lengths, tables with scratch entries, the window/global
    mask; fp32 within TOL_F32, bf16 within one bf16 ulp of the output
    (both round one fp32 result)."""
    B, Dh, NB, page, nmax = 3, 16, 24, 4, 6
    jq, jk, jv, tq, tk, tv, bt, lens = _paged_inputs(
        B, Sq, H, KV, Dh, NB, page, nmax, dtype, seed=Sq + H)
    off = None if Sq == 1 else lens - Sq
    want = jops.paged_attention(
        jq, jk, jv, jnp.asarray(bt, jnp.int32), jnp.asarray(lens, jnp.int32),
        q_offset=None if off is None else jnp.asarray(off, jnp.int32),
        window=window, n_global=n_global)
    got = kops.paged_attention(tq, tk, tv, t(bt), t(lens),
                               q_offset=None if off is None else t(off),
                               window=window, n_global=n_global)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    if dtype == jnp.float32:
        assert _rel(_np(got), _np(want)) < TOL_F32
    else:
        assert_bf16_close(got, want)


def test_paged_attention_host_int_lengths_and_shared_mask():
    """Host-int ``cache_len``/``q_offset`` (the prefill chunk's) and a
    precomputed mask give the tensors' answer."""
    jq, jk, jv, tq, tk, tv, bt, lens = _paged_inputs(
        1, 5, 4, 2, 16, 12, 4, 5, jnp.float32, seed=3)
    n, off = int(lens[0]), int(lens[0]) - 5
    a = kops.paged_attention(tq, tk, tv, t(bt), t(lens), q_offset=t(lens - 5),
                             window=4, n_global=1)
    b = kops.paged_attention(tq, tk, tv, t(bt), n, q_offset=off, window=4,
                             n_global=1)
    mask = L.attention_mask(20, n, off + torch.arange(5)[None], window=4,
                            n_global=1)
    c = kops.paged_attention(tq, tk, tv, t(bt), n, mask=mask)
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("window,n_global", [(0, 0), (6, 2)])
@pytest.mark.parametrize("cache_len", ["ragged", "shared"])
def test_decode_attention_matches_reference(window, n_global, cache_len):
    rng = np.random.default_rng(7)
    B, S, H, KV, Dh = 3, 20, 4, 2, 16
    q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
    k = _np(jnp.asarray(rng.standard_normal((B, S, KV, Dh)), jnp.bfloat16))
    v = _np(jnp.asarray(rng.standard_normal((B, S, KV, Dh)), jnp.bfloat16))
    ln = np.array([3, 17, 20]) if cache_len == "ragged" else 14
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
                               jnp.asarray(v, jnp.bfloat16), jnp.asarray(ln),
                               window=window, n_global=n_global)
    got = L.decode_attention(t(q), t(k).bfloat16(), t(v).bfloat16(),
                             t(ln) if cache_len == "ragged" else ln,
                             window=window, n_global=n_global)
    assert _rel(_np(got), _np(want)) < TOL_F32


# ---------------------------------------------------------- the LM paths

@pytest.mark.parametrize("backend", ["dense", "cluster_sparse"])
def test_lm_prefill_matches_reference(backend):
    """Last-token logits and every layer's bf16 k/v cache at S=256 (the
    cluster-sparse branch's shortest sequence)."""
    model, jmodel, params = _world(dtype="float32", attn_backend=backend)
    tok = np.random.default_rng(0).integers(1, 512, (2, 256))
    want, wcache = jmodel.prefill(params, {"tokens": jnp.asarray(tok)})
    with torch.no_grad():
        got, cache = tlm.lm_prefill(model, {"tokens": t(tok)})
    assert got.shape == (2, 1, model.cfg.vocab_padded)
    assert _rel(_np(got), _np(want)) < TOL_LOGITS
    for key in ("k", "v"):
        assert cache["layers"][key].dtype == torch.bfloat16
        assert_bf16_close(cache["layers"][key], wcache["layers"][key])
    # sized past S for decode to go on in place: the extra rows are zero
    with torch.no_grad():
        _, longer = tlm.lm_prefill(model, {"tokens": t(tok)}, cache_len=260)
    assert torch.equal(longer["layers"]["k"][:, :, :256],
                       cache["layers"]["k"])
    assert not longer["layers"]["k"][:, :, 256:].any()


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [False, True])
def test_lm_decode_step_matches_reference(f32_sparse_world, sparse,
                                          cache_dtype):
    """T decode steps from empty caches (the window binds past step 8):
    logits every step, caches at the end; the port writes its caches in
    place and returns them."""
    model, jmodel, params = f32_sparse_world
    T, B = 14, 2
    tok = np.random.default_rng(1).integers(1, 512, (B, T))
    jcache = _as(nnp.init_tree(jmodel.cache_defs(B, T + 2),
                               jax.random.PRNGKey(1)), cache_dtype)
    cache = _as(model.cache_defs(B, T + 2), cache_dtype)
    step = jax.jit(lambda p, c, x, i: jmodel.decode(p, c, x, i,
                                                    sparse=sparse))
    for i in range(T):
        want, jcache = step(params, jcache, jnp.asarray(tok[:, i:i + 1]),
                            jnp.int32(i))
        with torch.no_grad():
            got, out = tlm.lm_decode_step(model, cache, t(tok[:, i:i + 1]),
                                          i, sparse=sparse)
        assert out is cache
        assert _rel(_np(got), _np(want)) < _logit_tol(cache_dtype), i
    _assert_caches(cache, jcache, cache_dtype)


def test_decode_step_takes_a_device_position(f32_sparse_world):
    """A 0-d int64 tensor position (what a CUDA graph of the step
    replays) gives the host int's logits and caches, bit for bit."""
    model = f32_sparse_world[0]
    tok = t(np.random.default_rng(5).integers(1, 512, (2, 12)))
    a, b = model.cache_defs(2, 14), model.cache_defs(2, 14)
    with torch.no_grad():
        for i in range(12):
            la, _ = model.decode(a, tok[:, i:i + 1], i, sparse=True)
            lb, _ = model.decode(b, tok[:, i:i + 1], torch.tensor(i),
                                 sparse=True)
            assert torch.equal(la, lb)
    assert all(torch.equal(a["layers"][k], b["layers"][k]) for k in "kv")


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [False, True])
def test_prefill_chunk_and_paged_decode_match_reference(f32_sparse_world,
                                                        sparse, cache_dtype):
    """On the same pool and tables: a prompt in ragged chunks (padding
    rows to scratch), then batched paged decode with per-slot positions
    and an idle slot; logits each call, the pool after the prefill and
    after the decode."""
    model, jmodel, params = f32_sparse_world
    cfg = model.cfg
    NB, page, nmax, C = 16, 4, 8, 8
    jpool = _as(nnp.init_tree(jmodel.paged_cache_defs(NB, page),
                              jax.random.PRNGKey(0)), cache_dtype)
    pool = _as(model.paged_cache_defs(NB, page), cache_dtype)
    tol = _logit_tol(cache_dtype)
    rng = np.random.default_rng(2)
    bts = np.zeros((3, nmax), np.int64)
    bts[0, :6] = [3, 9, 1, 12, 5, 7]
    bts[1, :4] = [2, 15, 11, 4]
    prompts = {0: rng.integers(1, 512, 19), 1: rng.integers(1, 512, 7)}
    jpf = jax.jit(lambda p, pl, x, o, n, b: jmodel.prefill_chunk(
        p, pl, x, o, n, b, sparse=sparse))
    for s, prompt in prompts.items():
        for off in range(0, len(prompt), C):
            n = min(C, len(prompt) - off)
            tokens = np.zeros((1, C), np.int64)
            tokens[0, :n] = prompt[off:off + n]
            want, jpool = jpf(params, jpool, jnp.asarray(tokens, jnp.int32),
                              jnp.int32(off), jnp.int32(n),
                              jnp.asarray(bts[s:s + 1], jnp.int32))
            with torch.no_grad():
                got, out = model.prefill_chunk(pool, t(tokens), off, n,
                                               t(bts[s:s + 1]), sparse=sparse)
            assert out is pool and got.shape == (1, 1, cfg.vocab_padded)
            assert _rel(_np(got), _np(want)) < tol
    _assert_caches(pool, jpool, cache_dtype, drop_block0=True)
    # slot 2 idle: token 0 at position 0 through an all-zero table
    pos = np.array([19, 7, 0])
    jpd = jax.jit(lambda p, pl, x, q, b: jmodel.paged_decode(
        p, pl, x, q, b, sparse=sparse))
    for _ in range(5):
        tokens = rng.integers(1, 512, (3, 1))
        tokens[2] = 0
        want, jpool = jpd(params, jpool, jnp.asarray(tokens, jnp.int32),
                          jnp.asarray(pos, jnp.int32),
                          jnp.asarray(bts, jnp.int32))
        with torch.no_grad():
            got, out = model.paged_decode(pool, t(tokens), t(pos), t(bts),
                                          sparse=sparse)
        assert out is pool
        assert _rel(_np(got[:2]), _np(want[:2])) < tol
        pos[:2] += 1
    _assert_caches(pool, jpool, cache_dtype, drop_block0=True)


def test_cache_defs_match_reference():
    """Every cache and pool the serving paths make: the reference's shape
    and dtype (its layer axis stacked), zero, on the model's device."""
    for arch, fns in (("qwen3_0_6b", (("cache_defs", (3, 40)),
                                      ("paged_cache_defs", (9, 16)))),
                      ("mamba2_2_7b", (("cache_defs", (3, 40)),))):
        cfg, jcfg = _cfgs(arch)
        cls = tapi.SSMLMModel if cfg.family == "ssm" else tlm.LMModel
        model, jmodel = cls(cfg, device="cpu"), build(jcfg)
        for name, args in fns:
            got = getattr(model, name)(*args)["layers"]
            want = getattr(jmodel, name)(*args)["layers"]
            assert sorted(got) == sorted(want)
            for key, d in want.items():
                assert tuple(got[key].shape) == tuple(d.shape), (arch, key)
                assert str(got[key].dtype).split(".")[-1] == \
                    jnp.dtype(d.dtype).name
                assert not got[key].any()


# ------------------------------------------------------------ Mamba2

def test_mamba_decode_matches_reference():
    """One block, fp32, from a nonzero bf16 conv history and fp32 state:
    the output and both new caches (the conv history promoted to fp32,
    as the reference's is)."""
    cfg, jcfg = _cfgs("mamba2_2_7b", dtype="float32")
    tree = jax.tree.map(lambda x: np.array(x, copy=True),
                        build(jcfg).init(jax.random.PRNGKey(0)))
    jp = jax.tree.map(lambda x: x[1], tree["layers"]["mamba"])
    model = tapi.SSMLMModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    rng = np.random.default_rng(3)
    B = 2
    zero = model.cache_defs(B, 8)["layers"]
    h = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    conv = _np(jnp.asarray(rng.standard_normal(zero["conv"].shape[1:]),
                           jnp.bfloat16))
    ssm = (rng.standard_normal(zero["ssm"].shape[1:]) * 0.1).astype(
        np.float32)
    want, wc = jssm.mamba_decode(jp, jcfg, jnp.asarray(h), {
        "conv": jnp.asarray(conv, jnp.bfloat16), "ssm": jnp.asarray(ssm)})
    with torch.no_grad():
        got, gc = tssm.mamba_decode(model.layers[1].mamba, cfg, t(h), {
            "conv": t(conv).bfloat16(), "ssm": t(ssm)})
    assert _rel(_np(got), _np(want)) < TOL_F32
    assert gc["conv"].dtype == torch.float32
    assert wc["conv"].dtype == jnp.float32
    assert _rel(_np(gc["conv"]), _np(wc["conv"])) < TOL_F32
    assert _rel(_np(gc["ssm"]), _np(wc["ssm"])) < TOL_F32


def test_ssm_lm_decode_matches_reference():
    """T steps of the whole Mamba2 LM from zero caches, fp32: logits every
    step, caches at the end."""
    model, jmodel, params = _world("mamba2_2_7b", dtype="float32")
    T, B = 10, 2
    tok = np.random.default_rng(4).integers(1, 512, (B, T))
    jcache = nnp.init_tree(jmodel.cache_defs(B, T), jax.random.PRNGKey(1))
    cache = model.cache_defs(B, T)
    step = jax.jit(lambda p, c, x, i: jmodel.decode(p, c, x, i))
    for i in range(T):
        want, jcache = step(params, jcache, jnp.asarray(tok[:, i:i + 1]),
                            jnp.int32(i))
        with torch.no_grad():
            got, cache = tapi.ssm_lm_decode(model, cache, t(tok[:, i:i + 1]),
                                            i)
        assert _rel(_np(got), _np(want)) < TOL_LOGITS, i
    for key in ("conv", "ssm"):
        assert _rel(_np(cache["layers"][key]),
                    _np(jcache["layers"][key])) < TOL_LOGITS
    with torch.no_grad():
        got, empty = model.prefill({"tokens": t(tok)})
    want, _ = jmodel.prefill(params, {"tokens": jnp.asarray(tok)})
    assert empty == {} and _rel(_np(got), _np(want)) < TOL_LOGITS


def test_ssm_bf16_prefill_decode_gap_tracks_reference():
    """bf16 at 8 layers: the port's gap between prefill logits and those
    of token-by-token decode is the reference's arithmetic, not a fault
    (at most 1.5x the reference's own gap on the same parameters), and
    in fp32 both close it to the fp32 tolerance."""
    kw = dict(n_layers=8, d_model=256, ssm_state=64, ssm_head_dim=32,
              ssm_chunk=32, vocab_size=1024)
    tok = np.random.default_rng(6).integers(1, 1024, (1, 128))
    gaps = {}
    for dtype in ("bfloat16", "float32"):
        model, jmodel, params = _world("mamba2_2_7b", dtype=dtype, **kw)
        want, _ = jax.jit(jmodel.prefill)(params,
                                          {"tokens": jnp.asarray(tok)})
        jcache = nnp.init_tree(jmodel.cache_defs(1, 128),
                               jax.random.PRNGKey(1))
        step = jax.jit(lambda p, c, x, i: jmodel.decode(p, c, x, i))
        with torch.no_grad():
            got, _ = model.prefill({"tokens": t(tok)})
            cache = model.cache_defs(1, 128)
            for i in range(128):
                jl, jcache = step(params, jcache, jnp.asarray(tok[:, i:i + 1]),
                                  jnp.int32(i))
                tl, cache = model.decode(cache, t(tok[:, i:i + 1]), i)
        gaps[dtype] = (float(np.abs(_np(got) - _np(tl)).max()),
                       float(np.abs(_np(want) - _np(jl)).max()),
                       float(np.abs(_np(want)).max()))
    port, ref, top = gaps["bfloat16"]
    assert port <= 1.5 * ref, gaps
    port, ref, top = gaps["float32"]
    assert max(port, ref) < TOL_F32 * top * 10, gaps


# -------------------------------------------------- the engine, both ways

def _prompts(vocab=512, seed=0, lens=RAGGED):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab // 4, n).tolist() for n in lens]


@pytest.mark.parametrize("sparse", [False, True])
def test_engine_matches_reference(f32_sparse_world, sparse):
    """The same fp32 smoke model, ragged prompts and engine settings (two
    slots for four requests: late admissions): equal streams, counters
    and two programs each; the pools agree to one bf16 ulp."""
    model, jmodel, params = f32_sparse_world
    kw = dict(batch_slots=2, page=8, chunk=8, max_len=64, sparse=sparse)
    engines = (ServeEngine(model, **kw), JServeEngine(jmodel, params, **kw))
    stats = []
    for eng in engines:
        for rid, p in enumerate(_prompts(seed=3)):
            eng.submit(rid, p, 6)
        stats.append(eng.run())
    mine, ref = engines
    assert mine.done == ref.done
    keys = ("requests", "tokens", "prefill_calls", "decode_calls",
            "traced_programs", "rejected_overload", "shed_deadline",
            "queue_peak")
    assert {k: stats[0][k] for k in keys} == {k: stats[1][k] for k in keys}
    assert stats[0]["traced_programs"] == 2
    for key in ("k", "v"):
        assert_bf16_close(mine.pool["layers"][key], ref.pool["layers"][key],
                          drop_block0=True)


def test_engine_default_chunk_is_the_reference_schedule(f32_world):
    """Without ``chunk`` both engines take the tuned schedule's default
    for the paged op, and a table-free run resolves the same value."""
    model, jmodel, params = f32_world
    for max_len in (64, 4096):
        assert ServeEngine(model, max_len=max_len).chunk == \
            JServeEngine(jmodel, params, max_len=max_len).chunk == 32


def test_engine_degradation_matches_reference(f32_world):
    """Overload past ``max_queue`` and deadlines shed at admission and
    mid-flight: the same typed rejections, partial outputs and counters
    as the reference's engine."""
    model, jmodel, params = f32_world
    kw = dict(batch_slots=2, page=8, chunk=8, max_len=128)
    out = []
    for eng in (ServeEngine(model, max_queue=3, **kw),
                JServeEngine(jmodel, params, max_queue=3, **kw)):
        res = eng.inject_burst(8, max_tokens=4, seed=0)
        stats = eng.run()
        eng.submit("past", [1, 2, 3], 4, deadline=-1.0)
        eng.submit("ok", [5, 6, 7], 4)
        stats2 = eng.run()
        out.append(([type(r).__name__ for r in res], eng.done,
                    [(r.rid, r.reason) for r in eng.rejected],
                    {k: v for k, v in eng.shed.items()},
                    {k: stats[k] for k in ("requests", "rejected_overload",
                                           "queue_peak")},
                    {k: stats2[k] for k in ("requests", "shed_deadline",
                                            "traced_programs")}))
    assert out[0] == out[1]
    assert out[0][0].count("Rejected") == 5


# ------------------------------- the reference's contracts, bf16 smoke

@pytest.fixture(scope="module")
def lm():
    return tlm.LMModel(get_smoke_config("qwen3_0_6b"), device="cpu", seed=0)


def _engine(model, **kw):
    kw.setdefault("batch_slots", 3)
    kw.setdefault("page", 8)
    kw.setdefault("max_len", 64)
    kw.setdefault("chunk", 8)
    return ServeEngine(model, **kw)


def _serve(model, prompts, n_new, *, sparse, **kw):
    kw.setdefault("batch_slots", 2)        # < len(prompts): late admission
    eng = _engine(model, sparse=sparse, **kw)
    for rid, p in enumerate(prompts):
        eng.submit(rid, p, n_new)
    eng.run()
    return eng


@torch.no_grad()
def _full_forward_choices(model, prompt, stream):
    """Full-forward greedy oracle, teacher-forced over ``stream``: for
    each of its tokens, the tokens whose logit ties the max of the
    prefill over the prefix before it. The logits are bf16, so two of
    them tie exactly now and then, and which of the tied tokens the
    engine's own logits favour is a matter of rounding."""
    toks, choices = list(prompt), []
    for tok in stream:
        logits, _ = model.prefill({"tokens": torch.tensor([toks])})
        row = logits[0, -1, :model.cfg.vocab_size].float()
        choices.append(set(torch.nonzero(row == row.max())[:, 0].tolist()))
        toks.append(tok)
    return choices


@torch.no_grad()
def _decode_greedy(model, prompt, n_new, *, sparse):
    """Contiguous-cache token-by-token greedy oracle."""
    cache = model.cache_defs(1, len(prompt) + n_new + 1)
    logits = None
    for i, tok in enumerate(prompt):
        logits, cache = model.decode(cache, torch.tensor([[tok]]), i,
                                     sparse=sparse)
    out = []
    for _ in range(n_new):
        nxt = int(logits[0, 0, :model.cfg.vocab_size].float().argmax())
        out.append(nxt)
        logits, cache = model.decode(cache, torch.tensor([[nxt]]),
                                     len(prompt) + len(out) - 1,
                                     sparse=sparse)
    return out


def test_paged_stream_matches_full_forward_greedy(lm):
    """Chunked prefill + paged decode == full-forward greedy decoding,
    token for token, with ragged prompts and late admissions: every
    engine token is the full forward's greedy choice over the prefix
    before it (one of the tied ones where its bf16 logits tie)."""
    prompts = _prompts(lm.cfg.vocab_size)
    eng = _serve(lm, prompts, 6, sparse=False)
    assert eng.traced_programs() == 2
    for rid, p in enumerate(prompts):
        stream = eng.done[rid]
        choices = _full_forward_choices(lm, p, stream)
        assert len(stream) == 6
        assert all(tok in c for tok, c in zip(stream, choices)), \
            (rid, stream, choices)


def test_paged_stream_matches_oracle_sparse():
    """``sparse=True``: the cluster-sparse mask on the paged path matches
    the contiguous-cache sparse decode oracle exactly (a window that
    binds)."""
    model = tlm.LMModel(get_smoke_config("qwen3_0_6b").replace(**SPARSE_KW),
                        device="cpu", seed=0)
    prompts = _prompts(model.cfg.vocab_size, seed=3)
    eng = _serve(model, prompts, 5, sparse=True)
    assert eng.traced_programs() == 2
    for rid, p in enumerate(prompts):
        assert eng.done[rid] == _decode_greedy(model, p, 5, sparse=True), rid


def test_engine_stays_at_two_programs_across_runs(lm):
    """A warm engine, audited on every run(): a new mix of ragged lengths
    adds no signature; the pool's storage never moves."""
    eng = _serve(lm, _prompts(lm.cfg.vocab_size), 3, sparse=False)
    ptrs = [t_.data_ptr() for t_ in eng.pool["layers"].values()]
    for rid, p in enumerate(_prompts(lm.cfg.vocab_size, seed=9)):
        eng.submit(100 + rid, p, 7)
    eng.run()                              # budget 0 — raises on a new one
    assert eng.traced_programs() == 2
    assert len(eng.done) == 2 * len(RAGGED)
    assert [t_.data_ptr() for t_ in eng.pool["layers"].values()] == ptrs
    assert eng.pool_bytes() == 2 * lm.cfg.n_layers * eng.allocator.num_blocks \
        * 8 * lm.cfg.kv_heads * lm.cfg.head_dim * 2


def test_engine_audit_raises_on_a_new_signature(lm, monkeypatch):
    """The budget is enforced: a warm engine whose prefill chunk changes
    shape makes a new signature, and run() raises."""
    eng = _serve(lm, _prompts(lm.cfg.vocab_size)[:2], 2, sparse=False)
    monkeypatch.setattr(eng, "chunk", 4)
    eng.submit("again", [1, 2, 3], 2)
    with pytest.raises(AssertionError, match="budget 0"):
        eng.run()


def test_engine_serves_more_requests_than_slots(lm):
    eng = _engine(lm)
    for rid, p in enumerate(_prompts(64 * 4, lens=[4, 9, 12, 5, 7, 11, 6])):
        eng.submit(rid, p, 5)
    stats = eng.run()
    assert stats["requests"] == 7           # 7 requests through 3 slots
    assert all(len(v) == 5 for v in eng.done.values())
    assert stats["tokens"] == 35
    assert stats["traced_programs"] == 2    # one prefill + one decode


def test_engine_deterministic(lm):
    outs = []
    for _ in range(2):
        eng = _engine(lm)
        for rid, p in enumerate(_prompts(seed=1, lens=[5, 8, 11, 4, 9])):
            eng.submit(rid, p, 4)
        eng.run()
        outs.append(eng.done)
    assert outs[0] == outs[1]


def test_engine_frees_every_block(lm):
    eng = _engine(lm, batch_slots=2)
    for rid, p in enumerate(_prompts(seed=2, lens=[6, 12, 4, 10, 8, 5])):
        eng.submit(rid, p, 6)
    eng.run()
    assert eng.allocator.n_live == 0
    assert eng.allocator.n_free == eng.allocator.num_blocks - 1


def test_engine_rejects_over_budget_and_empty(lm):
    eng = _engine(lm, max_len=32)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(0, [1] * 20, 20)         # 40 > 32
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(1, [], 4)
    with pytest.raises(ValueError, match="max_tokens"):
        eng.submit(2, [1], 0)


def test_engine_requires_paged_path():
    model = tapi.SSMLMModel(get_smoke_config("mamba2_2_7b"), device="cpu")
    with pytest.raises(ValueError, match="no paged serving path"):
        ServeEngine(model)


def test_late_request_matches_solo_run(lm):
    """One slot, two back-to-back requests: the engine's decode steps
    exceed max_len, yet the late request generates exactly what it
    generates alone (per-slot positions, no shared clock)."""
    prompt = _prompts(seed=3, lens=[5])[0]
    solo = _engine(lm, batch_slots=1, max_len=32)
    solo.submit("solo", prompt, 24)
    solo.run()
    eng = _engine(lm, batch_slots=1, max_len=32)
    eng.submit("first", _prompts(seed=4, lens=[5])[0], 24)
    eng.submit("late", prompt, 24)
    stats = eng.run()
    assert stats["decode_calls"] > 32       # engine clock well past max_len
    assert eng.done["late"] == solo.done["solo"]


def test_late_request_not_retired_early(lm):
    """Every request produces its full max_tokens, however late it was
    admitted."""
    eng = _engine(lm, batch_slots=2, max_len=32, page=8)
    for rid, p in enumerate(_prompts(seed=5, lens=[4, 7, 5, 8, 6, 4, 7, 5])):
        eng.submit(rid, p, 20)
    eng.run()
    assert sorted(eng.done) == list(range(8))
    assert {len(v) for v in eng.done.values()} == {20}


def test_engine_overload_and_deadlines(lm):
    """``max_queue`` turns a burst into typed rejections; deadlines shed
    past-due work at admission and mid-flight, on a warm engine that
    adds no signature."""
    eng = _engine(lm, batch_slots=2, max_len=128, max_queue=3)
    res = eng.inject_burst(8, max_tokens=4, seed=0)
    assert [isinstance(r, Admitted) for r in res] == [True] * 3 + [False] * 5
    assert all(isinstance(r, Rejected) and r.reason == "overloaded"
               for r in res[3:])
    stats = eng.run()
    assert (stats["requests"], stats["rejected_overload"],
            stats["queue_peak"], stats["traced_programs"]) == (3, 5, 3, 2)
    eng.submit("past", [1, 2, 3], 4, deadline=-1.0)
    eng.submit("slow", [1, 2, 3, 4], 100, deadline=0.001)
    eng.submit("ok", [5, 6, 7], 4)
    stats = eng.run()
    sheds = {r.rid: r.reason for r in eng.rejected if r.reason == "deadline"}
    assert sheds == {"past": "deadline", "slow": "deadline"}
    assert eng.shed["past"] == [] and len(eng.done["ok"]) == 4
    assert stats["shed_deadline"] == 2 and stats["traced_programs"] == 2
    assert eng.allocator.n_live == 0


def test_engine_eos_retires_early(lm):
    """A request retires at its first EOS token, EOS included."""
    prompt = _prompts(seed=6, lens=[7])[0]
    ref = _engine(lm)
    ref.submit(0, prompt, 8)
    ref.run()
    eos = ref.done[0][2]
    eng = _engine(lm, eos=eos)
    eng.submit(0, prompt, 8)
    eng.run()
    assert eng.done[0] == ref.done[0][:ref.done[0].index(eos) + 1]


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "mamba2_2_7b"])
def test_prefill_decode_logit_consistency(arch):
    """The full-sequence forward (prefill) and token-by-token decode give
    the same next-token logits (bf16, the reference's tolerance: atol
    0.15, rtol 0.05, equal argmax)."""
    cfg = get_smoke_config(arch).replace(remat="none", ssm_chunk=8)
    cls = tapi.SSMLMModel if cfg.family == "ssm" else tlm.LMModel
    model = cls(cfg, device="cpu", seed=0)
    B, T = 2, 16
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size // 4, (B, T)))
    with torch.no_grad():
        full, _ = model.prefill({"tokens": tok})
        cache = model.cache_defs(B, T + 4)
        for i in range(T):
            logits, cache = model.decode(cache, tok[:, i:i + 1], i)
    a, b = _np(full[:, -1]), _np(logits[:, 0])
    np.testing.assert_allclose(a, b, atol=0.15, rtol=0.05)
    assert (a.argmax(-1) == b.argmax(-1)).all()


# ------------------------------------------------------------------ CLI

def test_cli_serves_lm(capsys):
    assert serve_main(["--arch", "qwen3_0_6b", "--device", "cpu",
                       "--requests", "3", "--batch", "2", "--max-tokens",
                       "4", "--chunk", "8", "--page", "8", "--max-len",
                       "32"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "2 traced programs" in out
    assert "p50=" in out and "p99=" in out and "free blocks at drain: 8/8" \
        in out


def test_cli_rejects_ssm_arch(capsys):
    with pytest.raises(SystemExit):
        serve_main(["--arch", "mamba2_2_7b", "--device", "cpu"])
    assert "no paged serving path" in capsys.readouterr().err
