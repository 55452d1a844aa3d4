"""Gradients of the port's cluster-sparse attention op on the CPU (the
plain backward behind ``kernels/ops.py``'s autograd Function) against
``jax.grad`` through the JAX package's op, in its jnp-reference mode and
with the Pallas backward kernels in interpret mode, on the same seeded
numpy inputs and cotangent. Also: the plain backward against autograd
through the plain forward, and the derived transposed layout against
the reference's.

Tolerances, as max |port - jax| over max |jax| per gradient: 1e-4 in
fp32 (sums in other orders); 3e-2 in bf16 (the JAX reference rounds the
probabilities, and its gradients, to bf16 at other places than the
port, which keeps them in fp32 like the CUDA kernels). The plain
backward against autograd: 1e-5 (the same fp32 arithmetic, grouped
differently).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
# the reference's in-trace transposed layout is compared as a function of
# its own, below the dispatch layer
from repro.kernels.cluster_attention_bwd import (  # repro-lint: disable=REP002
    derive_block_idx_t as jderive)
from repro_torch.core.reformation import transpose_block_idx
from repro_torch.kernels import cluster_attention as tca
from repro_torch.kernels import cluster_attention_bwd as tcab
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_cases import graph_layout, per_graph_layout, qkv, t

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
NAMES = ("dq", "dk", "dv", "dbias")


@pytest.fixture
def jax_mode():
    """Sets the JAX dispatch mode of cluster_attention; restores auto."""
    def set_mode(mode):
        jops.set_mode(mode, "cluster_attention")
    yield set_mode
    jops.set_mode("auto", "cluster_attention")


def _case(per_graph, H, KV, Dh, seed=0):
    """Layout, inputs, the host-built transposed layout and a cotangent."""
    if per_graph:
        S, bi, bu, nb = per_graph_layout()
        lays = [graph_layout(seed=s) for s in (1, 2)]
        bits = [transpose_block_idx(x.block_idx, S // x.bk) for x in lays]
        mt = max(b.shape[1] for b in bits)
        bit = np.stack([np.pad(b, ((0, 0), (0, mt - b.shape[1]), (0, 0)),
                               constant_values=-1) for b in bits])
    else:
        lay = graph_layout()
        S, bi, bu, nb = lay.seq_len, lay.block_idx, lay.buckets, \
            lay.n_buckets
        bit = lay.block_idx_t
    q, k, v, bias = qkv(2, S, H, KV, Dh, seed=seed, n_buckets=nb)
    g = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(
        np.float32)
    return q, k, v, bias, bi, bu, bit, g


def _jax_grads(q, k, v, bias, bi, bu, bit, g, dtype):
    jdt = getattr(jnp, dtype)
    bi_, bu_ = jnp.asarray(bi), jnp.asarray(bu)
    bit_ = None if bit is None else jnp.asarray(bit)

    def loss(q, k, v, bias):
        o = jops.cluster_attention(q.astype(jdt), k.astype(jdt),
                                   v.astype(jdt), bi_, bu_, bias, bit_,
                                   causal=False)
        return (o.astype(jnp.float32) * g).sum()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        grads = jax.grad(loss, argnums=(0, 1, 2, 3))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(bias))
    fell_back = [w for w in rec if "falling back" in str(w.message)]
    assert not fell_back, fell_back[0].message
    return [np.asarray(x, np.float32) for x in grads]


def _port_grads(q, k, v, bias, bi, bu, bit, g, dtype):
    tdt = getattr(torch, dtype)
    leaves = [t(x).requires_grad_() for x in (q, k, v, bias)]
    o = tops.cluster_attention(*(x.to(tdt) for x in leaves[:3]), t(bi),
                               t(bu), leaves[3],
                               None if bit is None else t(bit))
    (o.float() * t(g)).sum().backward()
    return [x.grad.numpy() for x in leaves]


def _assert_close(got, want, tol):
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel <= tol, (name, rel)


@pytest.mark.parametrize("with_bit", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_graph", [False, True])
@pytest.mark.parametrize("H,KV,Dh", [(4, 4, 8), (8, 2, 24)])
def test_grads_match_jax_ref(jax_mode, with_bit, dtype, per_graph, H, KV,
                             Dh):
    """Shared and per-graph layouts, plain heads and GQA, Dh 8 and 24,
    with the host-built transposed layout and without (derived)."""
    q, k, v, bias, bi, bu, bit, g = _case(per_graph, H, KV, Dh)
    bit = bit if with_bit else None
    jax_mode("ref")
    want = _jax_grads(q, k, v, bias, bi, bu, bit, g, dtype)
    _assert_close(_port_grads(q, k, v, bias, bi, bu, bit, g, dtype), want,
                  TOL[dtype])


@pytest.mark.parametrize("case", [
    ("float32", False, (4, 4, 8), True),
    ("float32", True, (8, 2, 24), True),
    ("float32", False, (8, 2, 24), False),
    ("bfloat16", True, (4, 4, 8), False),
])
def test_grads_match_jax_interpret_kernels(jax_mode, case):
    """The Pallas dQ and dK/dV kernel bodies (interpret mode) give the
    port's gradients."""
    dtype, per_graph, (H, KV, Dh), with_bit = case
    q, k, v, bias, bi, bu, bit, g = _case(per_graph, H, KV, Dh, seed=3)
    bit = bit if with_bit else None
    jax_mode("interpret")
    want = _jax_grads(q, k, v, bias, bi, bu, bit, g, dtype)
    _assert_close(_port_grads(q, k, v, bias, bi, bu, bit, g, dtype), want,
                  TOL[dtype])


def _plain_autograd(q, k, v, bias, bi, bu, g):
    leaves = [t(x).requires_grad_() for x in (q, k, v, bias)]
    o = tref.cluster_sparse_attention(*leaves[:3], t(bi), t(bu), leaves[3])
    (o * t(g)).sum().backward()
    return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("per_graph", [False, True])
@pytest.mark.parametrize("H,KV,Dh", [(4, 4, 8), (8, 2, 24)])
def test_plain_backward_equals_autograd(per_graph, H, KV, Dh):
    q, k, v, bias, bi, bu, bit, g = _case(per_graph, H, KV, Dh, seed=5)
    want = _plain_autograd(q, k, v, bias, bi, bu, g)
    o, lse = tref.cluster_sparse_attention(t(q), t(k), t(v), t(bi), t(bu),
                                           t(bias), return_lse=True)
    for layout_t in (t(bit), None):
        got = tref.cluster_attention_bwd(t(q), t(k), t(v), t(g), o, lse,
                                         t(bi), t(bu), t(bias), layout_t)
        _assert_close([x.numpy() for x in got], want, 1e-5)


@pytest.mark.parametrize("per_graph", [False, True])
def test_plain_versions_in_chunks_match_jax_ref(jax_mode, monkeypatch,
                                                per_graph):
    """With the chunk bound cut to two blocks, the plain forward and
    backward walk a layout in many chunks and still give the JAX
    reference's output and gradients."""
    H, KV, Dh = 8, 2, 24
    q, k, v, bias, bi, bu, bit, g = _case(per_graph, H, KV, Dh, seed=7)
    bq, bk = bu.shape[-2:]
    monkeypatch.setattr(tref, "MAX_CHUNK_ENTRIES", 2 * H * bq * bk)
    assert len(tref._chunks(int((bi >= 0).sum()), H * bq * bk)) > 10
    jax_mode("ref")
    want_o = np.asarray(jops.cluster_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bi),
        jnp.asarray(bu), jnp.asarray(bias), causal=False))
    o = tref.cluster_sparse_attention(t(q), t(k), t(v), t(bi), t(bu),
                                      t(bias))
    np.testing.assert_allclose(o.numpy(), want_o, rtol=1e-4, atol=1e-5)
    want = _jax_grads(q, k, v, bias, bi, bu, bit, g, "float32")
    _assert_close(_port_grads(q, k, v, bias, bi, bu, bit, g, "float32"),
                  want, TOL["float32"])


def test_plain_backward_dead_rows_and_full_layout():
    """Dead rows (an empty row, a fully masked row) get zero dq and send
    nothing to dk/dv; a full layout with zero buckets is dense attention."""
    lay = graph_layout(bq=16, d_b=4)
    bi, bu = lay.block_idx.copy(), lay.buckets.copy()
    bi[2] = -1
    bu[3] = -1
    q, k, v, bias = qkv(1, lay.seq_len, 4, 4, 8, n_buckets=lay.n_buckets)
    g = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    want = _plain_autograd(q, k, v, bias, bi, bu, g)
    got = _port_grads(q, k, v, bias, bi, bu, None, g, "float32")
    _assert_close(got, want, 1e-5)
    assert not got[0][:, 2 * 16:4 * 16].any()
    S, bq = 128, 32
    nq = S // bq
    bi = np.tile(np.arange(nq, dtype=np.int32)[None], (nq, 1))
    bu = np.zeros((nq, nq, bq, bq), np.int8)
    q, k, v, bias = qkv(1, S, 2, 2, 24)
    g = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    got = _port_grads(q, k, v, bias, bi, bu, None, g, "float32")
    _assert_close(got[:3], _plain_autograd(q, k, v, bias, bi, bu, g)[:3],
                  1e-5)
    # one bucket everywhere shifts every score of a row alike, which the
    # softmax cancels: the bias gradient is zero up to rounding
    assert np.abs(got[3]).max() < 1e-4


@pytest.mark.parametrize("per_graph", [False, True])
@pytest.mark.parametrize("H,KV,Dh", [(4, 4, 8), (8, 2, 24)])
def test_dq_split_twin_matches_jax_ref(jax_mode, per_graph, H, KV, Dh):
    """The plain twin of the bf16 dQ's split grid (pieces, partial dq and
    bucket sums per slot, the combine's slot-order sum) against
    ``jax.grad`` of the JAX op in ref mode, fp32, with every row above 2
    visits cut into pieces."""
    q, k, v, bias, bi, bu, bit, g = _case(per_graph, H, KV, Dh, seed=11)
    pieces, splits = tca.split_plan((bi >= 0).sum(-1), 2, 2)
    assert len(splits) >= 2 and splits[:, 2].max() >= 3
    jax_mode("ref")
    want = _jax_grads(q, k, v, bias, bi, bu, bit, g, "float32")
    o, lse = tref.cluster_sparse_attention(t(q), t(k), t(v), t(bi), t(bu),
                                           t(bias), return_lse=True)
    dq, dbias = tref.bwd_dq_split(t(q), t(k), t(v), t(g), lse,
                                  tref.row_delta(t(g), o), t(bi), t(bu),
                                  t(bias), pieces, splits)
    for name, a, b in (("dq", dq.numpy(), want[0]),
                       ("dbias", dbias.numpy(), want[3])):
        assert a.shape == b.shape, name
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel <= TOL["float32"], (name, rel)


@pytest.mark.parametrize("per_graph", [False, True])
def test_derived_layout_t_equals_reference(per_graph):
    """The torch ``derive_block_idx_t`` equals the reference's jnp one
    byte for byte, and lists the same pairs as the host-built layout."""
    if per_graph:
        S, bi, _, _ = per_graph_layout()
        want = np.stack([np.asarray(jderive(jnp.asarray(x), S // 32))
                         for x in bi])
    else:
        lay = graph_layout()
        S, bi = lay.seq_len, lay.block_idx
        want = np.asarray(jderive(jnp.asarray(bi), S // 32))
        host = lay.block_idx_t
        for j in range(S // 32):
            pairs = {tuple(p) for p in want[j] if p[0] >= 0}
            assert pairs == {tuple(p) for p in host[j] if p[0] >= 0}
    got = tref.derive_block_idx_t(t(bi), S // 32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_grads_launch_no_kernel_and_wrapper_refuses_cpu():
    """On CPU tensors the gradients come from the plain backward: no
    launch is counted, and the kernel wrapper itself refuses CPU
    tensors."""
    q, k, v, bias, bi, bu, bit, g = _case(False, 4, 4, 8)
    tcab.reset_count()
    _port_grads(q, k, v, bias, bi, bu, bit, g, "float32")
    assert (tcab.dq_launches, tcab.dq_sm90_launches, tcab.dkv_launches,
            tcab.dkv_sm90_launches) == (0, 0, 0, 0)
    o, lse = tref.cluster_sparse_attention(t(q), t(k), t(v), t(bi), t(bu),
                                           t(bias), return_lse=True)
    with pytest.raises(NotImplementedError, match="no kernel"):
        tcab.cluster_attention_bwd(t(q), t(k), t(v), t(g), o, lse, t(bi),
                                   t(bu), t(bias), t(bit))
    with pytest.raises(ValueError, match="block_idx_t"):
        tops.cluster_attention(t(q), t(k), t(v), t(bi), t(bu), t(bias),
                               t(bit)[:-1])
