"""The port's cluster-sparse attention op (plain PyTorch version, on the
CPU) against the JAX package's op, in its jnp-reference mode and with the
Pallas kernel body in interpret mode, on the same seeded numpy inputs.

Tolerances: 2e-5 in fp32, 2e-2 in bf16 (as tests/test_kernels.py). In
bf16 the JAX reference rounds the probabilities to bf16 before the PV
product; the port, like the CUDA kernel, keeps them in fp32.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import cluster_attention as tca
from repro_torch.kernels import ops as tops

from _torch_cases import graph_layout, per_graph_layout, qkv, t

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def jax_mode():
    """Sets the JAX dispatch mode of cluster_attention; restores auto."""
    def set_mode(mode):
        jops.set_mode(mode, "cluster_attention")
    yield set_mode
    jops.set_mode("auto", "cluster_attention")


def _jax(q, k, v, bi, bu, bias, dtype):
    jdt = getattr(jnp, dtype)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = jops.cluster_attention(
            jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
            jnp.asarray(v).astype(jdt), jnp.asarray(bi),
            None if bu is None else jnp.asarray(bu),
            None if bias is None else jnp.asarray(bias), causal=False)
    fell_back = [w for w in rec if "falling back" in str(w.message)]
    assert not fell_back, fell_back[0].message
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, bi, bu, bias, dtype, **kw):
    tdt = getattr(torch, dtype)
    return tops.cluster_attention(
        t(q, tdt), t(k, tdt), t(v, tdt), t(bi),
        None if bu is None else t(bu), None if bias is None else t(bias),
        **kw)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_graph", [False, True])
@pytest.mark.parametrize("H,KV,Dh", [(4, 4, 8), (8, 2, 24)])
def test_plain_matches_jax_graph_layout(jax_mode, mode, dtype, per_graph,
                                        H, KV, Dh):
    """Graph layouts with a random nonzero bias table: shared (2-D) and
    per-graph (3-D) layouts, plain heads and GQA, Dh 8 and 24."""
    if per_graph:
        S, bi, bu, nb = per_graph_layout()
    else:
        lay = graph_layout()
        S, bi, bu, nb = lay.seq_len, lay.block_idx, lay.buckets, \
            lay.n_buckets
    q, k, v, bias = qkv(2, S, H, KV, Dh, n_buckets=nb)
    jax_mode(mode)
    want = _jax(q, k, v, bi, bu, bias, dtype)
    got = _port(q, k, v, bi, bu, bias, dtype)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("mode", ["ref", "interpret"])
def test_dead_rows_output_zero(jax_mode, mode):
    """A q-block row with no visited block and one whose visited blocks
    are fully masked both output 0, and lse 0."""
    lay = graph_layout()
    bi, bu = lay.block_idx.copy(), lay.buckets.copy()
    bi[2] = -1
    bu[3] = -1
    q, k, v, bias = qkv(1, lay.seq_len, 4, 4, 8, n_buckets=lay.n_buckets)
    jax_mode(mode)
    want = _jax(q, k, v, bi, bu, bias, "float32")
    got, lse = _port(q, k, v, bi, bu, bias, "float32", return_lse=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    bq = lay.bq
    for row in (2, 3):
        assert not got[:, row * bq:(row + 1) * bq].any()
        assert not lse[:, row * bq:(row + 1) * bq].any()


def _dense_reference(q, k, v, dense_bkt, bias):
    """Dense numpy attention over an (S, S) bucket matrix (-1 masked):
    O and the per-row logsumexp, both fp64; rows with no unmasked entry
    (the padding past the last node) give 0 for both."""
    B, S, H, Dh = q.shape
    G = H // k.shape[2]
    kk = np.repeat(k, G, axis=2).astype(np.float64)
    vv = np.repeat(v, G, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) * Dh ** -0.5
    s = s + bias[:, np.maximum(dense_bkt, 0)][None]
    valid = np.broadcast_to(dense_bkt[None, None] >= 0, s.shape)
    live = valid.any(-1)
    m = np.where(valid, s, -np.inf).max(-1, keepdims=True)
    m = np.where(live[..., None], m, 0.0)
    p = np.where(valid, np.exp(s - m), 0.0)
    l = p.sum(-1)
    lse = np.where(live, m[..., 0] + np.log(np.maximum(l, 1e-300)), 0.0)
    o = np.einsum("bhqk,bkhd->bqhd", p / np.maximum(l, 1e-300)[..., None],
                  vv)
    return o, lse.reshape(B * H, S)


def test_lse_and_output_match_dense_attention():
    """O and the logsumexp residual equal dense attention over the
    scattered (S, S) bucket matrix."""
    lay = graph_layout()
    S, bq = lay.seq_len, lay.bq
    dense = np.full((S, S), -1, np.int64)
    for i in range(lay.nq):
        for m, j in enumerate(lay.block_idx[i]):
            if j >= 0:
                dense[i * bq:(i + 1) * bq, j * bq:(j + 1) * bq] = \
                    lay.buckets[i, m]
    q, k, v, bias = qkv(2, S, 8, 2, 24, n_buckets=lay.n_buckets)
    o_want, lse_want = _dense_reference(q, k, v, dense, bias)
    o, lse = _port(q, k, v, lay.block_idx, lay.buckets, bias, "float32",
                   return_lse=True)
    np.testing.assert_allclose(o.numpy(), o_want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), lse_want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
def test_full_layout_equals_dense(jax_mode, mode):
    """Every q-block visits every k-block with all-zero buckets: the op is
    dense attention with a uniform bias, which softmax cancels."""
    S, bq, H, Dh = 128, 32, 4, 24
    nq = S // bq
    bi = np.tile(np.arange(nq, dtype=np.int32)[None], (nq, 1))
    bu = np.zeros((nq, nq, bq, bq), np.int8)
    q, k, v, bias = qkv(1, S, H, H, Dh)
    o_want, _ = _dense_reference(q, k, v, np.zeros((S, S), np.int64),
                                 np.zeros_like(bias))
    got = _port(q, k, v, bi, bu, bias, "float32")
    np.testing.assert_allclose(got.numpy(), o_want, atol=2e-5, rtol=2e-5)
    jax_mode(mode)
    np.testing.assert_allclose(got.numpy(),
                               _jax(q, k, v, bi, bu, bias, "float32"),
                               atol=2e-5, rtol=2e-5)


def test_unbiased_causal_plain_matches_jax_ref(jax_mode):
    """Without buckets the CPU op is the plain version, causal mask
    included (the kernel for this case is not ported yet)."""
    S, bq = 128, 32
    nq = S // bq
    bi = np.full((nq, 2), -1, np.int32)
    for i in range(nq):
        bi[i, :min(i + 1, 2)] = [0, i][:min(i + 1, 2)]
    q, k, v, _ = qkv(1, S, 4, 2, 8)
    jax_mode("ref")
    want = np.asarray(jops.cluster_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bi),
        causal=True))
    got = tops.cluster_attention(t(q), t(k), t(v), t(bi), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_op_rejects_what_no_kernel_takes():
    lay = graph_layout()
    q, k, v, bias = qkv(1, lay.seq_len, 4, 4, 8)
    args = (t(q), t(k), t(v), t(lay.block_idx), t(lay.buckets), t(bias))
    with pytest.raises(ValueError, match="causal"):
        tops.cluster_attention(*args, causal=True)
    with pytest.raises(ValueError, match="impl"):
        tops.cluster_attention(*args, impl="compiled")
    with pytest.raises(ValueError, match="buckets"):
        tops.cluster_attention(*args[:4], t(lay.buckets[:, :-1]), args[5])


def test_cpu_call_takes_plain_version_and_counts_no_launch():
    """On CPU tensors the wrapper computes the plain version — it never
    builds or launches the kernel, so the launch count stays put."""
    lay = graph_layout()
    q, k, v, bias = qkv(1, lay.seq_len, 4, 4, 8, n_buckets=lay.n_buckets)
    tca.reset_count()
    out = tops.cluster_attention(t(q), t(k), t(v), t(lay.block_idx),
                                 t(lay.buckets), t(bias))
    plain = tops.cluster_attention(t(q), t(k), t(v), t(lay.block_idx),
                                   t(lay.buckets), t(bias), impl="plain")
    assert tca.launches == 0
    assert torch.equal(out, plain)


def test_kernel_wrapper_takes_cuda_tensors_only():
    """The device decision lives in ``ops``: the kernel wrapper itself
    raises on CPU tensors rather than computing the plain version."""
    lay = graph_layout()
    q, k, v, bias = qkv(1, lay.seq_len, 4, 4, 8, n_buckets=lay.n_buckets)
    tca.reset_count()
    with pytest.raises(NotImplementedError, match="no kernel for device cpu"):
        tca.cluster_attention_fwd(t(q), t(k), t(v), t(lay.block_idx),
                                  t(lay.buckets), t(bias))
    assert tca.launches == 0
