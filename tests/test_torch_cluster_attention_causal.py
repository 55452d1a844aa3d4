"""The unbiased cluster-sparse attention op of the LM path, on the CPU:
the port's plain forward and plain backward (behind ``kernels/ops.py``'s
autograd Function) against the JAX package's op in its jnp-reference mode
and with the Pallas kernels ``_cluster_kernel``, ``_dq_kernel`` and
``_dkv_kernel`` in interpret mode, on the same seeded numpy inputs and
cotangent, over token-LM local+global layouts at small S, causal and not,
with plain heads and GQA. Also: the plain backward against autograd
through the plain forward.

Tolerances: output within 2e-5 (fp32); gradients as max |port - jax| over
max |jax| within 1e-4 (sums in other orders); the plain backward against
autograd within 1e-5 (the same fp32 arithmetic, grouped differently).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.reformation import lm_local_global_layout
from repro_torch.kernels import cluster_attention as tca
from repro_torch.kernels import cluster_attention_bwd as tcab
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_cases import qkv, t

TOL_O = 2e-5
TOL_GRAD = 1e-4


@pytest.fixture
def jax_mode():
    """Sets the JAX dispatch mode of cluster_attention; restores auto."""
    def set_mode(mode):
        jops.set_mode(mode, "cluster_attention")
    yield set_mode
    jops.set_mode("auto", "cluster_attention")


def _case(H, KV, Dh, causal, *, S=256, bq=32, window=64, n_global=32,
          B=2, seed=0):
    """An LM layout, inputs and a cotangent."""
    lay = lm_local_global_layout(S, bq=bq, bk=bq, window=window,
                                 n_global=n_global, causal=causal)
    q, k, v, _ = qkv(B, lay.seq_len, H, KV, Dh, seed=seed)
    g = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(
        np.float32)
    return lay, q, k, v, g


def _no_fallback(rec):
    fell_back = [w for w in rec if "falling back" in str(w.message)]
    assert not fell_back, fell_back[0].message


def _jax_out_grads(q, k, v, bi, bit, g, causal):
    bi_ = jnp.asarray(bi)
    bit_ = None if bit is None else jnp.asarray(bit)

    def loss(q, k, v):
        o = jops.cluster_attention(q, k, v, bi_, None, None, bit_,
                                   causal=causal)
        return (o * g).sum(), o
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _no_fallback(rec)
    return np.asarray(o), [np.asarray(x) for x in grads]


def _port_out_grads(q, k, v, bi, bit, g, causal):
    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    o = tops.cluster_attention(*leaves, t(bi), None, None,
                               None if bit is None else t(bit),
                               causal=causal)
    (o * t(g)).sum().backward()
    return o.detach().numpy(), [x.grad.numpy() for x in leaves]


def _assert_grads(got, want, tol):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel <= tol, (name, rel)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV,Dh", [(4, 2, 16), (3, 3, 32)])
@pytest.mark.parametrize("with_bit", [True, False])
def test_out_and_grads_match_jax(jax_mode, mode, causal, H, KV, Dh,
                                 with_bit):
    """Output and gradients against the reference's op; in interpret mode
    the Pallas forward, dQ and dK/dV kernel bodies compute the JAX side.
    With the host-built transposed layout and without (derived)."""
    lay, q, k, v, g = _case(H, KV, Dh, causal)
    bit = lay.block_idx_t if with_bit else None
    jax_mode(mode)
    o_want, want = _jax_out_grads(q, k, v, lay.block_idx, bit, g, causal)
    o, got = _port_out_grads(q, k, v, lay.block_idx, bit, g, causal)
    np.testing.assert_allclose(o, o_want, atol=TOL_O, rtol=TOL_O)
    _assert_grads(got, want, TOL_GRAD)


@pytest.mark.parametrize("causal", [True, False])
def test_lm_block_size_layout_matches_jax_ref(jax_mode, causal):
    """The LM's own blocks (bq = bk = 128): window of one block, one
    global block, GQA 4 over 2 heads."""
    lay, q, k, v, g = _case(4, 2, 32, causal, S=512, bq=128, window=128,
                            n_global=128, B=1, seed=4)
    jax_mode("ref")
    o_want, want = _jax_out_grads(q, k, v, lay.block_idx, lay.block_idx_t,
                                  g, causal)
    o, got = _port_out_grads(q, k, v, lay.block_idx, lay.block_idx_t, g,
                             causal)
    np.testing.assert_allclose(o, o_want, atol=TOL_O, rtol=TOL_O)
    _assert_grads(got, want, TOL_GRAD)


def _plain_autograd(q, k, v, bi, g, causal):
    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    o = tref.cluster_sparse_attention(*leaves, t(bi), causal=causal)
    (o * t(g)).sum().backward()
    return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV,Dh", [(4, 2, 16), (3, 3, 32)])
@pytest.mark.parametrize("per_graph", [False, True])
def test_plain_backward_equals_autograd(causal, H, KV, Dh, per_graph):
    """The recomputation backward against autograd through the plain
    forward, with the transposed layout given and derived; per-graph 3-D
    layouts with a dead q-block row (its dq is zero)."""
    lay, q, k, v, g = _case(H, KV, Dh, causal, seed=5)
    bi, bit = lay.block_idx, lay.block_idx_t
    if per_graph:
        bi = np.stack([bi, bi])
        bi[1, 3] = -1
        bit = None
    want = _plain_autograd(q, k, v, bi, g, causal)
    o, lse = tref.cluster_sparse_attention(t(q), t(k), t(v), t(bi),
                                           causal=causal, return_lse=True)
    for layout_t in ((None,) if bit is None else (t(bit), None)):
        got = tref.cluster_attention_bwd(t(q), t(k), t(v), t(g), o, lse,
                                         t(bi), None, None, layout_t,
                                         causal=causal)
        assert got[3] is None
        _assert_grads([x.numpy() for x in got[:3]], want, 1e-5)
    if per_graph:
        assert not got[0][1, 3 * 32:4 * 32].any()
        assert not o[1, 3 * 32:4 * 32].any()


def test_plain_versions_in_chunks_match_jax_ref(jax_mode, monkeypatch):
    """With the chunk bound cut to two blocks, the plain forward and
    backward walk the layout in many chunks and still give the
    reference's output and gradients."""
    H, KV, Dh = 4, 2, 16
    lay, q, k, v, g = _case(H, KV, Dh, True, seed=7)
    monkeypatch.setattr(tref, "MAX_CHUNK_ENTRIES", 2 * H * 32 * 32)
    assert len(tref._chunks(int((lay.block_idx >= 0).sum()) * 2,
                            H * 32 * 32)) > 10
    jax_mode("ref")
    o_want, want = _jax_out_grads(q, k, v, lay.block_idx, lay.block_idx_t,
                                  g, True)
    o, got = _port_out_grads(q, k, v, lay.block_idx, lay.block_idx_t, g,
                             True)
    np.testing.assert_allclose(o, o_want, atol=TOL_O, rtol=TOL_O)
    _assert_grads(got, want, TOL_GRAD)


def test_cpu_call_launches_no_kernel_and_wrappers_refuse_cpu():
    """On CPU tensors the op computes the plain versions: no unbiased
    launch is counted, and the kernel wrappers themselves refuse CPU
    tensors."""
    lay, q, k, v, g = _case(4, 2, 16, True)
    tca.reset_count()
    tcab.reset_count()
    _port_out_grads(q, k, v, lay.block_idx, lay.block_idx_t, g, True)
    assert (tca.unbiased_launches, tca.unbiased_sm90_launches,
            tcab.dq_unbiased_launches, tcab.dkv_unbiased_launches,
            tcab.dq_unbiased_sm90_launches,
            tcab.dkv_unbiased_sm90_launches) == (0, 0, 0, 0, 0, 0)
    with pytest.raises(NotImplementedError, match="no kernel"):
        tca.cluster_attention_fwd(t(q), t(k), t(v), t(lay.block_idx), None,
                                  None, causal=True)
    o, lse = tref.cluster_sparse_attention(t(q), t(k), t(v),
                                           t(lay.block_idx), causal=True,
                                           return_lse=True)
    with pytest.raises(NotImplementedError, match="no kernel"):
        tcab.cluster_attention_bwd(t(q), t(k), t(v), t(g), o, lse,
                                   t(lay.block_idx), None, None,
                                   causal=True)


def test_op_rejects_a_bias_table_without_buckets():
    lay, q, k, v, _ = _case(4, 2, 16, True)
    with pytest.raises(ValueError, match="together"):
        tops.cluster_attention(t(q), t(k), t(v), t(lay.block_idx), None,
                               torch.zeros(4, 3), causal=True)


@pytest.mark.parametrize("dtype,d_head,bq,backward,reason", [
    # the bf16 forward (tensor cores) takes the 128-row blocks only
    (torch.bfloat16, 128, 128, False, None),
    (torch.bfloat16, 64, 128, False, None),
    (torch.bfloat16, 128, 64, False, "bq = bk = 128"),
    (torch.bfloat16, 64, 256, False, "bq = bk = 128"),
    (torch.bfloat16, 32, 128, False, None),
    (torch.bfloat16, 12, 128, False, "Dh=12"),
    # the graph models' head dims: Slim's 8, Large's 24
    (torch.bfloat16, 8, 128, False, None),
    (torch.bfloat16, 24, 128, True, None),
    (torch.bfloat16, 8, 64, False, "bq = bk = 128"),
    # the bf16 backward (tensor cores) takes what the bf16 forward takes
    (torch.bfloat16, 128, 64, True, "bq = bk = 128"),
    (torch.bfloat16, 64, 96, True, "bq = bk = 128"),
    (torch.bfloat16, 128, 128, True, None),
    (torch.bfloat16, 64, 128, True, None),
    (torch.bfloat16, 128, 256, True, "bq = bk = 128"),
    (torch.bfloat16, 32, 128, True, None),
    (torch.bfloat16, 96, 128, True, "Dh=96"),
    (torch.bfloat16, 12, 128, True, "Dh=12"),
    # fp32, forward and backward, as before: multiples of 64
    (torch.float32, 128, 64, False, None),
    (torch.float32, 64, 256, False, None),
    (torch.float32, 128, 128, True, None),
    (torch.float32, 128, 96, False, "a multiple of 64"),
    (torch.float32, 48, 128, False, None),
    (torch.float32, 12, 128, False, "Dh=12"),
    (torch.float32, 8, 128, True, None),
])
def test_unbiased_kernel_reason_per_dtype(dtype, d_head, bq, backward,
                                          reason):
    """What each dtype's unbiased kernels take, and the reason they give
    for what they refuse: Dh a multiple of 8 up to 64, or 128; bf16 the
    128-row blocks, fp32 multiples of 64."""
    got = tca.unbiased_kernel_reason(dtype, d_head, bq, backward=backward)
    if reason is None:
        assert got is None
    else:
        assert got is not None and reason in got, got


def test_check_unbiased_kernel_names_dtype_and_shapes():
    """The op's check raises with the dtype and the shapes: the bf16
    forward and backward refuse the 64-row blocks that fp32 takes."""
    lay = lm_local_global_layout(512, bq=64, bk=64, window=128,
                                 n_global=64)
    bi, bit = t(lay.block_idx), t(lay.block_idx_t)
    q = torch.zeros(2, 512, 4, 64, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError,
                       match=r"bq=bk=64 .*bfloat16 q \(2, 512, 4, 64\), "
                             r"block_idx \(8, 3\)"):
        tca.check_unbiased_kernel(q, bi)
    with pytest.raises(NotImplementedError,
                       match=r"bq=bk=64 \(the bf16 backward .*bfloat16 q "
                             r"\(2, 512, 4, 64\), block_idx \(8, 3\), "
                             r"block_idx_t \(8, 8, 2\)"):
        tca.check_unbiased_kernel(q, bi, bit, backward=True)
    tca.check_unbiased_kernel(q.float(), bi)
    tca.check_unbiased_kernel(q.float(), bi, bit, backward=True)


def test_reset_count_zeroes_the_unbiased_counters():
    """One counter per kernel, the bf16 tensor-core forward, dQ and dK/dV
    included."""
    tca.launches = tca.unbiased_launches = tca.unbiased_sm90_launches = 2
    tca.reset_count()
    assert (tca.launches, tca.unbiased_launches,
            tca.unbiased_sm90_launches) == (0, 0, 0)
    tcab.dq_launches = tcab.dkv_launches = 3
    tcab.dq_unbiased_launches = tcab.dkv_unbiased_launches = 3
    tcab.dq_unbiased_sm90_launches = tcab.dkv_unbiased_sm90_launches = 3
    tcab.reset_count()
    assert (tcab.dq_launches, tcab.dkv_launches, tcab.dq_unbiased_launches,
            tcab.dkv_unbiased_launches, tcab.dq_unbiased_sm90_launches,
            tcab.dkv_unbiased_sm90_launches) == (0, 0, 0, 0, 0, 0)
