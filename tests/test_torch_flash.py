"""The dense flash attention op of the port on the CPU: ``ops.flash_attention``
(its plain forward and plain backward behind the autograd Function)
against the JAX package's ``ops.flash_attention`` with the Pallas
kernels ``_flash_kernel``, ``_flash_dq_kernel`` and ``_flash_dkv_kernel``
in interpret mode (block 64) and in ref mode (its oracle
``flash_attention_ref``),
on the same seeded numpy inputs and cotangent: GQA 4 over 2 and plain
heads, causal and not, ragged sequences, Dh 32 and 64, fp32 and bf16,
the ``hoist_scale`` rewrite. Also the plain backward against autograd
through the plain forward, and the op's argument checks.

Tolerances: fp32 outputs within 2e-5 and gradients (max |port - jax|
over max |jax|) within 1e-4 (fp32 sums in other orders); bf16 outputs
within 2e-2 of the fp32 JAX result on the same bf16-rounded inputs
(the port keeps probabilities fp32 through PV, the JAX oracle rounds
them to bf16; one bf16 rounding of outputs near 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.tune import runtime as jrt
from repro.tune import schedule as jschedule
from repro.tune.table import WinnerTable as JWinnerTable
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.tune import runtime as trt
from repro_torch.tune.schedule import Schedule, shape_bucket
from repro_torch.tune.table import WinnerTable

TOL_O = 2e-5
TOL_GRAD = 1e-4
TOL_BF16 = 2e-2


@pytest.fixture(autouse=True)
def _defaults():
    """Pure default schedules: no winner table leaks in or out."""
    trt.set_table(None)
    yield
    trt.reset()


def _inputs(B, Sq, Sk, H, KV, Dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, Dh)).astype(np.float32)
    g = rng.standard_normal((B, Sq, H, Dh)).astype(np.float32)
    return q, k, v, g


def _t(x, requires_grad=False, dtype=torch.float32):
    return torch.tensor(np.array(x, copy=True), dtype=dtype,
                        requires_grad=requires_grad)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_flash(mode, q, k, v, causal, hoist=False):
    """``repro.kernels.ops.flash_attention`` in ``mode`` (``interpret``:
    the Pallas kernels at block 64, differentiable through their
    recomputation backward; ``ref``: the oracle ``flash_attention_ref``),
    with the ``hoist_scale`` rewrite from a one-entry winner table."""
    table = JWinnerTable()
    table.put(jschedule.shape_bucket(
        "flash_attention", seq_len=q.shape[1], heads=q.shape[2],
        d_head=q.shape[3], dtype=q.dtype), jschedule.Schedule(
        "flash_attention", block_q=64, block_k=64, hoist_scale=hoist))
    jops.set_mode(mode, "flash_attention")
    try:
        with jrt.use_table(table):
            return jops.flash_attention(q, k, v, causal=causal, block_q=64,
                                        block_k=64)
    finally:
        jops.set_mode("auto", "flash_attention")


def _jax_fwd_grads(q, k, v, g, causal, hoist=False):
    """The JAX kernel path (interpret) and its vjp."""
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    out = _jax_flash("interpret", *args, causal, hoist)
    grads = jax.grad(lambda *a: (_jax_flash("interpret", *a, causal, hoist)
                                 * jnp.asarray(g)).sum(),
                     argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _port_fwd_grads(q, k, v, g, causal, **kw):
    leaves = [_t(x, requires_grad=True) for x in (q, k, v)]
    out = tops.flash_attention(*leaves, causal=causal, **kw)
    (out * _t(g)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


CASES = [  # (B, Sq, Sk, H, KV, Dh)
    (2, 128, 128, 4, 2, 32),     # GQA 4/2, Dh 32
    (1, 200, 200, 4, 2, 64),     # ragged S, Dh 64
    (2, 150, 96, 4, 4, 32),      # Sq != Sk, both ragged
    (1, 64, 64, 2, 1, 64),       # one KV head
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,Dh", CASES)
def test_flash_matches_jax_kernel_and_oracle(B, Sq, Sk, H, KV, Dh, causal):
    q, k, v, g = _inputs(B, Sq, Sk, H, KV, Dh)
    want_o, want_g = _jax_fwd_grads(q, k, v, g, causal)
    got_o, got_g = _port_fwd_grads(q, k, v, g, causal)
    np.testing.assert_allclose(got_o, want_o, atol=TOL_O, rtol=TOL_O)
    oracle = np.asarray(_jax_flash(
        "ref", *(jnp.asarray(x) for x in (q, k, v)), causal))
    np.testing.assert_allclose(got_o, oracle, atol=TOL_O, rtol=TOL_O)
    for name, a, b in zip("qkv", got_g, want_g):
        assert _rel(a, b) <= TOL_GRAD, f"d{name}: {_rel(a, b)}"


@pytest.mark.parametrize("block_q,block_k", [(64, 64), (128, 256), (48, 80)])
def test_flash_schedules_and_hoist_match_jax(block_q, block_k):
    """Any chunking of the plain version, with and without the hoisted
    scale, gives the JAX kernel's function (hoist_scale on both sides)."""
    q, k, v, g = _inputs(1, 200, 200, 4, 2, 32, seed=3)
    want_o, want_g = _jax_fwd_grads(q, k, v, g, True, hoist=True)
    for hoist in (False, True):
        winner = Schedule("flash_attention", block_q=block_q,
                          block_k=block_k, hoist_scale=hoist)
        table = WinnerTable(backend="cpu")
        table.put(shape_bucket("flash_attention", seq_len=200, heads=4,
                               d_head=32, dtype="float32"), winner)
        with trt.use_table(table):
            sched = tops.resolve_schedule("flash_attention", seq_len=200,
                                          heads=4, d_head=32,
                                          dtype=torch.float32)
            assert sched == winner
            got_o, got_g = _port_fwd_grads(q, k, v, g, True)
        np.testing.assert_allclose(got_o, want_o, atol=TOL_O, rtol=TOL_O)
        for name, a, b in zip("qkv", got_g, want_g):
            assert _rel(a, b) <= TOL_GRAD, f"d{name}: {_rel(a, b)}"


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_matches_jax(causal):
    """bf16 inputs: the port's plain path against the JAX kernel on the
    same bf16-rounded values, in fp32."""
    q, k, v, g = _inputs(1, 160, 160, 4, 2, 64, seed=5)
    qb, kb, vb = (_t(x, dtype=torch.bfloat16) for x in (q, k, v))
    out = tops.flash_attention(qb, kb, vb, causal=causal)
    assert out.dtype == torch.bfloat16
    rounded = [x.float().numpy() for x in (qb, kb, vb)]
    want = np.asarray(_jax_flash(
        "interpret", *(jnp.asarray(x) for x in rounded), causal))
    np.testing.assert_allclose(out.float().numpy(), want, atol=TOL_BF16,
                               rtol=TOL_BF16)
    leaves = [x.clone().requires_grad_() for x in (qb, kb, vb)]
    (tops.flash_attention(*leaves, causal=causal).float()
     * _t(g)).sum().backward()
    _, want_g = _jax_fwd_grads(*rounded, g, causal)
    for name, a, b in zip("qkv", leaves, want_g):
        assert a.grad.dtype == torch.bfloat16
        assert _rel(a.grad.float().numpy(), b) <= TOL_BF16, name


@pytest.mark.parametrize("hoist", [False, True])
def test_plain_backward_matches_autograd(hoist):
    """The explicit plain backward against autograd through the plain
    forward's own arithmetic (the reference oracle, differentiable)."""
    q, k, v, g = _inputs(2, 100, 100, 4, 2, 32, seed=7)
    leaves = [_t(x, requires_grad=True) for x in (q, k, v)]
    (tref.flash_attention_ref(*leaves, causal=True) * _t(g)).sum().backward()
    qt, kt, vt = (_t(x) for x in (q, k, v))
    out, lse = tref.flash_fwd(qt, kt, vt, causal=True, block_q=32,
                              block_k=48, hoist_scale=hoist, return_lse=True)
    got = tref.flash_bwd(qt, kt, vt, _t(g), out, lse, causal=True,
                         block_q=32, block_k=48, hoist_scale=hoist)
    for name, a, b in zip("qkv", got, leaves):
        assert _rel(a.numpy(), b.grad.numpy()) <= 1e-5, name


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_dense_softmax(causal):
    """O and lse of the plain forward against a dense softmax over the
    scaled scores, with Sk < Sq (under the causal mask the rows past Sk
    see every key, row 0 only key 0)."""
    q, k, v, _ = _inputs(1, 70, 40, 2, 2, 32, seed=9)
    qt, kt, vt = (_t(x) for x in (q, k, v))
    out, lse = tref.flash_fwd(qt, kt, vt, causal=causal, block_q=64,
                              block_k=16, return_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", qt, kt) * 32 ** -0.5
    if causal:
        keep = torch.arange(70)[:, None] >= torch.arange(40)[None, :]
        s = s.masked_fill(~keep, float("-inf"))
    torch.testing.assert_close(lse.view(1, 2, 70), torch.logsumexp(s, -1),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(
        out, torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vt),
        atol=TOL_O, rtol=TOL_O)


def test_check_launch_admits_defaults_and_refuses_the_rest():
    assert tfa.check_launch(32, 128, 128, torch.float32) is None
    assert tfa.check_launch(128, 128, 128, "bfloat16") is None
    assert tfa.check_launch(128, 64, 128, "float32") is None
    assert "shared memory" in tfa.check_launch(128, 128, 256, "float32")
    assert tfa.check_launch(64, 128, 256, "float32") is None
    assert "block_q=32" in tfa.check_launch(32, 32, 64, "float32")
    assert "block_q=256" in tfa.check_launch(32, 256, 64, "float32")
    assert "block_k=96" in tfa.check_launch(32, 64, 96, "float32")
    assert "Dh=48" in tfa.check_launch(48, 64, 64, "float32")
    assert "dtype" in tfa.check_launch(32, 64, 64, torch.float16)


@pytest.mark.parametrize("dtype,d_head,block_q,block_k,reason", [
    # bf16 runs the tensor-core forward: Dh 32/64/128, one or two
    # consumer warpgroups, a k/v stage of one TMA box (64, 128 or 256
    # rows) whose two-stage ring fits shared memory
    ("bfloat16", 128, 128, 128, None),
    ("bfloat16", 128, 64, 64, None),
    ("bfloat16", 128, 64, 128, None),
    ("bfloat16", 64, 64, 256, None),
    ("bfloat16", 64, 128, 256, None),
    ("bfloat16", 32, 128, 256, None),
    ("bfloat16", 32, 64, 64, None),
    ("bfloat16", 128, 128, 256, "shared memory"),
    ("bfloat16", 128, 64, 256, "shared memory"),
    ("bfloat16", 32, 64, 512, "TMA box"),
    ("bfloat16", 64, 128, 192, "block_k in (64, 128, 256)"),
    ("bfloat16", 32, 64, 96, "whole 64-row chunks"),
    ("bfloat16", 32, 32, 64, "block_q=32"),
    ("bfloat16", 32, 256, 64, "block_q=256"),
    ("bfloat16", 48, 64, 64, "Dh=48"),
    # fp32 stays on the CUDA-core forward, which takes wider stages
    ("float32", 32, 64, 512, None),
    ("float32", 64, 64, 192, None),
])
def test_check_launch_per_dtype(dtype, d_head, block_q, block_k, reason):
    """What each dtype's forward admits, and the reason it gives for what
    it refuses."""
    got = tfa.check_launch(d_head, block_q, block_k, dtype)
    if reason is None:
        assert got is None
    else:
        assert got is not None and reason in got, got
    assert tfa.check_launch(d_head, block_q, block_k,
                            getattr(torch, dtype)) == got


def test_op_checks_arguments_and_wrapper_takes_cuda_only():
    q, k, v, _ = _inputs(1, 64, 64, 4, 2, 32)
    qt, kt, vt = (_t(x) for x in (q, k, v))
    with pytest.raises(ValueError, match="impl"):
        tops.flash_attention(qt, kt, vt, impl="kernel")
    with pytest.raises(ValueError, match="KV dividing H"):
        tops.flash_attention(qt, _t(np.zeros((1, 64, 3, 32))),
                             _t(np.zeros((1, 64, 3, 32))))
    with pytest.raises(ValueError, match="dtype"):
        tops.flash_attention(qt, kt.double(), vt.double())
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        tfa.flash_attention_fwd(qt, kt, vt, block_q=128, block_k=128)


def test_reset_count_zeroes_every_counter():
    """One counter per kernel, the bf16 dQ's included, all zeroed."""
    names = ("launches", "dq_launches", "dkv_launches", "sm90_launches",
             "dq_sm90_launches", "dkv_sm90_launches")
    for i, name in enumerate(names):
        setattr(tfa, name, i + 1)
    tfa.reset_count()
    assert [getattr(tfa, name) for name in names] == [0] * len(names)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_wrappers_refuse_cpu_tensors(dtype):
    """The dQ and dK/dV wrappers launch a kernel or raise: on CPU tensors
    (bf16, whose dQ is the tensor-core kernel, and fp32) they raise
    before any build, and count nothing."""
    q, k, v, g = (_t(x, dtype=dtype) for x in _inputs(1, 64, 64, 4, 2, 32))
    lse = torch.zeros(4, 64)
    delta = torch.zeros(4, 64)
    tfa.reset_count()
    for wrapper in (tfa.dq_kernel, tfa.dkv_kernel):
        with pytest.raises(NotImplementedError, match="no kernel for device"):
            wrapper(q, k, v, g, lse, delta, True, False)
    assert (tfa.dq_launches, tfa.dq_sm90_launches, tfa.dkv_launches,
            tfa.dkv_sm90_launches) == (0, 0, 0, 0)
