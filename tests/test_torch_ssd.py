"""The Mamba2 SSD scan of the port on the CPU: ``ops.ssd`` (its plain
version ``models/ssm.ssd_chunked``) against the JAX package's
``ops.ssd`` with the Pallas kernel ``_ssd_kernel`` in interpret mode and
against the JAX ``ssd_chunked``, y and the final state, on the same
seeded numpy inputs; the sequential recurrence (``ssd_decode_step``, port against
JAX and against the chunked scan); gradients of the plain version
against ``jax.grad`` of the JAX ``ssd_chunked``; and the op's checks: a
chunk that does not tile the sequence raises, and the kernel wrapper
takes CUDA tensors only.

Tolerances: y within 1e-4 and the state within 1e-4 of max |jax|
(fp32 sums in other orders: the Pallas kernel's cumulative sums are a
triangular matrix product, the port's a cumsum); gradients within 1e-4
of max |jax|; bf16 y within 2e-2 (one bf16 rounding of the output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import ssm as jssm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd as tssd
from repro_torch.models import ssm as tssm
from repro_torch.tune import runtime as trt

TOL = 1e-4
TOL_BF16 = 2e-2


@pytest.fixture(autouse=True)
def _defaults():
    trt.set_table(None)
    yield
    trt.reset()


def _inputs(B, S, H, dh, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 2)).astype(
        np.float32)
    a = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, a, b, c


def _t(x, dtype=torch.float32, requires_grad=False):
    return torch.tensor(np.array(x, copy=True), dtype=dtype,
                        requires_grad=requires_grad)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("B,S,H,dh,N,chunk", [
    (1, 256, 2, 8, 4, 256),     # the tuner's default case
    (2, 128, 3, 16, 8, 32),
    (1, 96, 2, 8, 16, 48),      # a chunk that is no power of two
    (2, 64, 2, 4, 4, 256),      # chunk above S: one chunk of S
])
def test_ssd_matches_jax_kernel_and_chunked(B, S, H, dh, N, chunk):
    args = _inputs(B, S, H, dh, N)
    y, state = tops.ssd(*(_t(x) for x in args), chunk=chunk)
    jargs = [jnp.asarray(x) for x in args]
    jops.set_mode("interpret", "ssd")
    try:   # the JAX dispatcher falls back unless the chunk tiles S
        jy, js = jops.ssd(*jargs, chunk=min(chunk, S))
    finally:
        jops.set_mode("auto", "ssd")
    ry, rs = jssm.ssd_chunked(*jargs, chunk)
    for want_y, want_s in ((jy, js), (ry, rs)):
        assert _rel(y.numpy(), want_y) <= TOL
        assert _rel(state.numpy(), want_s) <= TOL
    assert y.shape == (B, S, H, dh) and state.shape == (B, H, dh, N)


def test_ssd_bf16_matches_jax():
    args = _inputs(1, 128, 2, 8, 4, seed=2)
    xb, bb, cb = (_t(x, torch.bfloat16) for x in (args[0], args[3],
                                                   args[4]))
    y, state = tops.ssd(xb, _t(args[1]), _t(args[2]), bb, cb, chunk=64)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    rounded = [xb.float().numpy(), args[1], args[2], bb.float().numpy(),
               cb.float().numpy()]
    jy, js = jssm.ssd_chunked(*(jnp.asarray(x) for x in rounded), 64)
    assert _rel(y.float().numpy(), jy) <= TOL_BF16
    assert _rel(state.numpy(), js) <= TOL


def test_ssd_chunking_is_the_same_function():
    """Every chunk the tuner may pick gives the same y and state."""
    args = [_t(x) for x in _inputs(1, 512, 2, 8, 4, seed=4)]
    y0, s0 = tops.ssd(*args, chunk=256)
    for chunk in (64, 128, 512):
        y, s = tops.ssd(*args, chunk=chunk)
        assert _rel(y.numpy(), y0.numpy()) <= TOL
        assert _rel(s.numpy(), s0.numpy()) <= TOL


def test_ssd_sequential_recurrence():
    """Token by token, ``ssd_decode_step`` (port and JAX) reproduces the
    chunked scan's y and final state."""
    B, S, H, dh, N = 2, 24, 2, 4, 3
    x, dt, a, b, c = _inputs(B, S, H, dh, N, seed=6)
    y_ref, s_ref = tssm.ssd_chunked(*(_t(v) for v in (x, dt, a, b, c)), 8)
    state = torch.zeros((B, H, dh, N))
    jstate = jnp.zeros((B, H, dh, N))
    ys = []
    for s in range(S):
        y, state = tssm.ssd_decode_step(state, _t(x[:, s]), _t(dt[:, s]),
                                        _t(a), _t(b[:, s]), _t(c[:, s]))
        jy, jstate = jssm.ssd_decode_step(
            jstate, *(jnp.asarray(v) for v in (x[:, s], dt[:, s], a, b[:, s],
                                               c[:, s])))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5)
        ys.append(y)
    assert _rel(torch.stack(ys, 1).numpy(), y_ref.numpy()) <= TOL
    assert _rel(state.numpy(), s_ref.numpy()) <= TOL
    assert _rel(np.asarray(jstate), s_ref.numpy()) <= TOL


def test_ssd_plain_gradients_match_jax():
    """The CPU plain version stays differentiable, as the reference's
    ref path: gradients in x, dt, a, b, c against jax.grad."""
    args = _inputs(1, 64, 2, 4, 3, seed=8)
    g = np.random.default_rng(9).standard_normal((1, 64, 2, 4)).astype(
        np.float32)
    leaves = [_t(x, requires_grad=True) for x in args]
    y, _ = tops.ssd(*leaves, chunk=16)
    (y * _t(g)).sum().backward()
    jgrads = jax.grad(lambda *v: (jssm.ssd_chunked(*v, 16)[0]
                                  * jnp.asarray(g)).sum(),
                      argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(x)
                                                 for x in args))
    for name, leaf, want in zip(("x", "dt", "a", "b", "c"), leaves, jgrads):
        assert _rel(leaf.grad.numpy(), want) <= TOL, name


def test_ssd_untiled_chunk_raises_and_wrapper_takes_cuda_only():
    args = [_t(x) for x in _inputs(1, 96, 2, 4, 3)]
    with pytest.raises(ValueError, match="not tiled by chunk 64"):
        tops.ssd(*args, chunk=64)
    with pytest.raises(ValueError, match="impl"):
        tops.ssd(*args, chunk=32, impl="kernel")
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        tssd.ssd_fwd(*args, chunk=32)


def test_ssd_check_launch():
    assert tssd.check_launch(64, 128, 256, torch.bfloat16) is None
    assert tssd.check_launch(8, 4, 512, "float32") is None
    assert "dh=128" in tssd.check_launch(128, 128, 256, "float32")
    assert "chunk=2048" in tssd.check_launch(64, 16, 2048, "float32")
    # the chunk-parallel kernels stream N in 64-wide tiles: no N is too
    # wide for their shared memory
    assert tssd.check_launch(64, 512, 256, "float32") is None
    assert "dtype" in tssd.check_launch(64, 16, 256, torch.float16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq_len,d_head,n_state", [
    (16384, 64, 128),   # Mamba2-2.7B's width, the tune phase's full case
    (256, 8, 4),        # the reference's default case
])
def test_ssd_tuner_candidates_all_launch(dtype, seq_len, d_head, n_state):
    """Every chunk the tuner offers (64, 128, 256, 512) passes the kernels'
    ``check_launch`` at the tune phase's shapes in both dtypes: the
    enumerator prunes none of them."""
    from repro_torch.tune.schedule import enumerate_schedules

    pruned = []
    cands = enumerate_schedules("ssd", {"seq_len": seq_len,
                                        "d_head": d_head,
                                        "n_state": n_state,
                                        "dtype": dtype}, pruned)
    assert pruned == []
    for chunk in (64, 128, 256, 512):
        assert tssd.check_launch(d_head, n_state, min(chunk, seq_len),
                                 dtype) is None
    want = {min(ch, seq_len) for ch in (64, 128, 256, 512)}
    assert {min(c.chunk, seq_len) for c in cands} == want
