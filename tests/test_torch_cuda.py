"""The CUDA cluster-attention kernels (the biased forward, dQ and dK/dV
kernels of the graph path, and the unbiased, optionally causal ones of
the LM path) against their plain PyTorch versions, on the card. Skipped
where there is no CUDA device. This file imports neither jax nor the
JAX package, so it also runs on a machine without them:

  PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
      -m cuda tests/test_torch_cuda.py

Tolerances: O within 2e-5 in fp32 and 2e-2 in bf16 (one bf16 rounding of
outputs near 1); the unbiased O, whose rows average many keys and lie
mostly far below 1, also element by element within 1e-5 + 2^-7 |plain|
in bf16 (both sides round an fp32 value once: at most one bf16 ulp
apart); lse within 1e-4 (fp32 sums in another order). Gradients
dq, dk, dv and dbias: max |kernel - plain| within 1e-4 (fp32) or 1e-2
(bf16: one rounding of each output, and of each per-q-head dk/dv before
the GQA sum) of max |plain|.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.reformation import lm_local_global_layout
from repro_torch.kernels import cluster_attention as tca
from repro_torch.kernels import cluster_attention_bwd as tcab
from repro_torch.kernels import ops, ref

from _torch_cases import graph_layout, per_graph_layout, qkv

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
TOL_GRAD = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
TOL_O_BF16 = (1e-5, 2 ** -7)   # unbiased O, bf16: (atol, rtol)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _run(dev, dtype, q, k, v, bi, bu, bias):
    args = [torch.from_numpy(np.array(x, copy=True)).to(dev)
            for x in (q, k, v, bi, bu, bias)]
    for i in range(3):
        args[i] = args[i].to(dtype)
    before = tca.launches
    o, lse = ops.cluster_attention(*args, return_lse=True)
    torch.cuda.synchronize()
    assert tca.launches == before + 1
    po, plse = ops.cluster_attention(*args, return_lse=True, impl="plain")
    assert tca.launches == before + 1
    torch.testing.assert_close(o.float(), po.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
    return o


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,Dh", [(4, 4, 8), (8, 2, 24), (4, 1, 64)])
@pytest.mark.parametrize("per_graph", [False, True])
def test_kernel_matches_plain_graph_layout(dev, dtype, H, KV, Dh,
                                           per_graph):
    if per_graph:
        S, bi, bu, nb = per_graph_layout()
    else:
        lay = graph_layout()
        S, bi, bu, nb = lay.seq_len, lay.block_idx, lay.buckets, \
            lay.n_buckets
    q, k, v, bias = qkv(2, S, H, KV, Dh, n_buckets=nb)
    _run(dev, dtype, q, k, v, bi, bu, bias)


def test_kernel_dead_rows_and_full_layout(dev):
    lay = graph_layout(bq=16, d_b=4)
    bi, bu = lay.block_idx.copy(), lay.buckets.copy()
    bi[2] = -1
    bu[3] = -1
    q, k, v, bias = qkv(1, lay.seq_len, 4, 4, 8, n_buckets=lay.n_buckets)
    o = _run(dev, torch.float32, q, k, v, bi, bu, bias)
    assert not o[:, 2 * 16:4 * 16].any()
    S, bq = 256, 64
    nq = S // bq
    bi = np.tile(np.arange(nq, dtype=np.int32)[None], (nq, 1))
    bu = np.zeros((nq, nq, bq, bq), np.int8)
    q, k, v, bias = qkv(1, S, 2, 2, 24)
    _run(dev, torch.float32, q, k, v, bi, bu, bias)


def test_kernel_rejects_unported_variants(dev):
    """fp16 is no kernel's dtype; the unbiased kernels take Dh 64 or 128,
    q-blocks in multiples of 64 rows and the batch-shared 2-D layout,
    and say so with the shapes."""
    lay = graph_layout()
    q, k, v, bias = qkv(1, lay.seq_len, 4, 4, 8)
    args = [torch.from_numpy(x).to(dev) for x in (q, k, v, lay.block_idx)]
    with pytest.raises(NotImplementedError, match="Dh in"):
        ops.cluster_attention(*args)
    lm = lm_local_global_layout(512, window=128, n_global=128)
    bi = torch.from_numpy(lm.block_idx).to(dev)
    q, k, v, _ = qkv(2, lm.seq_len, 4, 2, 32)
    q, k, v = (torch.from_numpy(x).to(dev) for x in (q, k, v))
    with pytest.raises(NotImplementedError, match="Dh in"):
        ops.cluster_attention(q, k, v, bi, causal=True)
    q, k, v, _ = qkv(2, lm.seq_len, 4, 2, 64)
    q, k, v = (torch.from_numpy(x).to(dev) for x in (q, k, v))
    with pytest.raises(NotImplementedError, match="batch-shared"):
        ops.cluster_attention(q, k, v, torch.stack([bi, bi]), causal=True)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        ops.cluster_attention(*[a.half() for a in args[:3]], args[3],
                              torch.from_numpy(lay.buckets).to(dev))


def _run_bwd(dev, dtype, q, k, v, bi, bu, bias, bit=None, names=4):
    """Gradients through the op on the card (the forward kernel, then the
    dQ and dK/dV kernels) against the plain backward on the same inputs,
    the first ``names`` of (dq, dk, dv, dbias); returns the kernel's."""
    args = [torch.from_numpy(np.array(x, copy=True)).to(dev)
            for x in (q, k, v, bi, bu, bias)]
    for i in range(3):
        args[i] = args[i].to(dtype)
    q, k, v, bi, bu, bias = args
    bit = None if bit is None else torch.from_numpy(bit).to(dev)
    out, lse = ops.cluster_attention(q, k, v, bi, bu, bias,
                                     return_lse=True)
    gen = torch.Generator(device=dev).manual_seed(7)
    dout = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
    leaves = [x.detach().requires_grad_() for x in (q, k, v, bias)]
    before = (tcab.dq_launches, tcab.dkv_launches)
    o = ops.cluster_attention(*leaves[:3], bi, bu, leaves[3], bit)
    got = torch.autograd.grad(o, leaves, dout)
    torch.cuda.synchronize()
    assert (tcab.dq_launches, tcab.dkv_launches) == (before[0] + 1,
                                                     before[1] + 1)
    want = ref.cluster_attention_bwd(q, k, v, dout, out, lse, bi, bu, bias,
                                     bit)
    for name, g, w in list(zip(("dq", "dk", "dv", "dbias"), got,
                               want))[:names]:
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        rel = ((g.float() - w.float()).abs().max()
               / w.float().abs().max().clamp_min(1e-30)).item()
        assert rel <= TOL_GRAD[dtype], (name, rel)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,Dh", [(4, 4, 8), (8, 2, 24)])
@pytest.mark.parametrize("per_graph", [False, True])
def test_bwd_kernels_match_plain_graph_layout(dev, dtype, H, KV, Dh,
                                              per_graph):
    """Shared 2-D layout with the host-built transposed layout, per-graph
    3-D layouts with the derived one; GQA and Dh 8/24."""
    if per_graph:
        S, bi, bu, nb = per_graph_layout()
        bit = None
    else:
        lay = graph_layout()
        S, bi, bu, nb = lay.seq_len, lay.block_idx, lay.buckets, \
            lay.n_buckets
        bit = lay.block_idx_t
    q, k, v, bias = qkv(2, S, H, KV, Dh, n_buckets=nb)
    _run_bwd(dev, dtype, q, k, v, bi, bu, bias, bit)


def test_bwd_kernels_dead_rows_and_full_layout(dev):
    lay = graph_layout(bq=16, d_b=4)
    bi, bu = lay.block_idx.copy(), lay.buckets.copy()
    bi[2] = -1
    bu[3] = -1
    q, k, v, bias = qkv(1, lay.seq_len, 4, 4, 8, n_buckets=lay.n_buckets)
    dq = _run_bwd(dev, torch.float32, q, k, v, bi, bu, bias)[0]
    assert not dq[:, 2 * 16:4 * 16].any()
    S, bq = 256, 64
    nq = S // bq
    bi = np.tile(np.arange(nq, dtype=np.int32)[None], (nq, 1))
    bu = np.zeros((nq, nq, bq, bq), np.int8)
    q, k, v, bias = qkv(1, S, 2, 2, 24)
    dbias = _run_bwd(dev, torch.float32, q, k, v, bi, bu, bias, names=3)[3]
    # one bucket everywhere shifts every score of a row alike, which the
    # softmax cancels: the bias gradient is zero up to rounding
    assert dbias.abs().max().item() < 1e-4


def _run_unbiased(dev, dtype, q, k, v, bi, bit, causal):
    """The unbiased op on the card (forward kernel, then under autograd
    the dQ and dK/dV kernels) against the plain versions on the same
    inputs: O, lse, dq, dk and dv."""
    q, k, v = (torch.from_numpy(x).to(dev).to(dtype) for x in (q, k, v))
    bi = torch.from_numpy(np.array(bi, copy=True)).to(dev)
    bit = None if bit is None else torch.from_numpy(
        np.array(bit, copy=True)).to(dev)
    before = tca.unbiased_launches
    o, lse = ops.cluster_attention(q, k, v, bi, causal=causal,
                                   return_lse=True)
    assert tca.unbiased_launches == before + 1
    po, plse = ops.cluster_attention(q, k, v, bi, causal=causal,
                                     return_lse=True, impl="plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), po.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if dtype == torch.bfloat16:
        atol, rtol = TOL_O_BF16
        torch.testing.assert_close(o.float(), po.float(), atol=atol,
                                   rtol=rtol)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
    gen = torch.Generator(device=dev).manual_seed(7)
    dout = torch.randn(o.shape, generator=gen, device=dev).to(dtype)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    counts = (tca.unbiased_launches, tcab.dq_unbiased_launches,
              tcab.dkv_unbiased_launches)
    out = ops.cluster_attention(*leaves, bi, None, None, bit, causal=causal)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert (tca.unbiased_launches, tcab.dq_unbiased_launches,
            tcab.dkv_unbiased_launches) == tuple(c + 1 for c in counts)
    want = ref.cluster_attention_bwd(q, k, v, dout, o, lse, bi, None, None,
                                     bit, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        rel = ((g.float() - w.float()).abs().max()
               / w.float().abs().max().clamp_min(1e-30)).item()
        assert rel <= TOL_GRAD[dtype], (name, rel)
    return o, got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV,Dh", [(4, 2, 128), (9, 3, 64), (4, 4, 64)])
@pytest.mark.parametrize("with_bit", [True, False])
def test_unbiased_kernels_match_plain_lm_layout(dev, dtype, causal, H, KV,
                                                Dh, with_bit):
    """The LM local+global layout (S=1024, window 256, one global
    block), causal or not, GQA and not, Dh 128/64, with the host-built
    transposed layout and without (derived)."""
    lay = lm_local_global_layout(1024, window=256, n_global=128,
                                 causal=causal)
    q, k, v, _ = qkv(1, lay.seq_len, H, KV, Dh)
    _run_unbiased(dev, dtype, q, k, v, lay.block_idx,
                  lay.block_idx_t if with_bit else None, causal)


def test_unbiased_kernels_batch_and_dead_row(dev):
    """B=2 on the shared 2-D layout, then with a dead q-block row (O, dq
    zero there in both sequences)."""
    lay = lm_local_global_layout(512, window=128, n_global=128)
    q, k, v, _ = qkv(2, lay.seq_len, 4, 2, 64, seed=3)
    _run_unbiased(dev, torch.float32, q, k, v, lay.block_idx,
                  lay.block_idx_t, True)
    bi = np.array(lay.block_idx, copy=True)
    bi[2] = -1
    o, (dq, _, _) = _run_unbiased(dev, torch.float32, q, k, v, bi, None,
                                  True)
    assert not o[:, 256:384].any() and not dq[:, 256:384].any()
