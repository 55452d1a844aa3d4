"""The CUDA cluster-attention kernels (the forward, and the dQ and dK/dV
backward kernels) against their plain PyTorch versions, on the card. Skipped where there is no CUDA device. This file imports
neither jax nor the JAX package, so it also runs on a machine without
them:

  PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
      -m cuda tests/test_torch_cuda.py

Tolerances: O within 2e-5 in fp32 and 2e-2 in bf16 (one bf16 rounding of
outputs near 1), lse within 1e-4 (fp32 sums in another order). Gradients
dq, dk, dv and dbias: max |kernel - plain| within 1e-4 (fp32) or 1e-2
(bf16: one rounding of each output, and of each per-q-head dk/dv before
the GQA sum) of max |plain|.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import cluster_attention as tca
from repro_torch.kernels import cluster_attention_bwd as tcab
from repro_torch.kernels import ops, ref

from _torch_cases import graph_layout, per_graph_layout, qkv

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
TOL_GRAD = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


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
    lay = graph_layout()
    q, k, v, bias = qkv(1, lay.seq_len, 4, 4, 8)
    args = [torch.from_numpy(x).to(dev) for x in (q, k, v, lay.block_idx)]
    with pytest.raises(NotImplementedError, match="row 2"):
        ops.cluster_attention(*args)
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
