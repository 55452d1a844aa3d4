"""The CUDA cluster-attention kernel against its plain PyTorch version, on
the card. Skipped where there is no CUDA device. This file imports
neither jax nor the JAX package, so it also runs on a machine without
them:

  PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
      -m cuda tests/test_torch_cuda.py

Tolerances: O within 2e-5 in fp32 and 2e-2 in bf16 (one bf16 rounding of
outputs near 1), lse within 1e-4 (fp32 sums in another order).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import cluster_attention as tca
from repro_torch.kernels import ops

from _torch_cases import graph_layout, per_graph_layout, qkv

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


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
