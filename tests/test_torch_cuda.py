"""The CUDA kernels against their plain PyTorch versions, on the card: the
cluster-attention kernels (the biased forward, dQ and dK/dV kernels of
the graph path, in bf16 on the tensor cores at 32 x 32 and at the
graph-level task's 16 x 16 blocks; and
the unbiased, optionally causal ones of the LM path and of the
mask-free graph batch (a layout per sequence, head dims 8 to 64), in
bf16 the forward, dQ and dK/dV on the tensor cores, and the scale run
through them; each under every value of
the schedule's ``hoist_scale`` and, biased, ``fuse_bias``),
the dense flash
forward, dQ and dK/dV kernels (bf16 on the tensor cores, fp32 on CUDA
cores), and the SSD scan.
Skipped where there is no CUDA device. This file imports neither jax nor the
JAX package, so it also runs on a machine without them:

  PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
      -m cuda tests/test_torch_cuda.py

Tolerances: O within 2e-5 in fp32 and 2e-2 in bf16 (one bf16 rounding of
outputs near 1); the unbiased O, whose rows average many keys and lie
mostly far below 1, also element by element within 1e-5 + 2^-7 |plain|
in bf16 (both sides round an fp32 value once: at most one bf16 ulp
apart), and the bf16 flash O the same; lse within 1e-4 (fp32 sums in another order). Gradients
dq, dk, dv and dbias: max |kernel - plain| within 1e-4 (fp32) or 1e-2
(bf16: one rounding of each output, and of each per-q-head dk/dv before
the GQA sum) of max |plain|; the flash kernels the same. SSD: y within
1e-4 (fp32) or 2e-2 (bf16) of max |plain|, the fp32 state within 1e-4.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import graph_model as tgm
from repro_torch.core.reformation import (lm_local_global_layout,
                                          transpose_block_idx)
from repro_torch.kernels import cluster_attention as tca
from repro_torch.kernels import cluster_attention_bwd as tcab
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as tkssd

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


def _fwd_counts():
    return tca.launches, tca.sm90_launches


def _run(dev, dtype, q, k, v, bi, bu, bias):
    """The biased forward on the card against the plain version: bf16
    runs the tensor-core kernel, fp32 the CUDA-core one, each counted on
    its own counter. Returns O and lse."""
    args = [torch.from_numpy(np.array(x, copy=True)).to(dev)
            for x in (q, k, v, bi, bu, bias)]
    for i in range(3):
        args[i] = args[i].to(dtype)
    before = _fwd_counts()
    want = (before[0], before[1] + 1) if dtype == torch.bfloat16 else (
        before[0] + 1, before[1])
    o, lse = ops.cluster_attention(*args, return_lse=True)
    torch.cuda.synchronize()
    assert _fwd_counts() == want
    po, plse = ops.cluster_attention(*args, return_lse=True, impl="plain")
    assert _fwd_counts() == want
    torch.testing.assert_close(o.float(), po.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
    return o, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,Dh", [(4, 4, 8), (4, 4, 16), (8, 2, 24),
                                     (4, 1, 64)])
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
    o = _run(dev, torch.float32, q, k, v, bi, bu, bias)[0]
    assert not o[:, 2 * 16:4 * 16].any()
    S, bq = 256, 64
    nq = S // bq
    bi = np.tile(np.arange(nq, dtype=np.int32)[None], (nq, 1))
    bu = np.zeros((nq, nq, bq, bq), np.int8)
    q, k, v, bias = qkv(1, S, 2, 2, 24)
    _run(dev, torch.float32, q, k, v, bi, bu, bias)


def test_kernel_rejects_unported_variants(dev):
    """fp16 is no kernel's dtype; the unbiased kernels take Dh a multiple
    of 8 up to 64, or 128, q-blocks in multiples of 64 rows (the bf16
    forward: of 128 rows exactly), and a layout shared by the batch or
    one per sequence, and say so with the shapes."""
    lay = graph_layout()
    q, k, v, bias = qkv(1, lay.seq_len, 4, 4, 8)
    args = [torch.from_numpy(x).to(dev) for x in (q, k, v, lay.block_idx)]
    with pytest.raises(NotImplementedError, match="a multiple of 64"):
        ops.cluster_attention(*args)
    lm = lm_local_global_layout(512, window=128, n_global=128)
    bi = torch.from_numpy(lm.block_idx).to(dev)
    q, k, v, _ = qkv(2, lm.seq_len, 4, 2, 12)
    q, k, v = (torch.from_numpy(x).to(dev) for x in (q, k, v))
    with pytest.raises(NotImplementedError, match="Dh=12"):
        ops.cluster_attention(q, k, v, bi, causal=True)
    q, k, v, _ = qkv(2, lm.seq_len, 4, 2, 64)
    q, k, v = (torch.from_numpy(x).to(dev) for x in (q, k, v))
    bf = [x.bfloat16() for x in (q, k, v)]
    # a layout per sequence launches the kernels of either dtype
    before = (tca.unbiased_launches, tca.unbiased_sm90_launches)
    ops.cluster_attention(q, k, v, torch.stack([bi, bi]), causal=True)
    ops.cluster_attention(*bf, torch.stack([bi, bi]), causal=True)
    assert (tca.unbiased_launches, tca.unbiased_sm90_launches) == (
        before[0] + 1, before[1] + 1)
    lm64 = lm_local_global_layout(512, bq=64, bk=64, window=128,
                                  n_global=64)
    bi64 = torch.from_numpy(lm64.block_idx).to(dev)
    with pytest.raises(NotImplementedError, match=r"bq=bk=64 \(the bf16 "
                       r"forward takes bq = bk = 128.*\(2, 512, 4, 64\)"):
        ops.cluster_attention(*bf, bi64, causal=True)
    q12, k12, v12, _ = qkv(2, lm.seq_len, 4, 2, 12)
    with pytest.raises(NotImplementedError, match=r"Dh=12.*bfloat16"):
        ops.cluster_attention(*(torch.from_numpy(x).to(dev).bfloat16()
                                for x in (q12, k12, v12)), bi, causal=True)
    # fp32 takes the 64-row blocks the bf16 forward refuses
    before = tca.unbiased_launches
    ops.cluster_attention(q, k, v, bi64, causal=True)
    assert tca.unbiased_launches == before + 1
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        ops.cluster_attention(*[a.half() for a in args[:3]], args[3],
                              torch.from_numpy(lay.buckets).to(dev))


def _bwd_counts():
    return (tcab.dq_launches, tcab.dq_sm90_launches, tcab.dkv_launches,
            tcab.dkv_sm90_launches)


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
    before = _bwd_counts()
    o = ops.cluster_attention(*leaves[:3], bi, bu, leaves[3], bit)
    got = torch.autograd.grad(o, leaves, dout)
    torch.cuda.synchronize()
    # dQ and dK/dV on the tensor cores in bf16, on CUDA cores in fp32
    sm90 = dtype == torch.bfloat16
    assert _bwd_counts() == (before[0] + (not sm90), before[1] + sm90,
                             before[2] + (not sm90), before[3] + sm90)
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
@pytest.mark.parametrize("H,KV,Dh", [(4, 4, 8), (4, 4, 16), (8, 2, 24),
                                     (4, 1, 64)])
@pytest.mark.parametrize("per_graph", [False, True])
def test_bwd_kernels_match_plain_graph_layout(dev, dtype, H, KV, Dh,
                                              per_graph):
    """Shared 2-D layout with the host-built transposed layout, per-graph
    3-D layouts with the derived one; GQA and Dh 8/16/24/64."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_biased_kernels_dead_and_fully_masked_rows(dev, dtype):
    """A q-block row with no visit (row 2) and one whose visits are all
    masked (row 3) write O = 0 and lse = 0 and get dq = 0; the rest of
    the gradients match the plain backward, in both dtypes' kernels."""
    lay = graph_layout()
    bi, bu = lay.block_idx.copy(), lay.buckets.copy()
    bi[2] = -1
    bu[3] = -1
    q, k, v, bias = qkv(2, lay.seq_len, 4, 2, 24, n_buckets=lay.n_buckets)
    o, lse = _run(dev, dtype, q, k, v, bi, bu, bias)
    assert not o[:, 2 * 32:4 * 32].any()
    assert not lse.view(2, 4, -1)[:, :, 2 * 32:4 * 32].any()
    dq = _run_bwd(dev, dtype, q, k, v, bi, bu, bias,
                  transpose_block_idx(bi, lay.seq_len // 32))[0]
    assert not dq[:, 2 * 32:4 * 32].any()


def _heavy_layout(nq=24, nb=5, seed=3, blk=32):
    """q-block row 0 visits every k-block; every row visits k-block 0
    (so k-block 0's column holds every q-row); the other rows visit
    their own block and two more, in shuffled slots, -1 padded to
    mb = nq; random buckets with some masked entries; blocks of
    ``blk`` x ``blk``."""
    rng = np.random.default_rng(seed)
    bi = np.full((nq, nq), -1, np.int32)
    bi[0] = rng.permutation(nq)
    for i in range(1, nq):
        row = [0, i] + list(rng.choice(np.arange(1, nq), 4, replace=False))
        row = list(dict.fromkeys(row))[:4]
        slots = rng.choice(nq, len(row), replace=False)
        bi[i, slots] = row
    bu = rng.integers(-1, nb + 1, (nq, nq, blk, blk)).astype(np.int8)
    return blk * nq, bi, bu, nb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bit", [True, False])
def test_biased_kernels_heavy_row_and_column(dev, dtype, with_bit):
    """One row that visits every k-block and one column that every q-row
    visits, with -1 slots between the visits; buckets past nb - 1 clip
    onto the last bias. The host-built and the derived transposed
    layouts give the same gradients."""
    S, bi, bu, nb = _heavy_layout()
    q, k, v, bias = qkv(1, S, 8, 2, 24, n_buckets=nb)
    _run(dev, dtype, q, k, v, bi, bu, bias)
    _run_bwd(dev, dtype, q, k, v, bi, bu, bias,
             transpose_block_idx(bi, S // 32) if with_bit else None)


@pytest.mark.parametrize("per_graph", [False, True])
def test_biased_bf16_forward_splits_the_heavy_row(dev, per_graph):
    """A q-block row that visits 160 k-blocks among rows of at most 4:
    the bf16 forward cuts it into pieces (its plan says so) and merges
    their partial slots; O, lse and the gradients through it match the
    plain versions. Per-graph layouts: one such row in each graph."""
    layouts = [_heavy_layout(nq=160, seed=s) for s in (3, 4)]
    S, nb = layouts[0][0], layouts[0][3]
    if per_graph:
        bi = np.stack([x[1] for x in layouts])
        bu = np.stack([x[2] for x in layouts])
    else:
        bi, bu = layouts[0][1], layouts[0][2]
    plan = tca.fwd_plan(torch.from_numpy(bi).to(dev), 2)
    assert plan is not None and plan[2] >= 3
    q, k, v, bias = qkv(2, S, 8, 2, 24, n_buckets=nb)
    _run(dev, torch.bfloat16, q, k, v, bi, bu, bias)
    _run_bwd(dev, torch.bfloat16, q, k, v, bi, bu, bias)


def _dq_case(dev, bi, bu, B, H, KV, Dh, nb, seed):
    """The bf16 dQ kernel's operands on the card: q, k, v, a random dO,
    the forward kernel's lse and O's delta, the layout and a bias
    table of ``nb`` columns."""
    S = bi.shape[-2] * 32
    q, k, v, bias = qkv(B, S, H, KV, Dh, seed=seed, n_buckets=nb)
    q, k, v = (torch.from_numpy(x).to(dev).bfloat16() for x in (q, k, v))
    bi, bu, bias = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                    for x in (bi, bu, bias))
    out, lse = tca.cluster_attention_fwd(q, k, v, bi, bu, bias,
                                         return_lse=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dout = torch.randn(out.shape, generator=gen, device=dev).bfloat16()
    return q, k, v, dout, lse, ref.row_delta(dout, out), bi, bu, bias


def _check_dq(dq, db_part, q, k, v, dout, lse, delta, bi, bu, bias):
    """dq and the bias gradient summed from the kernel's partials against
    ``ref.bwd_dq``, each within TOL_GRAD of its largest plain value."""
    want_dq, want_db = ref.bwd_dq(q, k, v, dout, lse, delta, bi, bu, bias)
    got_db = db_part.sum(dim=(0, 2))
    for name, g, w in (("dq", dq, want_dq), ("dbias", got_db, want_db)):
        assert torch.isfinite(g).all(), name
        rel = ((g.float() - w.float()).abs().max()
               / w.float().abs().max().clamp_min(1e-30)).item()
        assert rel <= TOL_GRAD[torch.bfloat16], (name, rel)


@pytest.mark.parametrize("nb", [1, 3, 18])
@pytest.mark.parametrize("Dh", [8, 24, 64])
@pytest.mark.parametrize("per_graph", [False, True])
def test_biased_bf16_dq_matches_plain(dev, nb, Dh, per_graph):
    """The bf16 tensor-core dQ and its bucket sums against ``ref.bwd_dq``
    at GQA (8 heads over 2), n_buckets 1 (GT's table), 3 (adjacency) and
    18 (SPD), with buckets past nb - 1 (clipped onto the last bias), -1
    holes between a row's visits, a row with no visit and one whose
    visits are all masked; 2-D and per-graph 3-D layouts."""
    rng = np.random.default_rng(nb + Dh)
    if per_graph:
        _, bi, _, _ = per_graph_layout()
    else:
        bi = graph_layout().block_idx[None]
    bi = bi.copy()
    nq, mb = bi.shape[-2:]
    # holes: a -1 slot before and between the visits of every row
    bi = np.concatenate([np.full(bi.shape[:-1] + (1,), -1, np.int32), bi,
                         np.full(bi.shape[:-1] + (1,), -1, np.int32)], -1)
    bi[..., 1::3] = np.where(rng.random(bi[..., 1::3].shape) < 0.3, -1,
                             bi[..., 1::3])
    bi[:, 2] = -1
    bu = rng.integers(-1, nb + 2, bi.shape + (32, 32)).astype(np.int8)
    bu[:, 3] = -1
    if not per_graph:
        bi, bu = bi[0], bu[0]
    ops_ = _dq_case(dev, bi, bu, 2, 8, 2, Dh, nb, seed=nb)
    before = _bwd_counts()
    dq, db_part = tcab.dq_kernel(*ops_)
    torch.cuda.synchronize()
    assert _bwd_counts() == (before[0], before[1] + 1) + before[2:]
    assert not dq[:, 2 * 32:4 * 32].any()
    _check_dq(dq, db_part, *ops_)


@pytest.mark.parametrize("per_graph", [False, True])
def test_biased_bf16_dq_splits_the_heavy_row(dev, per_graph):
    """A q-block row that visits 160 k-blocks among rows of at most 4:
    the bf16 dQ runs it as pieces whose partial dq and bucket sums a
    combine kernel adds in slot order, and matches the plain dQ."""
    layouts = [_heavy_layout(nq=160, seed=s) for s in (3, 4)]
    if per_graph:
        bi = np.stack([x[1] for x in layouts])
        bu = np.stack([x[2] for x in layouts])
    else:
        bi, bu = layouts[0][1], layouts[0][2]
    ops_ = _dq_case(dev, bi, bu, 2, 8, 2, 24, layouts[0][3], seed=5)
    plan = tca.fwd_plan(ops_[6], 2)
    assert plan is not None and plan[2] >= 3
    dq, db_part = tcab.dq_kernel(*ops_)
    torch.cuda.synchronize()
    _check_dq(dq, db_part, *ops_)


def test_biased_dq_sources_refuse_what_they_do_not_take(dev):
    """The fp32 CUDA-core source returns invalid value for bf16, and the
    bf16 tensor-core source for Dh 12 and 8-row blocks: neither
    launches."""
    lay = graph_layout()
    ops_ = _dq_case(dev, lay.block_idx, lay.buckets, 1, 4, 4, 24,
                    lay.n_buckets, seed=1)
    q, k, v, dout, lse, delta, bi, bu, bias = ops_
    B, S, H, Dh = q.shape
    nq, mb = bi.shape
    ptrs = [x.data_ptr() for x in ops_]
    dq = torch.empty_like(q)
    db = torch.empty((B, H, nq, lay.n_buckets), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    err = tcab.LIBRARY.lib().cluster_attention_bwd_dq(
        *ptrs, dq.data_ptr(), db.data_ptr(), 1, B, S, H, H, Dh, nq, mb, 32,
        32, lay.n_buckets, 0, 0, 0, Dh ** -0.5, stream)
    assert err == 1   # cudaErrorInvalidValue
    lib = tcab.LIBRARY_DQ_SM90.lib()
    for dh, bq in ((12, 32), (24, 8)):
        err = lib.cluster_attention_bwd_dq_sm90(
            *ptrs, None, None, dq.data_ptr(), db.data_ptr(), None, None, B,
            S, H, H, dh, S // bq, mb, bq, bq, lay.n_buckets, 0, 0, 0, 0,
            Dh ** -0.5, stream)
        assert err == 1, (dh, bq)


def test_biased_bf16_refuses_what_its_kernels_do_not_take(dev):
    """The bf16 kernels take bq = bk = 16 or 32 and Dh a multiple of 8 up
    to 64: anything else raises with the dtype and the shapes before any
    launch, forward or backward; fp32 takes the same call on CUDA
    cores."""
    lay = graph_layout(bq=8, d_b=4)
    q, k, v, bias = qkv(1, lay.seq_len, 4, 4, 8, n_buckets=lay.n_buckets)
    q, k, v = (torch.from_numpy(x).to(dev) for x in (q, k, v))
    bi, bu, bias = (torch.from_numpy(x).to(dev)
                    for x in (lay.block_idx, lay.buckets, bias))
    bf = [x.bfloat16() for x in (q, k, v)]
    before = (_fwd_counts(), _bwd_counts())
    shapes = (rf"bfloat16 q \(1, {lay.seq_len}, 4, 8\), block_idx "
              rf"\({lay.nq}, {lay.mb}\), buckets \({lay.nq}, {lay.mb}, "
              rf"8, 8\)")
    with pytest.raises(NotImplementedError,
                       match=r"bq=8, bk=8 \(the bf16 kernels take bq = "
                             r"bk = 16 or 32\): " + shapes):
        ops.cluster_attention(*bf, bi, bu, bias)
    leaves = [x.detach().requires_grad_() for x in bf]
    with pytest.raises(NotImplementedError, match=shapes):
        ops.cluster_attention(*leaves, bi, bu, bias)
    out = torch.zeros_like(bf[0])
    lse = torch.zeros((4, lay.seq_len), device=dev)
    with pytest.raises(NotImplementedError, match=shapes):
        tcab.cluster_attention_bwd(*bf, out, out, lse, bi, bu, bias)
    assert (_fwd_counts(), _bwd_counts()) == before
    lay = graph_layout()
    S, bi, bu = lay.seq_len, lay.block_idx, lay.buckets
    for Dh, want in ((12, "Dh=12"), (72, "Dh=72")):
        x = torch.zeros((1, S, 4, Dh), dtype=torch.bfloat16, device=dev)
        with pytest.raises(NotImplementedError, match=want + ".*bfloat16 q"):
            ops.cluster_attention(x, x, x, torch.from_numpy(bi).to(dev),
                                  torch.from_numpy(bu).to(dev), bias)
    assert (_fwd_counts(), _bwd_counts()) == before
    ops.cluster_attention(q, k, v, torch.from_numpy(
        graph_layout(bq=8, d_b=4).block_idx).to(dev), torch.from_numpy(
        graph_layout(bq=8, d_b=4).buckets).to(dev), bias)
    assert _fwd_counts() == (before[0][0] + 1, before[0][1])


# ------------------------------------- the bf16 biased kernels at 16 x 16

def _b16_counts():
    return (tca.sm90_b16_launches, tcab.dq_sm90_b16_launches,
            tcab.dkv_sm90_b16_launches)


def _packed_graphs(sizes=(40, 70, 100, 120), seed=0):
    """Per-graph (B, nq, mb) block_idx and (B, nq, mb, 16, 16) buckets of
    graphs of ``sizes`` nodes packed to the largest one's sequence, as
    the graph-level task packs them: the smaller graphs' trailing q-block
    rows are dead (all -1), and graph 1's q-block row 1 has its visits
    all masked."""
    lays = [graph_layout(n=n, seed=seed + i, bq=16, d_b=4)
            for i, n in enumerate(sizes)]
    S = max(lay.seq_len for lay in lays)
    mb = max(lay.mb for lay in lays)
    B, nq = len(lays), S // 16
    bi = np.full((B, nq, mb), -1, np.int32)
    bu = np.full((B, nq, mb, 16, 16), -1, np.int8)
    for i, lay in enumerate(lays):
        bi[i, :lay.nq, :lay.mb] = lay.block_idx
        bu[i, :lay.nq, :lay.mb] = lay.buckets
    bu[1, 1] = -1
    return S, bi, bu, lays[0].n_buckets


@pytest.mark.parametrize("Dh", [8, 16])
@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("H,KV", [(8, 8), (8, 2)])
def test_biased_bf16_b16_kernels_match_plain(dev, Dh, nb, H, KV):
    """The bf16 forward, dQ and dK/dV at 16 x 16 blocks (the graph-level
    task's shape) on B=4 packed graphs with dead rows and a fully masked
    row, n_buckets 1 (GT's zero table, here random) and 3 (Graphormer's
    adjacency buckets, those past 2 clipped), with and without GQA: each
    launch on the 16-block counters, O, lse and every gradient against
    the plain versions, dead rows zero."""
    S, bi, bu, _ = _packed_graphs(seed=Dh + nb)
    bu = np.where(bu >= 0, np.minimum(bu, nb), -1).astype(np.int8)
    q, k, v, bias = qkv(4, S, H, KV, Dh, seed=nb, n_buckets=nb)
    before = (_fwd_counts(), _b16_counts())
    args = [torch.from_numpy(np.array(x, copy=True)).to(dev)
            for x in (q, k, v, bi, bu, bias)]
    qb, kb, vb = (x.bfloat16() for x in args[:3])
    o, lse = ops.cluster_attention(qb, kb, vb, *args[3:], return_lse=True)
    torch.cuda.synchronize()
    assert _fwd_counts() == before[0]
    assert _b16_counts() == (before[1][0] + 1,) + before[1][1:]
    po, plse = ops.cluster_attention(qb, kb, vb, *args[3:], return_lse=True,
                                     impl="plain")
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
    dead = (args[3] < 0).all(-1)                          # (B, nq)
    rows = dead.repeat_interleave(16, dim=1)              # (B, S)
    assert not o[rows].any() and not lse.view(4, H, S)[
        rows[:, None].expand(4, H, S)].any()
    gen = torch.Generator(device=dev).manual_seed(nb)
    dout = torch.randn(o.shape, generator=gen, device=dev).bfloat16()
    leaves = [x.detach().requires_grad_() for x in (qb, kb, vb, args[5])]
    mid = _b16_counts()
    got = torch.autograd.grad(ops.cluster_attention(
        *leaves[:3], args[3], args[4], leaves[3]), leaves, dout)
    torch.cuda.synchronize()
    assert _b16_counts() == (mid[0] + 1, mid[1] + 1, mid[2] + 1)
    want = ref.cluster_attention_bwd(qb, kb, vb, dout, o, lse, args[3],
                                     args[4], args[5])
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert torch.isfinite(g).all(), name
        rel = ((g.float() - w.float()).abs().max()
               / w.float().abs().max().clamp_min(1e-30)).item()
        assert rel <= TOL_GRAD[torch.bfloat16], (name, rel)
    assert not got[0][rows].any()


@pytest.mark.parametrize("per_graph", [False, True])
def test_biased_bf16_b16_splits_the_heavy_row(dev, per_graph):
    """At 16 x 16 blocks, a q-block row that visits 160 k-blocks among
    rows of at most 4: the bf16 forward and dQ cut it into pieces merged
    in slot order, and everything matches the plain versions."""
    layouts = [_heavy_layout(nq=160, seed=s, blk=16) for s in (3, 4)]
    S, nb = layouts[0][0], layouts[0][3]
    if per_graph:
        bi = np.stack([x[1] for x in layouts])
        bu = np.stack([x[2] for x in layouts])
    else:
        bi, bu = layouts[0][1], layouts[0][2]
    plan = tca.fwd_plan(torch.from_numpy(bi).to(dev), 2)
    assert plan is not None and plan[2] >= 3
    q, k, v, bias = qkv(2, S, 8, 8, 16, n_buckets=nb)
    before = _b16_counts()
    args = [torch.from_numpy(np.array(x, copy=True)).to(dev)
            for x in (q, k, v, bi, bu, bias)]
    qb, kb, vb = (x.bfloat16() for x in args[:3])
    o, lse = ops.cluster_attention(qb, kb, vb, *args[3:], return_lse=True)
    po, plse = ops.cluster_attention(qb, kb, vb, *args[3:], return_lse=True,
                                     impl="plain")
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
    gen = torch.Generator(device=dev).manual_seed(1)
    dout = torch.randn(o.shape, generator=gen, device=dev).bfloat16()
    delta = ref.row_delta(dout, o)
    dq, db_part = tcab.dq_kernel(qb, kb, vb, dout, lse, delta, args[3],
                                 args[4], args[5])
    torch.cuda.synchronize()
    assert _b16_counts() == (before[0] + 1, before[1] + 1, before[2])
    _check_dq(dq, db_part, qb, kb, vb, dout, lse, delta, args[3], args[4],
              args[5])


def _run_unbiased(dev, dtype, q, k, v, bi, bit, causal):
    """The unbiased op on the card (forward kernel, then under autograd
    the dQ and dK/dV kernels) against the plain versions on the same
    inputs: O, lse, dq, dk and dv. bf16 runs the tensor-core kernels,
    fp32 the CUDA-core ones: each launch counts on its own kernel's
    counter."""
    q, k, v = (torch.from_numpy(x).to(dev).to(dtype) for x in (q, k, v))
    bi = torch.from_numpy(np.array(bi, copy=True)).to(dev)
    bit = None if bit is None else torch.from_numpy(
        np.array(bit, copy=True)).to(dev)
    sm90 = dtype == torch.bfloat16
    before = (tca.unbiased_launches, tca.unbiased_sm90_launches)
    o, lse = ops.cluster_attention(q, k, v, bi, causal=causal,
                                   return_lse=True)
    # bf16 runs the tensor-core forward, fp32 the CUDA-core one
    assert (tca.unbiased_launches, tca.unbiased_sm90_launches) == (
        before[0] + (not sm90), before[1] + sm90)
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
    def counts():
        return (tca.unbiased_launches, tca.unbiased_sm90_launches,
                tcab.dq_unbiased_launches, tcab.dq_unbiased_sm90_launches,
                tcab.dkv_unbiased_launches, tcab.dkv_unbiased_sm90_launches)
    before = counts()
    out = ops.cluster_attention(*leaves, bi, None, None, bit, causal=causal)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert counts() == tuple(c + d for c, d in zip(
        before, (not sm90, sm90) * 3))
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unbiased_kernels_batch_and_dead_row(dev, dtype):
    """B=2 on the shared 2-D layout, then with a dead q-block row (O, lse
    and dq zero there in both sequences), in each dtype's forward."""
    lay = lm_local_global_layout(512, window=128, n_global=128)
    q, k, v, _ = qkv(2, lay.seq_len, 4, 2, 64, seed=3)
    _run_unbiased(dev, dtype, q, k, v, lay.block_idx, lay.block_idx_t, True)
    bi = np.array(lay.block_idx, copy=True)
    bi[2] = -1
    o, (dq, _, _) = _run_unbiased(dev, dtype, q, k, v, bi, None, True)
    assert not o[:, 256:384].any() and not dq[:, 256:384].any()
    _, lse = ops.cluster_attention(
        *(torch.from_numpy(x).to(dev).to(dtype) for x in (q, k, v)),
        torch.from_numpy(bi).to(dev), causal=True, return_lse=True)
    assert not lse.view(2, 4, 512)[..., 256:384].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unbiased_kernels_full_qwen3_heads(dev, dtype):
    """Qwen3-0.6B's heads (16 over 8, Dh 128) at S=4096, window 1024: the
    rows average about a thousand keys, so bf16 O cancels near 0 on many
    elements, where a probability rounded once to bf16 before PV would
    miss the element-wise 1e-5 + 2^-7 |O|."""
    lay = lm_local_global_layout(4096, window=1024, n_global=128)
    q, k, v, _ = qkv(1, lay.seq_len, 16, 8, 128, seed=5)
    _run_unbiased(dev, dtype, q, k, v, lay.block_idx, lay.block_idx_t, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unbiased_kernels_holes_in_both_layouts(dev, dtype):
    """-1 entries in the middle of ``block_idx`` and, at the same (q-row,
    slot) pairs, of the host's ``block_idx_t``: the walks skip them where
    they stand. Then the derived transposed layout of the same holed
    layout (``mt = nq``, every list -1 padded to nq)."""
    lay = lm_local_global_layout(1024, window=512, n_global=128)
    bi = np.array(lay.block_idx, copy=True)
    bit = np.array(lay.block_idx_t, copy=True)
    holes = [(3, 1), (4, 2), (5, 2)]    # slots inside live rows
    for i, m in holes:
        assert m > 0 and bi[i, m] >= 0 and bi[i, m + 1] >= 0
        j = bi[i, m]
        bi[i, m] = -1
        (t,) = np.nonzero((bit[j, :, 0] == i) & (bit[j, :, 1] == m))[0]
        bit[j, t] = -1
        assert (bit[j, t + 1:, 0] >= 0).any()   # a -1 before live pairs
    q, k, v, _ = qkv(1, lay.seq_len, 4, 2, 128, seed=11)
    _run_unbiased(dev, dtype, q, k, v, bi, bit, True)
    derived = ref.derive_block_idx_t(torch.from_numpy(bi), lay.nq)
    assert derived.shape == (lay.nq, lay.nq, 2)
    _run_unbiased(dev, dtype, q, k, v, bi, derived.numpy(), True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unbiased_kernels_causal_call_on_a_non_causal_layout(dev, dtype):
    """A causal call over the non-causal window layout: rows list blocks
    past the diagonal (blk > qi), and the transposed lists visitors
    before it (qrow < ki). The causal mask empties those blocks, so the
    walks skip them."""
    lay = lm_local_global_layout(1024, window=512, n_global=128,
                                 causal=False)
    qi = np.arange(lay.nq)[:, None]
    assert (lay.block_idx > qi).any()
    rows = lay.block_idx_t[..., 0]
    assert ((rows >= 0) & (rows < np.arange(lay.nq)[:, None])).any()
    q, k, v, _ = qkv(1, lay.seq_len, 4, 2, 64, seed=13)
    _run_unbiased(dev, dtype, q, k, v, lay.block_idx, lay.block_idx_t,
                  True)


def test_unbiased_bf16_backward_refuses_what_its_kernels_do_not_take(dev):
    """The bf16 backward has no fallback: 64-row blocks and Dh 12 raise
    with the shapes, before any launch."""
    lay64 = lm_local_global_layout(512, bq=64, bk=64, window=128,
                                   n_global=64)
    lay = lm_local_global_layout(512, window=128, n_global=128)
    for layout, Dh, match in (
            (lay64, 64, r"bq=bk=64 \(the bf16 backward takes bq = bk = "
                        r"128.*bfloat16 q \(2, 512, 4, 64\), block_idx "
                        r"\(8, 3\)"),
            (lay, 12, r"Dh=12.*bfloat16 q \(2, 512, 4, 12\)")):
        q, k, v, _ = qkv(2, 512, 4, 2, Dh)
        q, k, v = (torch.from_numpy(x).to(dev).bfloat16() for x in (q, k, v))
        bi = torch.from_numpy(layout.block_idx).to(dev)
        bit = torch.from_numpy(layout.block_idx_t).to(dev)
        lse = torch.zeros((2 * 4, 512), device=dev)
        before = (tcab.dq_unbiased_launches, tcab.dq_unbiased_sm90_launches,
                  tcab.dkv_unbiased_launches,
                  tcab.dkv_unbiased_sm90_launches)
        with pytest.raises(NotImplementedError, match=match):
            tcab.cluster_attention_bwd(q, k, v, q, q, lse, bi, None, None,
                                       bit, causal=True)
        assert (tcab.dq_unbiased_launches, tcab.dq_unbiased_sm90_launches,
                tcab.dkv_unbiased_launches,
                tcab.dkv_unbiased_sm90_launches) == before


def _per_graph_layouts(B, S, mb, seed):
    """One layout a sequence, as the scale run draws them
    (``graph_dryrun.block_layout``: the diagonal and ``mb - 1`` other
    k-blocks a row, bq = bk = 128), with their tight transposed layouts
    padded to one ``mt``."""
    from repro_torch.launch.graph_dryrun import block_layout

    rng = np.random.default_rng(seed)
    nq = S // 128
    bis = [block_layout(nq, mb, rng) for _ in range(B)]
    bits = [transpose_block_idx(b, nq) for b in bis]
    mt = max(b.shape[1] for b in bits)
    return np.stack(bis), np.stack([
        np.pad(b, ((0, 0), (0, mt - b.shape[1]), (0, 0)), constant_values=-1)
        for b in bits])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,Dh", [(8, 8, 8), (4, 4, 16), (32, 32, 24),
                                     (4, 2, 32), (4, 4, 40), (4, 4, 48),
                                     (4, 4, 56), (4, 2, 64)])
def test_unbiased_kernels_per_graph_layout_and_graph_head_dims(
        dev, dtype, H, KV, Dh):
    """Rows 2, 5 and 6 on a layout per sequence (B=2, S=2048) at every
    head dim a multiple of 8 up to 64: Slim's 8, GT's 16, Large's 24 and
    the rest, the bf16 ones padded to 16 columns a tile (32, 64: copied
    as they are), non-causal, as the mask-free graph batch calls them."""
    bi, bit = _per_graph_layouts(2, 2048, 6, seed=Dh)
    q, k, v, _ = qkv(2, 2048, H, KV, Dh, seed=Dh)
    _run_unbiased(dev, dtype, q, k, v, bi, bit, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unbiased_kernels_per_graph_derived_and_causal(dev, dtype):
    """The per-sequence layout with its transposed layout derived at the
    dense bound (``ref.derive_block_idx_t``), and a causal call on it, at
    Large's heads (Dh 24)."""
    bi, _ = _per_graph_layouts(2, 1024, 4, seed=5)
    q, k, v, _ = qkv(2, 1024, 4, 4, 24, seed=6)
    _run_unbiased(dev, dtype, q, k, v, bi, None, False)
    _run_unbiased(dev, dtype, q, k, v, bi, None, True)


def test_scale_run_on_the_card(dev):
    """``graph_dryrun.run`` at Slim's published width, S=16384: rows 2, 5
    and 6 launched as the steps say (the forward twice a layer under
    ``remat="block"``), every loss finite, the record's device numbers
    present; one step held to ``impl="plain"`` in loss."""
    from repro_torch.launch import graph_dryrun as gd

    tca.reset_count()
    tcab.reset_count()
    rec = gd.run("graphormer_slim", 16384, steps=2, device=dev)
    layers = rec["layers"]
    assert (tca.unbiased_sm90_launches, tcab.dq_unbiased_sm90_launches,
            tcab.dkv_unbiased_sm90_launches) == (4 * layers, 2 * layers,
                                                 2 * layers)
    assert np.isfinite(rec["losses"]).all()
    assert rec["fits"] and rec["peak_gb"] > 0 and rec["mfu"] > 0
    assert rec["device"]["name"] == torch.cuda.get_device_name(0)
    cfg = gd.scale_config("graphormer_slim")
    batch = {k: v.to(dev) for k, v in gd.graph_batch(cfg, 16384).items()}
    model = tgm.GraphModel(cfg, device=dev)
    got = gd.loss_and_grads(model, batch)[0].item()
    want = gd.loss_and_grads(model, batch, impl="plain")[0].item()
    assert abs(got - want) <= 1e-2 * abs(want)


# ------------------------------------------- flash kernels (rows 7, 8, 9)

def _flash_inputs(dev, dtype, B, Sq, Sk, H, KV, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dev).to(dtype)
            for shape in ((B, Sq, H, Dh), (B, Sk, KV, Dh), (B, Sk, KV, Dh),
                          (B, Sq, H, Dh))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,Dh,causal,bq,bk,hoist", [
    (1, 256, 256, 4, 4, 32, True, 128, 128, False),    # the default case
    (2, 1000, 1000, 4, 2, 64, True, 128, 128, True),   # ragged, GQA
    (1, 1000, 700, 4, 2, 128, False, 64, 64, False),   # Sq != Sk
    (1, 300, 500, 8, 2, 128, True, 64, 128, True),
    (2, 77, 77, 2, 1, 32, True, 128, 256, False),      # one short tile
    # full-width heads at S=4096: bf16 O cancels near 0 on many elements,
    # where a probability rounded to bf16 before PV would miss 1e-5
    (1, 4096, 4096, 16, 8, 128, True, 128, 128, False),
])
def test_flash_kernels_match_plain(dev, dtype, B, Sq, Sk, H, KV, Dh, causal,
                                   bq, bk, hoist):
    """The forward kernel, then under autograd the dQ and dK/dV kernels,
    against the plain versions at the same schedule: O (bf16 also element
    by element, as the unbiased O), lse, dq, dk, dv; one launch of each
    kernel. bf16 runs the tensor-core forward, dQ and dK/dV, fp32 the
    CUDA-core ones: each launch counts on its own kernel's counter."""
    q, k, v, dout = _flash_inputs(dev, dtype, B, Sq, Sk, H, KV, Dh)
    kw = {"causal": causal, "block_q": bq, "block_k": bk,
          "hoist_scale": hoist}
    sm90 = dtype == torch.bfloat16
    before = (tfa.launches, tfa.sm90_launches)
    o, lse = tfa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    assert (tfa.launches, tfa.sm90_launches) == (
        before[0] + (not sm90), before[1] + sm90)
    po, plse = ref.flash_fwd(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), po.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if dtype == torch.bfloat16:
        atol, rtol = TOL_O_BF16
        torch.testing.assert_close(o.float(), po.float(), atol=atol,
                                   rtol=rtol)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
    counts = (tfa.dq_launches, tfa.dq_sm90_launches, tfa.dkv_launches,
              tfa.dkv_sm90_launches)
    got = tfa.flash_attention_bwd(q, k, v, dout, o, lse, **kw)
    assert (tfa.dq_launches, tfa.dq_sm90_launches, tfa.dkv_launches,
            tfa.dkv_sm90_launches) == (
        counts[0] + (not sm90), counts[1] + sm90, counts[2] + (not sm90),
        counts[3] + sm90)
    want = ref.flash_bwd(q, k, v, dout, o, lse, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        rel = ((g.float() - w.float()).abs().max()
               / w.float().abs().max().clamp_min(1e-30)).item()
        assert rel <= TOL_GRAD[dtype], (name, rel)


def test_flash_op_autograd_on_the_kernels(dev):
    """``ops.flash_attention`` on CUDA tensors runs the three kernels,
    forward and backward, and agrees with its ``impl="plain"`` path."""
    q, k, v, dout = _flash_inputs(dev, torch.float32, 1, 300, 300, 4, 2, 64)
    counts = (tfa.launches, tfa.dq_launches, tfa.dkv_launches)
    grads = {}
    for impl in (None, "plain"):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = ops.flash_attention(*leaves, causal=True, impl=impl)
        grads[impl] = (out,) + torch.autograd.grad(out, leaves, dout)
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == tuple(
        c + 1 for c in counts)
    for a, b in zip(grads[None], grads["plain"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_check_launch_agrees_with_the_kernels(dev, dtype):
    """Every (Dh, block_q, block_k) of the tuner's grid, in each dtype
    (bf16: the tensor-core forward, fp32: the CUDA-core one): the kernels
    run where ``check_launch`` admits it and refuse where it does not."""
    for Dh in (32, 64, 128):
        q, k, v, _ = _flash_inputs(dev, dtype, 1, 200, 200, 2, 2, Dh)
        for bq in (32, 64, 128, 256):
            for bk in (32, 64, 128, 256, 512):
                reason = tfa.check_launch(Dh, bq, bk, dtype)
                if reason is None:
                    o = tfa.flash_attention_fwd(q, k, v, block_q=bq,
                                                block_k=bk)
                    po = ref.flash_fwd(q, k, v, block_q=bq, block_k=bk)
                    torch.testing.assert_close(o.float(), po.float(),
                                               atol=TOL[dtype],
                                               rtol=TOL[dtype])
                else:
                    with pytest.raises(NotImplementedError, match="Dh|block"):
                        tfa.flash_attention_fwd(q, k, v, block_q=bq,
                                                block_k=bk)
    # what check_launch admits fits the card's shared memory
    props = torch.cuda.get_device_properties(dev)
    optin = getattr(props, "shared_memory_per_block_optin", tfa.SMEM_LIMIT)
    assert tfa.SMEM_LIMIT <= optin and tkssd.SMEM_LIMIT <= optin


# -------------------------------------------------- SSD kernel (row 10)

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,dh,N,chunk", [
    (1, 256, 2, 8, 4, 256),      # the tuner's default case
    (2, 512, 3, 64, 128, 128),
    (1, 1024, 2, 64, 128, 512),
    (1, 96, 2, 16, 20, 48),      # a chunk that is no multiple of 64
    # the chunk-parallel kernels' tiles at B = 2, dh < 64, N 16-128 (100:
    # no multiple of 64), every chunk the tuner offers
    (2, 1024, 3, 32, 16, 64),
    (2, 2048, 4, 48, 64, 256),
    (2, 1024, 2, 40, 128, 512),
    (2, 512, 5, 24, 100, 128),
])
def test_ssd_kernel_matches_plain(dev, dtype, B, S, H, dh, N, chunk):
    """y and the final state against ``ssd_chunked``: y within 1e-4 of
    max |plain| in fp32 and 2e-2 in bf16 (one rounding of the output),
    the fp32 state within 1e-4 of max |plain|."""
    rng = np.random.default_rng(1)

    def t(x, dt=torch.float32):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev).to(dt)
    x = t(rng.standard_normal((B, S, H, dh)), dtype)
    dtv = t(np.log1p(np.exp(rng.standard_normal((B, S, H)) - 2)))
    a = t(-np.exp(rng.standard_normal(H) * 0.3))
    b = t(rng.standard_normal((B, S, N)), dtype)
    c = t(rng.standard_normal((B, S, N)), dtype)
    before = tkssd.launches
    y, state = ops.ssd(x, dtv, a, b, c, chunk=chunk)
    assert tkssd.launches == before + 1
    py, pstate = ops.ssd(x, dtv, a, b, c, chunk=chunk, impl="plain")
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want, lim in ((y, py, tol), (state, pstate, 1e-4)):
        assert got.dtype == want.dtype and got.shape == want.shape
        rel = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        assert rel <= lim, rel


def test_ssd_kernel_refuses_gradients_and_unported_shapes(dev):
    x = torch.randn(1, 128, 2, 8, device=dev)
    dtv = torch.rand(1, 128, 2, device=dev)
    a = -torch.rand(2, device=dev)
    b = torch.randn(1, 128, 4, device=dev)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.ssd(x.requires_grad_(), dtv, a, b, b, chunk=64)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="dh=128"):
        ops.ssd(torch.randn(1, 128, 2, 128, device=dev), dtv, a, b, b,
                chunk=64)
    with pytest.raises(ValueError, match="not tiled"):
        ops.ssd(x.detach(), dtv, a, b, b, chunk=48)


# ---------------------------------------------- the cluster op's schedule

SCHEDULE_FLAGS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("dtype,blk", [(torch.float32, 32),
                                       (torch.bfloat16, 32),
                                       (torch.bfloat16, 16)])
@pytest.mark.parametrize("hoist,fuse", SCHEDULE_FLAGS)
def test_biased_kernels_under_each_schedule(dev, dtype, blk, hoist, fuse):
    """Rows 1, 3, 4 under each ``hoist_scale`` x ``fuse_bias``: the kernels
    (bf16 at 32 x 32 and 16 x 16, fp32) against the plain versions under
    the same flags, with buckets past nb - 1 left out (the two lookups
    agree on {-1} U [0, nb) only), a row with no visit and a row whose
    visits are all masked (O, lse and dq 0 through the sentinel too)."""
    S, bi, bu, nb = _heavy_layout(nq=12, blk=blk)
    bu = np.minimum(bu, nb - 1)
    bi[2] = -1
    bu[3] = -1
    q, k, v, bias = qkv(2, S, 8, 2, 24, n_buckets=nb)
    args = [torch.from_numpy(np.array(x, copy=True)).to(dev)
            for x in (q, k, v, bi, bu, bias)]
    for i in range(3):
        args[i] = args[i].to(dtype)
    q, k, v, bi, bu, bias = args
    flags = dict(hoist_scale=hoist, fuse_bias=fuse)
    o, lse = tca.cluster_attention_fwd(q, k, v, bi, bu, bias,
                                       return_lse=True, **flags)
    po, plse = ref.cluster_sparse_attention(q, k, v, bi, bu, bias,
                                            return_lse=True, **flags)
    torch.testing.assert_close(o.float(), po.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
    rows = slice(2 * blk, 4 * blk)
    assert not o[:, rows].any() and not lse.view(2, 8, -1)[..., rows].any()
    gen = torch.Generator(device=dev).manual_seed(1)
    dout = torch.randn(o.shape, generator=gen, device=dev).to(dtype)
    bit = torch.from_numpy(transpose_block_idx(bi.cpu().numpy(),
                                               S // blk)).to(dev)
    got = tcab.cluster_attention_bwd(q, k, v, dout, o, lse, bi, bu, bias,
                                     bit, **flags)
    want = ref.cluster_attention_bwd(q, k, v, dout, o, lse, bi, bu, bias,
                                     bit, **flags)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        rel = ((g.float() - w.float()).abs().max()
               / w.float().abs().max().clamp_min(1e-30)).item()
        assert rel <= TOL_GRAD[dtype], (name, rel)
    assert got[3].shape == (8, nb)
    assert not got[0][:, rows].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hoist", [False, True])
def test_unbiased_kernels_under_hoist_scale(dev, dtype, hoist):
    """Rows 2, 5, 6 under ``hoist_scale`` (the bf16 kernels compute the
    same for both values), causal, against the plain versions under the
    same flag."""
    lay = lm_local_global_layout(512, window=128, n_global=128)
    q, k, v, _ = qkv(2, lay.seq_len, 4, 2, 64, seed=5)
    q, k, v = (torch.from_numpy(x).to(dev).to(dtype) for x in (q, k, v))
    bi = torch.from_numpy(lay.block_idx).to(dev)
    bit = torch.from_numpy(lay.block_idx_t).to(dev)
    o, lse = tca.cluster_attention_fwd(q, k, v, bi, None, None, causal=True,
                                       return_lse=True, hoist_scale=hoist)
    po, plse = ref.cluster_sparse_attention(q, k, v, bi, causal=True,
                                            return_lse=True,
                                            hoist_scale=hoist)
    atol, rtol = TOL_O_BF16 if dtype == torch.bfloat16 else (TOL[dtype],) * 2
    torch.testing.assert_close(o.float(), po.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
    gen = torch.Generator(device=dev).manual_seed(2)
    dout = torch.randn(o.shape, generator=gen, device=dev).to(dtype)
    got = tcab.cluster_attention_bwd(q, k, v, dout, o, lse, bi, None, None,
                                     bit, causal=True, hoist_scale=hoist)
    want = ref.cluster_attention_bwd(q, k, v, dout, o, lse, bi, None, None,
                                     bit, causal=True, hoist_scale=hoist)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        rel = ((g.float() - w.float()).abs().max()
               / w.float().abs().max().clamp_min(1e-30)).item()
        assert rel <= TOL_GRAD[dtype], (name, rel)


def test_op_applies_an_installed_cluster_winner_on_the_card(dev, monkeypatch):
    """A winner table gated on CUDA reaches the kernels: the forward and
    both backward kernels launch with its flags."""
    from repro_torch.tune import runtime as rt
    from repro_torch.tune.schedule import Schedule, shape_bucket
    from repro_torch.tune.table import WinnerTable

    seen = []
    for mod, name in ((tca, "cluster_attention_fwd"),
                      (tcab, "cluster_attention_bwd")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **kw: (
            seen.append((_n, kw["hoist_scale"], kw["fuse_bias"]))
            or _fn(*a, **kw)))
    lay = graph_layout()
    q, k, v, bias = qkv(1, lay.seq_len, 4, 4, 16, n_buckets=lay.n_buckets)
    leaves = [torch.from_numpy(x).to(dev).requires_grad_()
              for x in (q, k, v, bias)]
    table = WinnerTable(backend=f"cuda:{torch.cuda.get_device_name(dev)}")
    table.put(shape_bucket("cluster_attention", seq_len=lay.seq_len,
                           heads=4, d_head=16, dtype="float32"),
              Schedule("cluster_attention", row_chunk=4, hoist_scale=True,
                       fuse_bias=True), source="test")
    with rt.use_table(table):
        o = ops.cluster_attention(*leaves[:3],
                                  torch.from_numpy(lay.block_idx).to(dev),
                                  torch.from_numpy(lay.buckets).to(dev),
                                  leaves[3])
        o.float().sum().backward()
    torch.cuda.synchronize()
    assert seen == [("cluster_attention_fwd", True, True),
                    ("cluster_attention_bwd", True, True)]
