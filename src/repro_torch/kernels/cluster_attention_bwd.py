"""Wrappers, builds and launch counters of the CUDA cluster-sparse
attention backward kernels:

* the ports of the TPU kernels ``_dq_kernel_biased`` and
  ``_dkv_kernel_biased`` (``src/repro/kernels/cluster_attention_bwd.py``):
  int8 bias buckets and the ``bias_table`` gradient. Each dtype has
  exactly one dQ and one dK/dV kernel, with no fallback between them:
  bfloat16 runs on the tensor cores (``csrc/cluster_attention_bwd_dq_sm90.cu``
  and ``csrc/cluster_attention_bwd_dkv_sm90.cu``: ``mma.sync`` on 16- or
  32-row tiles, one warp per head, a ``cp.async`` ring of visited blocks;
  the dQ cuts heavy rows into pieces as the bf16 forward does), float32
  on CUDA cores (``csrc/cluster_attention_bwd.cu``).
  ``cluster_attention.biased_kernel_reason`` states what bf16 takes;
* the ports of ``_dq_kernel`` and ``_dkv_kernel``: no buckets, an
  optional positional causal mask, the token LM's path and the mask-free
  graph batch (one layout per graph, Dh 8 and 24). Each dtype has
  exactly one dQ and one dK/dV kernel, with no fallback between them:
  bfloat16 runs on the tensor cores
  (``csrc/cluster_attention_unbiased_bwd_sm90.cu``: TMA copies of the
  visited blocks into a ring of shared-memory stages feeding ``wgmma``),
  float32 on CUDA cores in fp32 throughout
  (``csrc/cluster_attention_unbiased_bwd.cu``; TF32 would miss the fp32
  tolerances). ``cluster_attention.check_unbiased_kernel`` states what
  each takes.

Each dQ kernel walks the forward layout ``block_idx``; each dK/dV kernel
walks the transposed one, ``block_idx_t`` (per k-block, the (q-row,
forward slot) pairs that visit it), which ``core/reformation.py`` emits
beside the forward one. A caller without it gets one derived here at the
dense bound ``mt = nq`` (``ref.derive_block_idx_t``).

Around the launches, in plain PyTorch as the reference does it in jnp:
``delta = rowsum(dO * O)`` in fp32 before, and after, the sum of the
biased dQ kernel's ``(B, H, nq, n_buckets)`` bucket partials into the
``bias_table`` gradient and the GQA group sum of the per-q-head dK/dV.

The schedule's rewrites are flags of these kernels, as of the forward's
(``cluster_attention``'s docstring): ``hoist_scale`` rebuilds the fp32
scores from the scaled q tile, ``fuse_bias`` looks the masked bucket up
in the sentinel column of ``ref.extend_bias_table``'s operand; the bias
gradient keeps the table's width.

The wrapper takes CUDA tensors only: it launches the kernels or raises.
``kernels/ops.py`` sends CPU tensors to the plain backward
(``kernels/ref.py``). Each launch is a ``torch.library`` custom op with
a fake implementation, as the forward's are
(``cluster_attention.py``'s docstring).
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import torch

from repro_torch import fake
from repro_torch.kernels import cluster_attention as _ca
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.build import CudaLibrary

# kernel launches since the last reset_count(), one count per kernel
dq_launches = 0                 # fp32, cluster_attention_bwd.cu
dq_sm90_launches = 0            # bf16, cluster_attention_bwd_dq_sm90.cu,
dq_sm90_b16_launches = 0        # at 32 x 32 and at 16 x 16 blocks
dkv_launches = 0                # fp32, cluster_attention_bwd.cu
dkv_sm90_launches = 0           # bf16, cluster_attention_bwd_dkv_sm90.cu,
dkv_sm90_b16_launches = 0       # at 32 x 32 and at 16 x 16 blocks
dq_unbiased_launches = 0        # fp32, cluster_attention_unbiased_bwd.cu
dkv_unbiased_launches = 0
dq_unbiased_sm90_launches = 0   # bf16, ..._unbiased_bwd_sm90.cu
dkv_unbiased_sm90_launches = 0


def reset_count() -> None:
    global dq_launches, dq_sm90_launches, dkv_launches, dkv_sm90_launches, \
        dq_sm90_b16_launches, dkv_sm90_b16_launches, \
        dq_unbiased_launches, dkv_unbiased_launches, \
        dq_unbiased_sm90_launches, dkv_unbiased_sm90_launches
    dq_launches = dq_sm90_launches = dkv_launches = dkv_sm90_launches = 0
    dq_sm90_b16_launches = dkv_sm90_b16_launches = 0
    dq_unbiased_launches = dkv_unbiased_launches = 0
    dq_unbiased_sm90_launches = dkv_unbiased_sm90_launches = 0


def _bind(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cluster_attention_bwd_dq.argtypes = (
        [vp] * 11 + [i32] * 14 + [ctypes.c_float, vp])
    lib.cluster_attention_bwd_dq.restype = i32
    lib.cluster_attention_bwd_dkv.argtypes = (
        [vp] * 11 + [i32] * 17 + [ctypes.c_float, vp])
    lib.cluster_attention_bwd_dkv.restype = i32


def _bind_dq_sm90(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cluster_attention_bwd_dq_sm90.argtypes = (
        [vp] * 15 + [i32] * 14 + [ctypes.c_float, vp])
    lib.cluster_attention_bwd_dq_sm90.restype = i32


def _bind_dkv_sm90(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cluster_attention_bwd_dkv_sm90.argtypes = (
        [vp] * 11 + [i32] * 15 + [ctypes.c_float, vp])
    lib.cluster_attention_bwd_dkv_sm90.restype = i32


def _bind_unbiased(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cluster_attention_bwd_dq_unbiased.argtypes = (
        [vp] * 8 + [i32] * 13 + [ctypes.c_float, vp])
    lib.cluster_attention_bwd_dq_unbiased.restype = i32
    lib.cluster_attention_bwd_dkv_unbiased.argtypes = (
        [vp] * 9 + [i32] * 13 + [ctypes.c_float, vp])
    lib.cluster_attention_bwd_dkv_unbiased.restype = i32


def _bind_unbiased_sm90(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cluster_attention_bwd_dq_unbiased_sm90.argtypes = (
        [vp] * 8 + [i32] * 9 + [ctypes.c_float, vp])
    lib.cluster_attention_bwd_dq_unbiased_sm90.restype = i32
    lib.cluster_attention_bwd_dkv_unbiased_sm90.argtypes = (
        [vp] * 9 + [i32] * 9 + [ctypes.c_float, vp])
    lib.cluster_attention_bwd_dkv_unbiased_sm90.restype = i32


_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
LIBRARY = CudaLibrary(_CSRC / "cluster_attention_bwd.cu", _bind)
LIBRARY_DQ_SM90 = CudaLibrary(_CSRC / "cluster_attention_bwd_dq_sm90.cu",
                              _bind_dq_sm90)
LIBRARY_DKV_SM90 = CudaLibrary(_CSRC / "cluster_attention_bwd_dkv_sm90.cu",
                               _bind_dkv_sm90)
LIBRARY_UNBIASED = CudaLibrary(_CSRC / "cluster_attention_unbiased_bwd.cu",
                               _bind_unbiased)
LIBRARY_UNBIASED_SM90 = CudaLibrary(
    _CSRC / "cluster_attention_unbiased_bwd_sm90.cu", _bind_unbiased_sm90)


def check_args(q, k, v, dout, out, lse, block_idx, buckets, bias_table,
               block_idx_t):
    """Raise unless the arguments meet the backward's contract: the
    forward's (``cluster_attention.check_args``), plus dO and O shaped
    like q, lse ``(B*H, S)`` fp32 and, when given, an int32
    ``block_idx_t`` ``(nk, mt, 2)`` or ``(B, nk, mt, 2)``."""
    _ca.check_args(q, k, v, block_idx, buckets, bias_table)
    B, S, H, _ = q.shape
    for name, x in (("dout", dout), ("out", out)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and "
                             f"device, got {x.dtype} {tuple(x.shape)}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B * H, S) \
            or lse.device != q.device:
        raise ValueError(f"lse must be float32 ({B * H}, {S}) on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    if block_idx_t is not None:
        check_block_idx_t(q, block_idx, buckets, block_idx_t)


def check_block_idx_t(q, block_idx, buckets, block_idx_t):
    """Raise unless ``block_idx_t`` is int32 ``(nk, mt, 2)`` or
    ``(B, nk, mt, 2)`` on q's device."""
    B, S = q.shape[:2]
    nk = S // _ref.block_dims(q, block_idx, buckets)[2]
    if block_idx_t.dtype != torch.int32 or block_idx_t.dim() not in (3, 4) \
            or block_idx_t.shape[-1] != 2 or block_idx_t.shape[-3] != nk \
            or (block_idx_t.dim() == 4 and block_idx_t.shape[0] != B) \
            or block_idx_t.device != q.device:
        raise ValueError(f"block_idx_t must be int32 ({nk}, mt, 2) or "
                         f"({B}, {nk}, mt, 2) on {q.device}, got "
                         f"{block_idx_t.dtype} {tuple(block_idx_t.shape)}")


def _sizes(q, k, block_idx, buckets, bias, fuse_bias):
    """The launch sizes; ``nb`` the table's width, one below the fused
    operand's."""
    B, S, H, Dh = q.shape
    nq, mb = block_idx.shape[-2:]
    return B, S, H, k.shape[2], Dh, nq, mb, S // nq, buckets.shape[-1], \
        bias.shape[1] - int(fuse_bias)


def dq_kernel(q, k, v, dout, lse, delta, block_idx, buckets, bias, *,
              hoist_scale: bool = False, fuse_bias: bool = False):
    """Launch the dQ kernel of q's dtype (bf16: tensor cores, fp32: CUDA
    cores) on checked CUDA operands, aligned at launch (``bias`` fp32,
    under ``fuse_bias`` ``ref.extend_bias_table``'s; ``delta`` from
    ``ref.row_delta``); returns ``dq`` in q's dtype and the ``(B, H, nq,
    n_buckets)`` fp32 bucket partials of ds, at the table's width. In
    bf16 the rows the forward's plan cuts (``cluster_attention.fwd_plan``)
    run as pieces whose fp32 partials a combine kernel sums."""
    plan = _ca.fwd_plan(block_idx, q.shape[0]) \
        if q.dtype == torch.bfloat16 else None
    pieces, splits, slots = plan or (None, None, 0)
    got = launch_dq_biased(q, k, v, dout, lse, delta, block_idx, buckets,
                           bias, pieces, splits, slots, hoist_scale,
                           fuse_bias)
    return got[0], got[1]


def _dq_outputs(q, nq: int, nb: int, part=None) -> list:
    """The dQ launches' outputs: dq like q, the ``(B, H, nq, nb)`` fp32
    bucket partials (biased), and with ``part = (slots, bq)`` the bf16
    biased kernel's partial slots of the split rows, fp32 dq and bucket
    sums."""
    B, S, H, Dh = q.shape
    outs = [torch.empty(q.shape, dtype=q.dtype, device=q.device)]
    if nb:
        outs.append(torch.empty((B, H, nq, nb), dtype=torch.float32,
                                device=q.device))
    if part is not None:
        slots, bq = part
        outs += [torch.empty((slots, H, bq, Dh), dtype=torch.float32,
                             device=q.device),
                 torch.empty((slots, H, nb), dtype=torch.float32,
                             device=q.device)]
    return outs


def _dkv_outputs(q) -> list:
    """The dK/dV launches' outputs: per-q-head ``(B, S, H, Dh)`` dk and dv
    in q's dtype."""
    return [torch.empty(q.shape, dtype=q.dtype, device=q.device)
            for _ in range(2)]


@fake.launch_op("repro_torch::cluster_dq_biased")
def launch_dq_biased(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dout: torch.Tensor, lse: torch.Tensor,
                     delta: torch.Tensor, block_idx: torch.Tensor,
                     buckets: torch.Tensor, bias: torch.Tensor,
                     pieces: Optional[torch.Tensor],
                     splits: Optional[torch.Tensor], slots: int,
                     hoist_scale: bool,
                     fuse_bias: bool) -> list[torch.Tensor]:
    """One launch of the biased dQ kernel (:func:`dq_kernel`): ``[dq,
    bucket partials, the bf16 kernel's partial slots]``. A custom op
    with a fake implementation, as the forward's launches
    (``cluster_attention.launch_fwd_biased``)."""
    B, S, H, KV, Dh, nq, mb, bq, bk, nb = _sizes(q, k, block_idx, buckets,
                                                 bias, fuse_bias)
    q, k, v, dout, lse, block_idx, buckets = (
        _ca.aligned(x) for x in (q, k, v, dout, lse, block_idx, buckets))
    sm90 = q.dtype == torch.bfloat16
    outs = _dq_outputs(q, nq, nb, (slots, bq) if sm90 else None)
    dq, db_part = outs[:2]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), block_idx.data_ptr(),
            buckets.data_ptr(), bias.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    with torch.cuda.device(q.device):
        if sm90:
            part_dq, part_db = outs[2:]
            err = LIBRARY_DQ_SM90.lib().cluster_attention_bwd_dq_sm90(
                *ptrs, _ca._ptr(pieces), _ca._ptr(splits), dq.data_ptr(),
                db_part.data_ptr(), part_dq.data_ptr(), part_db.data_ptr(),
                B, S, H, KV, Dh, nq, mb, bq, bk, nb,
                int(block_idx.dim() == 3),
                0 if pieces is None else len(pieces),
                0 if splits is None else len(splits), int(fuse_bias),
                Dh ** -0.5, stream)
        else:
            err = LIBRARY.lib().cluster_attention_bwd_dq(
                *ptrs, dq.data_ptr(), db_part.data_ptr(),
                _ca._DTYPES[q.dtype], B, S, H, KV, Dh, nq, mb, bq, bk, nb,
                int(block_idx.dim() == 3), int(hoist_scale), int(fuse_bias),
                Dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"cluster_attention_bwd dQ launch failed: CUDA "
                           f"error {err} ({q.dtype}, bq={bq}, bk={bk}, "
                           f"Dh={Dh}, n_buckets={nb}, mb={mb})")
    global dq_launches, dq_sm90_launches, dq_sm90_b16_launches
    if not sm90:
        dq_launches += 1
    elif bq == 16:
        dq_sm90_b16_launches += 1
    else:
        dq_sm90_launches += 1
    return outs


@launch_dq_biased.register_fake
def _(q, k, v, dout, lse, delta, block_idx, buckets, bias, pieces, splits,
      slots, hoist_scale, fuse_bias):
    nq = block_idx.shape[-2]
    return _dq_outputs(q, nq, bias.shape[1] - int(fuse_bias),
                       (slots, q.shape[1] // nq)
                       if q.dtype == torch.bfloat16 else None)


def dkv_kernel(q, k, v, dout, lse, delta, block_idx, block_idx_t, buckets,
               bias, *, hoist_scale: bool = False, fuse_bias: bool = False):
    """Launch the dK/dV kernel of q's dtype (bf16: tensor cores, fp32:
    CUDA cores) on checked CUDA operands, aligned at launch (``bias`` as
    for :func:`dq_kernel`); returns per-q-head ``(B, S, H, Dh)`` dk and
    dv in q's dtype. ``block_idx`` only lends its shape (the buckets' ``nq``,
    ``mb``)."""
    got = launch_dkv_biased(q, k, v, dout, lse, delta, block_idx,
                            block_idx_t, buckets, bias, hoist_scale,
                            fuse_bias)
    return got[0], got[1]


@fake.launch_op("repro_torch::cluster_dkv_biased")
def launch_dkv_biased(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dout: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, block_idx: torch.Tensor,
                      block_idx_t: torch.Tensor, buckets: torch.Tensor,
                      bias: torch.Tensor, hoist_scale: bool,
                      fuse_bias: bool) -> list[torch.Tensor]:
    """One launch of the biased dK/dV kernel (:func:`dkv_kernel`): ``[dk,
    dv]`` per q head. A custom op with a fake implementation."""
    B, S, H, KV, Dh, nq, mb, bq, bk, nb = _sizes(q, k, block_idx, buckets,
                                                 bias, fuse_bias)
    q, k, v, dout, lse, block_idx_t, buckets = (
        _ca.aligned(x) for x in (q, k, v, dout, lse, block_idx_t, buckets))
    outs = _dkv_outputs(q)
    dkh, dvh = outs
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), block_idx_t.data_ptr(),
            buckets.data_ptr(), bias.data_ptr(), dkh.data_ptr(),
            dvh.data_ptr())
    sizes = (B, S, H, KV, Dh, nq, mb, S // bk, block_idx_t.shape[-2], bq,
             bk, nb, int(block_idx.dim() == 3), int(block_idx_t.dim() == 4))
    stream = torch.cuda.current_stream().cuda_stream
    sm90 = q.dtype == torch.bfloat16
    with torch.cuda.device(q.device):
        if sm90:
            err = LIBRARY_DKV_SM90.lib().cluster_attention_bwd_dkv_sm90(
                *ptrs, *sizes, int(fuse_bias), Dh ** -0.5, stream)
        else:
            err = LIBRARY.lib().cluster_attention_bwd_dkv(
                *ptrs, _ca._DTYPES[q.dtype], *sizes, int(hoist_scale),
                int(fuse_bias), Dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"cluster_attention_bwd dK/dV launch failed: "
                           f"CUDA error {err} ({q.dtype}, bq={bq}, bk={bk}, "
                           f"Dh={Dh}, n_buckets={nb}, mt="
                           f"{block_idx_t.shape[-2]})")
    global dkv_launches, dkv_sm90_launches, dkv_sm90_b16_launches
    if not sm90:
        dkv_launches += 1
    elif bq == 16:
        dkv_sm90_b16_launches += 1
    else:
        dkv_sm90_launches += 1
    return outs


@launch_dkv_biased.register_fake
def _(q, k, v, dout, lse, delta, block_idx, block_idx_t, buckets, bias,
      hoist_scale, fuse_bias):
    return _dkv_outputs(q)


def dq_unbiased_kernel(q, k, v, dout, lse, delta, block_idx, causal, *,
                       hoist_scale: bool = False):
    """Launch the unbiased dQ kernel of q's dtype (bf16: tensor cores,
    fp32: CUDA cores) on checked CUDA operands, aligned at launch;
    returns ``dq`` in q's dtype. ``hoist_scale`` is the fp32 kernel's
    flag; the bf16 one computes the same either way."""
    return launch_dq_unbiased(q, k, v, dout, lse, delta, block_idx, causal,
                              hoist_scale)[0]


@fake.launch_op("repro_torch::cluster_dq_unbiased")
def launch_dq_unbiased(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, block_idx: torch.Tensor,
                       causal: bool,
                       hoist_scale: bool) -> list[torch.Tensor]:
    """One launch of the unbiased dQ kernel (:func:`dq_unbiased_kernel`):
    ``[dq]``. A custom op with a fake implementation."""
    B, S, H, Dh = q.shape
    nq, mb = block_idx.shape[-2:]
    bq = S // nq
    stride = _ca.layout_stride(block_idx, 2)
    q, k, v, dout = (_ca.aligned(x) for x in (q, k, v, dout))
    outs = _dq_outputs(q, nq, 0)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), block_idx.data_ptr(),
            outs[0].data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    sm90 = q.dtype == torch.bfloat16
    with torch.cuda.device(q.device):
        if sm90:
            err = LIBRARY_UNBIASED_SM90.lib() \
                .cluster_attention_bwd_dq_unbiased_sm90(
                    *ptrs, B, S, H, k.shape[2], Dh, nq, mb, stride,
                    int(causal), Dh ** -0.5, stream)
        else:
            err = LIBRARY_UNBIASED.lib().cluster_attention_bwd_dq_unbiased(
                *ptrs, _ca._DTYPES[q.dtype], B, S, H, k.shape[2], Dh, nq, mb,
                stride, bq, bq, int(causal), int(hoist_scale), Dh ** -0.5,
                stream)
    if err != 0:
        raise RuntimeError(f"cluster_attention_bwd unbiased dQ launch "
                           f"failed: CUDA error {err} ({q.dtype} q "
                           f"{tuple(q.shape)}, block_idx "
                           f"{tuple(block_idx.shape)})")
    global dq_unbiased_launches, dq_unbiased_sm90_launches
    if sm90:
        dq_unbiased_sm90_launches += 1
    else:
        dq_unbiased_launches += 1
    return outs


@launch_dq_unbiased.register_fake
def _(q, k, v, dout, lse, delta, block_idx, causal, hoist_scale):
    return _dq_outputs(q, block_idx.shape[-2], 0)


def dkv_unbiased_kernel(q, k, v, dout, lse, delta, block_idx, block_idx_t,
                        causal, *, hoist_scale: bool = False):
    """Launch the unbiased dK/dV kernel of q's dtype (bf16: tensor cores,
    fp32: CUDA cores) on checked CUDA operands, aligned at launch; returns
    per-q-head ``(B, S, H, Dh)`` dk and dv in q's dtype. ``block_idx``
    only lends its shape (``bq``); ``hoist_scale`` as for
    :func:`dq_unbiased_kernel`."""
    got = launch_dkv_unbiased(q, k, v, dout, lse, delta, block_idx,
                              block_idx_t, causal, hoist_scale)
    return got[0], got[1]


@fake.launch_op("repro_torch::cluster_dkv_unbiased")
def launch_dkv_unbiased(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, block_idx: torch.Tensor,
                        block_idx_t: torch.Tensor, causal: bool,
                        hoist_scale: bool) -> list[torch.Tensor]:
    """One launch of the unbiased dK/dV kernel
    (:func:`dkv_unbiased_kernel`): ``[dk, dv]`` per q head. A custom op
    with a fake implementation."""
    B, S, H, Dh = q.shape
    bq = S // block_idx.shape[-2]
    nk, mt = block_idx_t.shape[-3:-1]
    stride = _ca.layout_stride(block_idx_t, 3)
    q, k, v, dout = (_ca.aligned(x) for x in (q, k, v, dout))
    outs = _dkv_outputs(q)
    dkh, dvh = outs
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), block_idx_t.data_ptr(),
            dkh.data_ptr(), dvh.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    sm90 = q.dtype == torch.bfloat16
    with torch.cuda.device(q.device):
        if sm90:
            err = LIBRARY_UNBIASED_SM90.lib() \
                .cluster_attention_bwd_dkv_unbiased_sm90(
                    *ptrs, B, S, H, k.shape[2], Dh, nk, mt, stride,
                    int(causal), Dh ** -0.5, stream)
        else:
            err = LIBRARY_UNBIASED.lib().cluster_attention_bwd_dkv_unbiased(
                *ptrs, _ca._DTYPES[q.dtype], B, S, H, k.shape[2], Dh, nk, mt,
                stride, bq, bq, int(causal), int(hoist_scale), Dh ** -0.5,
                stream)
    if err != 0:
        raise RuntimeError(f"cluster_attention_bwd unbiased dK/dV launch "
                           f"failed: CUDA error {err} ({q.dtype} q "
                           f"{tuple(q.shape)}, block_idx_t "
                           f"{tuple(block_idx_t.shape)})")
    global dkv_unbiased_launches, dkv_unbiased_sm90_launches
    if sm90:
        dkv_unbiased_sm90_launches += 1
    else:
        dkv_unbiased_launches += 1
    return outs


@launch_dkv_unbiased.register_fake
def _(q, k, v, dout, lse, delta, block_idx, block_idx_t, causal,
      hoist_scale):
    return _dkv_outputs(q)


def cluster_attention_bwd(q, k, v, dout, out, lse, block_idx, buckets,
                          bias_table, block_idx_t=None, *,
                          causal: bool = False, hoist_scale: bool = False,
                          fuse_bias: bool = False):
    """Gradients ``(dq, dk, dv, dbias)`` of the cluster-sparse attention on
    CUDA tensors (shape contract in ``kernels/ref.py``): launches the dQ
    and dK/dV kernels, or raises. Without buckets the unbiased kernels run
    (``causal`` masks positionally) and ``dbias`` is None. ``out`` and
    ``lse`` are the forward's output and logsumexp residual, under the
    same ``hoist_scale`` and ``fuse_bias`` (module docstring)."""
    check_args(q, k, v, dout, out, lse, block_idx, buckets, bias_table,
               block_idx_t)
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"cluster_attention_bwd has no kernel for device {q.device}")
    if buckets is not None and causal:
        raise ValueError("the bucketed cluster kernels have no causal mask "
                         "(masking lives in the buckets)")
    if buckets is None:
        if fuse_bias:
            raise ValueError("fuse_bias needs buckets: the unbiased op has "
                             "no bias table to extend")
        _ca.check_unbiased_kernel(q, block_idx, block_idx_t,
                                  backward=True)
    else:
        _ca.check_biased_kernel(q, block_idx, buckets)
    if block_idx_t is None:
        block_idx_t = _ref.derive_block_idx_t(
            block_idx, q.shape[1] // _ref.block_dims(q, block_idx,
                                                     buckets)[2])
    delta = _ref.row_delta(dout, out)
    KV = k.shape[2]
    if buckets is None:
        q, k, v, dout, lse, block_idx, block_idx_t = (
            x.contiguous() for x in (q, k, v, dout, lse, block_idx,
                                     block_idx_t))
        dq = dq_unbiased_kernel(q, k, v, dout, lse, delta, block_idx, causal,
                                hoist_scale=hoist_scale)
        dkh, dvh = dkv_unbiased_kernel(q, k, v, dout, lse, delta, block_idx,
                                       block_idx_t, causal,
                                       hoist_scale=hoist_scale)
        return (dq, _ref.group_sum(dkh, KV).to(k.dtype),
                _ref.group_sum(dvh, KV).to(v.dtype), None)
    q, k, v, dout, lse, block_idx, block_idx_t, buckets = (
        x.contiguous() for x in (q, k, v, dout, lse, block_idx, block_idx_t,
                                 buckets))
    bias = _ref.extend_bias_table(bias_table) if fuse_bias \
        else bias_table.float().contiguous()
    flags = dict(hoist_scale=hoist_scale, fuse_bias=fuse_bias)
    dq, db_part = dq_kernel(q, k, v, dout, lse, delta, block_idx, buckets,
                            bias, **flags)
    dkh, dvh = dkv_kernel(q, k, v, dout, lse, delta, block_idx, block_idx_t,
                          buckets, bias, **flags)
    return (dq, _ref.group_sum(dkh, KV).to(k.dtype),
            _ref.group_sum(dvh, KV).to(v.dtype),
            db_part.sum(dim=(0, 2)).to(bias_table.dtype))
