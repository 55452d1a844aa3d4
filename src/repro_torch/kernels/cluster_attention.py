"""Wrappers, builds and launch counters of the CUDA cluster-sparse
attention forwards:

* the ports of the TPU kernel ``_cluster_kernel_biased``
  (``src/repro/kernels/cluster_attention.py``): int8 bias buckets, the
  graph transformer's path. Each dtype has exactly one kernel, with no
  fallback between them: bfloat16 runs on the tensor cores
  (``csrc/cluster_attention_fwd_sm90.cu``: ``mma.sync`` on 16- or 32-row
  tiles, one warp per head, a ``cp.async`` ring of visited k-blocks),
  float32 on CUDA cores in fp32 throughout
  (``csrc/cluster_attention_fwd.cu``). ``biased_kernel_reason`` states
  what the bf16 kernel takes;
* the ports of ``_cluster_kernel``: no buckets, an optional positional
  causal mask, the token LM's local+global path and the mask-free graph
  batch of the paper's scale run (``launch/graph_dryrun.py``: one layout
  per graph, Graphormer's head dims 8 and 24). Each dtype has exactly
  one kernel, with no fallback between them: bfloat16 runs on the tensor
  cores (``csrc/cluster_attention_unbiased_fwd_sm90.cu``: TMA copies of
  the visited k-blocks into a ring of shared-memory stages feeding
  ``wgmma``), float32 on CUDA cores in fp32 throughout
  (``csrc/cluster_attention_unbiased_fwd.cu``; TF32 would miss the fp32
  tolerances). ``check_unbiased_kernel`` states what each takes.

The kernels are compiled at first use (``kernels/build.py``: nvcc for
``sm_90a``, a plain C entry point, ``ctypes``).

The schedule's rewrites are flags of these kernels, as of the reference's:
``hoist_scale`` scales the fp32 q tile once before the product in the
fp32 kernels; the bf16 kernels fold the scale with log2 e into their one
fp32 ``exp2`` argument whatever the flag (a scaled q is no bf16 value),
so both values launch the same code there. ``fuse_bias`` (biased only)
hands the kernels ``ref.extend_bias_table``'s operand, one sentinel
column wider, and they look the masked bucket -1 up in it instead of
selecting the mask.

The wrapper takes CUDA tensors only: it launches a kernel or raises.
``kernels/ops.py`` sends CPU tensors to the plain version
(``kernels/ref.py``). Build and launch errors propagate: nothing falls
back.

Each launch is a ``torch.library`` custom op (``launch_fwd_biased``,
``launch_fwd_unbiased``) with a fake implementation that gives the real
launch's outputs, the split plan's partial slots included: a fake trace
of a step (``repro_torch.fake``, ``launch/dryrun.py``) goes through the
wrapper, reads no device address and launches nothing. A real call
reaches the op through the dispatcher only under a dispatch mode
(``fake.launch_op``); otherwise it calls the launch directly. The split plan
of a fake layout comes from the host array it was made from
(:func:`keep_host_copy`).
"""

from __future__ import annotations

import ctypes
import math
import pathlib
import weakref
from typing import Optional

import numpy as np
import torch

from repro_torch import fake
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.build import CudaLibrary

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# what the bf16 biased kernels (forward, dQ and dK/dV) take: the graph
# layouts' square blocks of 16 (the graph-level task's packed mini-graphs)
# or 32 (one large graph) rows, each its own instantiation, and head dims
# a multiple of 8 up to 64
BIASED_SM90_BLOCKS = (16, 32)
BIASED_SM90_HEAD_DIMS = tuple(range(8, 65, 8))
# what the unbiased kernels take: the graph models' head dims (the biased
# bf16 kernels') and the LM's 128, each its own instantiation; fp32
# q/k-blocks in multiples of their 64 x 64 score tiles; bf16 (forward and
# backward) q/k-blocks of 128 rows, one TMA box each. Both take a layout
# shared by the batch or one per sequence.
UNBIASED_HEAD_DIMS = BIASED_SM90_HEAD_DIMS + (128,)
UNBIASED_TILE = 64
UNBIASED_SM90_BLOCK = 128
# the bf16 forward and dQ cut a q-block row with more visits than
# max(SPLIT_MIN_PIECE, SPLIT_MEAN_FACTOR x the mean row) into pieces of
# about that many visits (``split_plan``)
SPLIT_MIN_PIECE = 64
SPLIT_MEAN_FACTOR = 4

# kernel launches since the last reset_count(), one count per kernel
launches = 0                # fp32 biased, cluster_attention_fwd.cu
sm90_launches = 0           # bf16 biased, cluster_attention_fwd_sm90.cu,
sm90_b16_launches = 0       # at 32 x 32 and at 16 x 16 blocks
unbiased_launches = 0       # fp32 unbiased, cluster_attention_unbiased_fwd.cu
unbiased_sm90_launches = 0  # bf16 unbiased, ..._unbiased_fwd_sm90.cu


def reset_count() -> None:
    global launches, sm90_launches, sm90_b16_launches, unbiased_launches, \
        unbiased_sm90_launches
    launches = sm90_launches = sm90_b16_launches = 0
    unbiased_launches = unbiased_sm90_launches = 0


def _bind(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cluster_attention_fwd.argtypes = (
        [vp] * 8 + [i32] * 14 + [ctypes.c_float, vp])
    lib.cluster_attention_fwd.restype = i32


def _bind_sm90(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cluster_attention_fwd_sm90.argtypes = (
        [vp] * 12 + [i32] * 14 + [ctypes.c_float, vp])
    lib.cluster_attention_fwd_sm90.restype = i32


def _bind_unbiased(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cluster_attention_fwd_unbiased.argtypes = (
        [vp] * 6 + [i32] * 13 + [ctypes.c_float, vp])
    lib.cluster_attention_fwd_unbiased.restype = i32


def _bind_unbiased_sm90(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cluster_attention_fwd_unbiased_sm90.argtypes = (
        [vp] * 6 + [i32] * 9 + [ctypes.c_float, vp])
    lib.cluster_attention_fwd_unbiased_sm90.restype = i32


_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
LIBRARY = CudaLibrary(_CSRC / "cluster_attention_fwd.cu", _bind)
LIBRARY_SM90 = CudaLibrary(_CSRC / "cluster_attention_fwd_sm90.cu",
                           _bind_sm90)
LIBRARY_UNBIASED = CudaLibrary(_CSRC / "cluster_attention_unbiased_fwd.cu",
                               _bind_unbiased)
LIBRARY_UNBIASED_SM90 = CudaLibrary(
    _CSRC / "cluster_attention_unbiased_fwd_sm90.cu", _bind_unbiased_sm90)


def check_args(q, k, v, block_idx, buckets, bias_table):
    """Raise unless the arguments meet the op's dtype, device and shape
    contract (``kernels/ref.py``). ``buckets`` and ``bias_table`` are
    both given (the biased op) or both None (the unbiased one)."""
    B, S, H, Dh = q.shape
    if q.dtype not in _DTYPES:
        raise NotImplementedError(
            f"cluster_attention kernel takes float32 or bfloat16, "
            f"got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
        if x.dim() != 4 or x.shape[0] != B or x.shape[1] != S \
                or x.shape[3] != Dh:
            raise ValueError(f"{name} must be (B, S, KV, Dh) = "
                             f"({B}, {S}, KV, {Dh}), got {tuple(x.shape)}")
    if k.shape != v.shape or H % k.shape[2]:
        raise ValueError(f"k/v heads {k.shape[2]} must divide q heads {H}")
    if block_idx.dtype != torch.int32 or block_idx.dim() not in (2, 3):
        raise ValueError("block_idx must be int32 (nq, mb) or (B, nq, mb)")
    if block_idx.dim() == 3 and block_idx.shape[0] != B:
        raise ValueError(f"per-graph block_idx batch {block_idx.shape[0]} "
                         f"!= {B}")
    nq = block_idx.shape[-2]
    if S % nq:
        raise ValueError(f"sequence {S} is not tiled by {nq} q-block rows")
    if (buckets is None) != (bias_table is None):
        raise ValueError("buckets and bias_table come together: the "
                         "unbiased op takes neither")
    devs = [("block_idx", block_idx)]
    if buckets is not None:
        bq = S // nq
        want = tuple(block_idx.shape) + (bq, buckets.shape[-1])
        if buckets.dtype != torch.int8 or tuple(buckets.shape) != want:
            raise ValueError(f"buckets must be int8 "
                             f"{tuple(block_idx.shape)} + ({bq}, bk), got "
                             f"{buckets.dtype} {tuple(buckets.shape)}")
        if S % buckets.shape[-1]:
            raise ValueError(f"sequence {S} is not tiled by k-blocks of "
                             f"{buckets.shape[-1]}")
        if bias_table.dim() != 2 or bias_table.shape[0] != H:
            raise ValueError(f"bias_table must be (H={H}, n_buckets), got "
                             f"{tuple(bias_table.shape)}")
        devs += [("buckets", buckets), ("bias_table", bias_table)]
    for name, x in devs:
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def biased_kernel_reason(dtype, d_head: int, bq: int,
                         bk: int) -> str | None:
    """Why the biased kernels of ``dtype`` (a torch dtype) do not take
    head dim ``d_head`` and q/k-blocks of ``bq`` x ``bk``, or None when
    they do. float32 runs the CUDA-core kernels, which take any tile
    their shared memory holds; bfloat16 the tensor-core forward, dQ and
    dK/dV, which take ``bq = bk`` of 16 or 32 (``BIASED_SM90_BLOCKS``:
    the graph-level task's 16 x 16 blocks, the node and link tasks' 32 x
    32) and Dh in ``BIASED_SM90_HEAD_DIMS``."""
    if dtype not in _DTYPES:
        return f"{dtype} (the kernels take float32 or bfloat16)"
    if dtype != torch.bfloat16:
        return None
    if bq != bk or bq not in BIASED_SM90_BLOCKS:
        return (f"bq={bq}, bk={bk} (the bf16 kernels take bq = bk = 16 or "
                f"32)")
    if d_head not in BIASED_SM90_HEAD_DIMS:
        return (f"Dh={d_head} (the bf16 kernels take Dh a multiple of 8 "
                f"from 8 to 64)")
    return None


def split_plan(visits, B: int, piece: int):
    """The split grid of the bf16 forward and dQ, from the visit counts of
    the q-block rows (``visits`` (nq,) for a layout shared by the batch,
    (B, nq) per graph): every row with more than ``piece`` visits becomes
    ceil(visits / piece) pieces of near-equal size, each with its own
    partial slot. Returns ``(pieces, splits)`` int32 arrays, or None
    when no row is cut: ``pieces`` (n, 4) the work items (b * nq + qi,
    first visit, end visit, slot or -1 for a whole row), the split rows'
    pieces first, heaviest row first; ``splits`` (m, 4) the split rows
    (b * nq + qi, first slot, pieces, 0), whose slots the combine kernels
    merge in that order."""
    nq = np.shape(visits)[-1]
    v = np.broadcast_to(np.asarray(visits, np.int64), (B, nq))
    heavy = np.flatnonzero(v.ravel() > piece)
    if heavy.size == 0:
        return None
    heavy = heavy[np.argsort(-v.ravel()[heavy], kind="stable")]
    pieces, splits, slot = [], [], 0
    for row in heavy:
        n = int(v.ravel()[row])
        k = -(-n // piece)
        splits.append((row, slot, k, 0))
        pieces += [(row, j * n // k, (j + 1) * n // k, slot + j)
                   for j in range(k)]
        slot += k
    whole = np.setdiff1d(np.arange(B * nq), heavy)
    pieces += [(row, 0, int(v.ravel()[row]), -1) for row in whole]
    return (np.asarray(pieces, np.int32).reshape(-1, 4),
            np.asarray(splits, np.int32).reshape(-1, 4))


# (id of a block_idx tensor) -> (weakref, its version, B, plan on its
# device): the plan of a layout tensor is derived once, with the one host
# sync its visit counts take, and reused by every later launch on it
_PLANS: dict = {}


def fwd_plan(block_idx, B: int):
    """``split_plan`` of a device ``block_idx`` at the pieces the bf16
    forward and dQ use, as ``(pieces, splits, partial slots)`` with the
    two tables on the layout's device, or None; cached per layout tensor
    (and its version, so an in-place edit re-derives it)."""
    key = id(block_idx)
    hit = _PLANS.get(key)
    if hit is not None and hit[0]() is block_idx \
            and hit[1] == block_idx._version and hit[2] == B:
        return hit[3]
    visits = (host_layout(block_idx) >= 0).sum(-1)
    piece = max(SPLIT_MIN_PIECE, math.ceil(SPLIT_MEAN_FACTOR * visits.mean()))
    plan = split_plan(visits, B, piece)
    if plan is not None:
        pieces, splits = plan
        plan = (torch.from_numpy(pieces).to(block_idx.device),
                torch.from_numpy(splits).to(block_idx.device),
                int(splits[:, 2].sum()))
    _PLANS[key] = (weakref.ref(block_idx, lambda _, k=key: _PLANS.pop(k,
                                                                     None)),
                   block_idx._version, B, plan)
    return plan


def host_layout(layout) -> np.ndarray:
    """A layout tensor's values on the host: a real tensor's, copied (one
    sync), or a fake one's from the host array it was made from
    (:func:`keep_host_copy`; a fake tensor holds no values)."""
    if fake.is_fake(layout):
        host = getattr(layout, "host_copy", None)
        if host is None:
            raise NotImplementedError(
                "a fake layout tensor needs the host array it was made "
                "from (cluster_attention.keep_host_copy) for the split "
                "plan")
        return np.asarray(host)
    return layout.cpu().numpy()


def keep_host_copy(layout, host):
    """``layout`` (a device tensor made from the array ``host``), holding
    ``host`` when it is fake, for :func:`host_layout`."""
    if fake.is_fake(layout):
        layout.host_copy = host
    return layout


def check_biased_kernel(q, block_idx, buckets):
    """Raise ``NotImplementedError`` with the dtype and the shapes unless
    the biased kernels of q's dtype take them
    (``biased_kernel_reason``)."""
    bq = q.shape[1] // block_idx.shape[-2]
    reason = biased_kernel_reason(q.dtype, q.shape[3], bq,
                                  buckets.shape[-1])
    if reason is not None:
        raise NotImplementedError(
            f"the biased cluster_attention kernels do not take {reason}: "
            f"{str(q.dtype).split('.')[-1]} q {tuple(q.shape)}, block_idx "
            f"{tuple(block_idx.shape)}, buckets {tuple(buckets.shape)}")


def unbiased_kernel_reason(dtype, d_head: int, bq: int, *,
                           backward: bool = False) -> str | None:
    """Why the unbiased kernel of ``dtype`` (a torch dtype) does not take
    head dim ``d_head`` and q/k-blocks of ``bq`` rows, or None when it
    does. ``backward`` asks about the dQ and dK/dV kernels, which take
    what the forward of the same dtype takes. Every kernel takes a layout
    shared by the batch and one per sequence."""
    if d_head not in UNBIASED_HEAD_DIMS:
        return (f"Dh={d_head} (the kernels take Dh a multiple of 8 from 8 "
                f"to 64, or 128)")
    if dtype == torch.bfloat16:
        if bq != UNBIASED_SM90_BLOCK:
            half = "backward" if backward else "forward"
            return (f"bq=bk={bq} (the bf16 {half} takes bq = bk = "
                    f"{UNBIASED_SM90_BLOCK}, one TMA box a block)")
    elif bq % UNBIASED_TILE:
        return (f"bq=bk={bq} (the kernels take bq = bk a multiple of "
                f"{UNBIASED_TILE})")
    return None


def check_unbiased_kernel(q, block_idx, block_idx_t=None, *,
                          backward: bool = False):
    """Raise ``NotImplementedError`` with the shapes unless the unbiased
    kernels of q's dtype take them (``unbiased_kernel_reason``): Dh in
    ``UNBIASED_HEAD_DIMS``; bf16 ``bq`` = bk = ``UNBIASED_SM90_BLOCK``,
    fp32 ``bq`` a multiple of ``UNBIASED_TILE``. The layouts may be
    shared by the batch (``block_idx`` (nq, mb), ``block_idx_t`` (nk, mt,
    2)) or per sequence (``(B, nq, mb)``, ``(B, nk, mt, 2)``)."""
    Dh = q.shape[3]
    bq = q.shape[1] // block_idx.shape[-2]
    reason = unbiased_kernel_reason(q.dtype, Dh, bq, backward=backward)
    if reason is not None:
        t_shape = None if block_idx_t is None else tuple(block_idx_t.shape)
        raise NotImplementedError(
            f"the unbiased cluster_attention kernels do not take {reason}: "
            f"{str(q.dtype).split('.')[-1]} q {tuple(q.shape)}, block_idx "
            f"{tuple(block_idx.shape)}, block_idx_t {t_shape}")


def layout_stride(layout, shared_dim: int) -> int:
    """The batch stride, in entries, that the unbiased kernels take for a
    layout tensor whose batch-shared form has ``shared_dim`` dims
    (``block_idx`` 2, ``block_idx_t`` 3): 0 for a shared one, one
    sequence's entries for a per-sequence one."""
    return layout[0].numel() if layout.dim() == shared_dim + 1 else 0


def _ptr(x):
    """A tensor's device address for a kernel argument, NULL for None."""
    return None if x is None else x.data_ptr()


def aligned(x):
    """``x`` contiguous at a 16-byte aligned address (the kernels read
    rows in 16-byte pieces): a copy only when it is not already."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def cluster_attention_fwd(q, k, v, block_idx, buckets, bias_table, *,
                          causal: bool = False, return_lse: bool = False,
                          hoist_scale: bool = False,
                          fuse_bias: bool = False):
    """Cluster-sparse attention forward on CUDA tensors (shape contract in
    ``kernels/ref.py``): launches the biased kernel of q's dtype (bf16:
    tensor cores, fp32: CUDA cores), or without buckets the unbiased
    one, or raises. ``block_idx`` entries are -1 or k-block
    ids below ``S // bk``, as the layout builders emit them; the kernels
    read whatever block an entry names, so the values are the caller's
    contract (checking them would cost a device sync per call). The same
    holds for buckets: -1 or below ``n_buckets`` (``fuse_bias`` looks any
    other negative or any bucket above up in the sentinel column, where
    the select clips it onto the last column). ``hoist_scale`` and
    ``fuse_bias`` are the schedule's rewrites (module docstring)."""
    check_args(q, k, v, block_idx, buckets, bias_table)
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"cluster_attention has no kernel for device {q.device}")
    if buckets is None:
        if fuse_bias:
            raise ValueError("fuse_bias needs buckets: the unbiased op has "
                             "no bias table to extend")
        return _fwd_unbiased(q, k, v, block_idx, causal, return_lse,
                             hoist_scale)
    if causal:
        raise ValueError("the bucketed cluster kernel has no causal mask "
                         "(masking lives in the buckets)")
    check_biased_kernel(q, block_idx, buckets)
    B = q.shape[0]
    sm90 = q.dtype == torch.bfloat16
    plan = fwd_plan(block_idx, B) if sm90 else None
    pieces, splits, slots = plan or (None, None, 0)
    bias = _ref.extend_bias_table(bias_table) if fuse_bias \
        else bias_table.float().contiguous()
    got = launch_fwd_biased(q, k, v, block_idx, buckets, bias, pieces,
                            splits, slots, return_lse, hoist_scale,
                            fuse_bias)
    return (got[0], got[1]) if return_lse else got[0]


def _fwd_outputs(q, return_lse: bool, part=None) -> list:
    """The forward launches' outputs, as the kernels write them and as a
    fake launch gives them: O like q (contiguous), the ``(B*H, S)`` fp32
    logsumexp with ``return_lse``, and with ``part = (slots, bq)`` the
    bf16 biased forward's partial slots of the split rows, fp32 O and
    (max, sum) a row."""
    B, S, H, Dh = q.shape
    outs = [torch.empty(q.shape, dtype=q.dtype, device=q.device)]
    if return_lse:
        outs.append(torch.empty((B * H, S), dtype=torch.float32,
                                device=q.device))
    if part is not None:
        slots, bq = part
        outs += [torch.empty((slots, H, bq, Dh), dtype=torch.float32,
                             device=q.device),
                 torch.empty((slots, H, 2, bq), dtype=torch.float32,
                             device=q.device)]
    return outs


@fake.launch_op("repro_torch::cluster_fwd_biased")
def launch_fwd_biased(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      block_idx: torch.Tensor, buckets: torch.Tensor,
                      bias: torch.Tensor, pieces: Optional[torch.Tensor],
                      splits: Optional[torch.Tensor], slots: int,
                      return_lse: bool, hoist_scale: bool,
                      fuse_bias: bool) -> list[torch.Tensor]:
    """One launch of the biased forward kernel of q's dtype on checked
    CUDA operands (``bias`` fp32, under ``fuse_bias`` the extended
    table; the bf16 kernel's split plan ``pieces``, ``splits`` and its
    ``slots``): ``[O, lse (with return_lse), the bf16 kernel's partial
    slots]`` (:func:`_fwd_outputs`). A custom op (``fake.launch_op``),
    so that a fake trace takes its outputs' shapes from
    ``register_fake`` and launches nothing."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    nq, mb = block_idx.shape[-2:]
    bq, bk = S // nq, buckets.shape[-1]
    nb = bias.shape[1] - int(fuse_bias)
    sm90 = q.dtype == torch.bfloat16
    q, k, v = aligned(q), aligned(k), aligned(v)
    block_idx, buckets = aligned(block_idx), aligned(buckets)
    outs = _fwd_outputs(q, return_lse, (slots, bq) if sm90 else None)
    out, lse = outs[0], outs[1] if return_lse else None
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), block_idx.data_ptr(),
            buckets.data_ptr(), bias.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    global launches, sm90_launches, sm90_b16_launches
    with torch.cuda.device(q.device):
        if sm90:
            part_o, part_ml = outs[-2:]
            err = LIBRARY_SM90.lib().cluster_attention_fwd_sm90(
                *ptrs, _ptr(pieces), _ptr(splits), out.data_ptr(), _ptr(lse),
                part_o.data_ptr(), part_ml.data_ptr(), B, S, H, KV, Dh, nq,
                mb, bq, bk, nb, int(block_idx.dim() == 3),
                0 if pieces is None else len(pieces),
                0 if splits is None else len(splits), int(fuse_bias),
                Dh ** -0.5, stream)
        else:
            err = LIBRARY.lib().cluster_attention_fwd(
                *ptrs, out.data_ptr(), _ptr(lse), _DTYPES[q.dtype], B, S, H,
                KV, Dh, nq, mb, bq, bk, nb, int(block_idx.dim() == 3),
                int(hoist_scale), int(fuse_bias), Dh ** -0.5, stream)
    if err != 0:
        # e.g. 1 (invalid value): the tiles of bq, bk, Dh and n_buckets
        # (and, in bf16, the visit list of mb slots) need more shared
        # memory than one block may have on this card
        raise RuntimeError(f"cluster_attention_fwd launch failed: CUDA "
                           f"error {err} ({q.dtype}, bq={bq}, bk={bk}, "
                           f"Dh={Dh}, n_buckets={nb}, mb={mb})")
    if not sm90:
        launches += 1
    elif bq == 16:
        sm90_b16_launches += 1
    else:
        sm90_launches += 1
    return outs


@launch_fwd_biased.register_fake
def _(q, k, v, block_idx, buckets, bias, pieces, splits, slots, return_lse,
      hoist_scale, fuse_bias):
    bq = q.shape[1] // block_idx.shape[-2]
    return _fwd_outputs(q, return_lse, (slots, bq)
                        if q.dtype == torch.bfloat16 else None)


def _fwd_unbiased(q, k, v, block_idx, causal, return_lse, hoist_scale):
    check_unbiased_kernel(q, block_idx)
    got = launch_fwd_unbiased(q, k, v, block_idx, causal, return_lse,
                              hoist_scale)
    return (got[0], got[1]) if return_lse else got[0]


@fake.launch_op("repro_torch::cluster_fwd_unbiased")
def launch_fwd_unbiased(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_idx: torch.Tensor, causal: bool,
                        return_lse: bool,
                        hoist_scale: bool) -> list[torch.Tensor]:
    """One launch of the unbiased forward kernel of q's dtype on checked
    CUDA operands: ``[O, lse (with return_lse)]``. A custom op, as
    :func:`launch_fwd_biased`."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    nq, mb = block_idx.shape[-2:]
    bq = S // nq
    q, k, v = aligned(q), aligned(k), aligned(v)
    block_idx = block_idx.contiguous()
    stride = layout_stride(block_idx, 2)
    outs = _fwd_outputs(q, return_lse)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), block_idx.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr() if return_lse else None)
    stream = torch.cuda.current_stream().cuda_stream
    global unbiased_launches, unbiased_sm90_launches
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            err = LIBRARY_UNBIASED_SM90.lib() \
                .cluster_attention_fwd_unbiased_sm90(
                    *ptrs, B, S, H, KV, Dh, nq, mb, stride, int(causal),
                    Dh ** -0.5, stream)
        else:
            err = LIBRARY_UNBIASED.lib().cluster_attention_fwd_unbiased(
                *ptrs, _DTYPES[q.dtype], B, S, H, KV, Dh, nq, mb, stride,
                bq, bq, int(causal), int(hoist_scale), Dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"cluster_attention_fwd_unbiased launch failed: "
                           f"CUDA error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, block_idx "
                           f"{tuple(block_idx.shape)}, causal={causal})")
    if q.dtype == torch.bfloat16:
        unbiased_sm90_launches += 1
    else:
        unbiased_launches += 1
    return outs


@launch_fwd_unbiased.register_fake
def _(q, k, v, block_idx, causal, return_lse, hoist_scale):
    return _fwd_outputs(q, return_lse)
