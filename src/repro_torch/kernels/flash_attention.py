"""Wrappers, build and launch counters of the CUDA dense flash attention
kernels, the ports of the TPU kernels in
``src/repro/kernels/flash_attention.py`` (the GP-FLASH baseline):

* ``_flash_kernel``, the forward with the online softmax, the optional
  causal mask, GQA, ragged ``Sq``/``Sk`` and the ``hoist_scale`` rewrite,
  at the schedule's ``block_q`` / ``block_k``;
* ``_flash_dq_kernel`` and ``_flash_dkv_kernel``, the recomputation
  backward (per-q-head dK/dV; the GQA sum and ``delta = rowsum(dO * O)``
  are plain PyTorch around the launches, as the reference's jnp epilogue
  and prologue).

Each dtype has exactly one kernel, with no fallback between them:

* bfloat16 runs on the tensor cores: ``csrc/flash_attention_fwd_sm90.cu``
  (the forward), ``csrc/flash_attention_bwd_dq_sm90.cu`` (dQ) and
  ``csrc/flash_attention_bwd_dkv_sm90.cu`` (dK/dV), TMA copies into a
  ring of shared-memory stages feeding ``wgmma``;
* float32 runs on CUDA cores, in fp32 throughout (TF32 would miss the
  fp32 tolerances): ``csrc/flash_attention_fwd.cu`` and
  ``flash_dq_kernel`` / ``flash_dkv_kernel`` in
  ``csrc/flash_attention_bwd.cu``. The autotuner runs its cases in fp32,
  so it times these.

``check_launch`` states what each dtype's forward takes. The kernels are
compiled at first use (``kernels/build.py``: nvcc for ``sm_90a``, a plain
C entry point, ``ctypes``). The wrappers take CUDA tensors only: they
launch a kernel or raise. ``kernels/ops.py`` sends CPU tensors to the
plain versions (``kernels/ref.py``).
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.cluster_attention import aligned

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
TILE = 64                  # the kernels' score tiles are TILE x TILE
BLOCK_QS = (64, 128)       # q rows a forward CTA holds: one or two tiles
# bf16 k/v stages: whole TILE-row chunks, one TMA box (at most 256 rows)
SM90_BLOCK_KS = (64, 128, 256)
# shared memory one block may have on sm_90 (the card's opt-in limit)
SMEM_LIMIT = 232448

# launches of each kernel since the last reset_count()
launches = 0           # the fp32 forward, flash_attention_fwd.cu
dq_launches = 0        # the fp32 dQ, flash_attention_bwd.cu
dkv_launches = 0       # the fp32 dK/dV, flash_attention_bwd.cu
sm90_launches = 0      # the bf16 forward, flash_attention_fwd_sm90.cu
dq_sm90_launches = 0   # the bf16 dQ, flash_attention_bwd_dq_sm90.cu
dkv_sm90_launches = 0  # the bf16 dK/dV, flash_attention_bwd_dkv_sm90.cu


def reset_count() -> None:
    global launches, dq_launches, dkv_launches, sm90_launches, \
        dq_sm90_launches, dkv_sm90_launches
    launches = dq_launches = dkv_launches = 0
    sm90_launches = dq_sm90_launches = dkv_sm90_launches = 0


def _bind(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = (
        [vp] * 5 + [i32] * 11 + [ctypes.c_float, vp])
    lib.flash_attention_fwd.restype = i32


def _bind_sm90(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd_sm90.argtypes = (
        [vp] * 5 + [i32] * 9 + [ctypes.c_float, vp])
    lib.flash_attention_fwd_sm90.restype = i32


def _bind_dq_sm90(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_dq_sm90.argtypes = (
        [vp] * 7 + [i32] * 7 + [ctypes.c_float, vp])
    lib.flash_attention_bwd_dq_sm90.restype = i32


def _bind_dkv_sm90(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_dkv_sm90.argtypes = (
        [vp] * 8 + [i32] * 7 + [ctypes.c_float, vp])
    lib.flash_attention_bwd_dkv_sm90.restype = i32


def _bind_bwd(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_dq.argtypes = (
        [vp] * 7 + [i32] * 9 + [ctypes.c_float, vp])
    lib.flash_attention_bwd_dq.restype = i32
    lib.flash_attention_bwd_dkv.argtypes = (
        [vp] * 8 + [i32] * 9 + [ctypes.c_float, vp])
    lib.flash_attention_bwd_dkv.restype = i32


_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
LIBRARY = CudaLibrary(_CSRC / "flash_attention_fwd.cu", _bind)
LIBRARY_BWD = CudaLibrary(_CSRC / "flash_attention_bwd.cu", _bind_bwd)
LIBRARY_SM90 = CudaLibrary(_CSRC / "flash_attention_fwd_sm90.cu", _bind_sm90)
LIBRARY_DQ_SM90 = CudaLibrary(_CSRC / "flash_attention_bwd_dq_sm90.cu",
                              _bind_dq_sm90)
LIBRARY_DKV_SM90 = CudaLibrary(_CSRC / "flash_attention_bwd_dkv_sm90.cu",
                               _bind_dkv_sm90)


def fwd_smem_bytes(d_head: int, block_q: int, block_k: int, dtype) -> int:
    """Shared memory of one forward CTA. fp32: the q tiles, a k and a v
    stage (fp32 rows padded by 4) and the 64 x 68 probability tile. bf16:
    the q tile and two stages of k and v, plus 2 KB for the barriers and
    the 1024-byte alignment of the swizzled tiles."""
    if torch_dtype(dtype) == torch.bfloat16:
        return 2 * d_head * (block_q + 4 * block_k) + 2048
    return 4 * ((block_q + 2 * block_k) * (d_head + 4) + TILE * (TILE + 4))


def torch_dtype(dtype):
    """``dtype`` (a torch dtype or its name) as a torch dtype, or None."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype).rsplit(".", 1)[-1], None)


def check_launch(d_head: int, block_q: int, block_k: int,
                 dtype) -> str | None:
    """Why the flash kernels do not take ``(d_head, block_q, block_k,
    dtype)``, or None when they do. ``dtype`` is a torch dtype or its
    name. The wrappers raise with this reason; the autotuner's enumerator
    prunes candidates with it."""
    dt = torch_dtype(dtype)
    if dt not in _DTYPES:
        return f"dtype {dtype} (the kernels take float32 and bfloat16)"
    if d_head not in HEAD_DIMS:
        return f"Dh={d_head} (the kernels take Dh in {HEAD_DIMS})"
    if block_q not in BLOCK_QS:
        return (f"block_q={block_q} (a CTA holds one or two {TILE}-row q "
                f"tiles: block_q in {BLOCK_QS})")
    if block_k <= 0 or block_k % TILE:
        return (f"block_k={block_k} (k/v stages are whole {TILE}-row "
                f"chunks)")
    if dt == torch.bfloat16 and block_k not in SM90_BLOCK_KS:
        return (f"block_k={block_k} (a bf16 k/v stage is one TMA box of "
                f"at most 256 rows: block_k in {SM90_BLOCK_KS})")
    smem = fwd_smem_bytes(d_head, block_q, block_k, dt)
    if smem > SMEM_LIMIT:
        return (f"block_q={block_q}, block_k={block_k} at Dh={d_head} need "
                f"{smem} bytes of shared memory, above the {SMEM_LIMIT} a "
                f"block may have")
    return None


def check_args(q, k, v):
    """Raise unless q ``(B, Sq, H, Dh)`` and k/v ``(B, Sk, KV, Dh)`` meet
    the op's contract: float dtypes alike, one device, ``KV`` divides
    ``H``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Sq, H, Dh) and k/v (B, Sk, KV, "
                         f"Dh), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: same B and Dh, KV dividing H")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
    if not q.dtype.is_floating_point:
        raise ValueError(f"flash_attention takes float tensors, got "
                         f"{q.dtype}")


def _check_device(q):
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"flash_attention has no kernel for device {q.device}")


def _check_kernel(q, k, block_q, block_k):
    _check_device(q)
    reason = check_launch(q.shape[3], block_q, block_k, q.dtype)
    if reason is not None:
        raise NotImplementedError(
            f"the flash kernels do not take {reason}; q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}")


def flash_attention_fwd(q, k, v, *, causal: bool = True, block_q: int,
                        block_k: int, hoist_scale: bool = False,
                        return_lse: bool = False):
    """Dense attention forward on CUDA tensors: O ``(B, Sq, H, Dh)`` in
    q's dtype and, with ``return_lse``, the logsumexp ``(B*H, Sq)`` fp32
    (0 on rows with no unmasked key). Launches the kernel or raises."""
    check_args(q, k, v)
    _check_kernel(q, k, block_q, block_k)
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    q, k, v = aligned(q), aligned(k), aligned(v)
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None)
    stream = torch.cuda.current_stream().cuda_stream
    global launches, sm90_launches
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            err = LIBRARY_SM90.lib().flash_attention_fwd_sm90(
                *ptrs, B, Sq, Sk, H, KV, Dh, block_q, block_k, int(causal),
                Dh ** -0.5, stream)
        else:
            err = LIBRARY.lib().flash_attention_fwd(
                *ptrs, _DTYPES[q.dtype], B, Sq, Sk, H, KV, Dh, block_q,
                block_k, int(causal), int(hoist_scale), Dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"block_q={block_q}, block_k={block_k})")
    if q.dtype == torch.bfloat16:
        sm90_launches += 1
    else:
        launches += 1
    return (out, lse) if return_lse else out


def dq_kernel(q, k, v, dout, lse, delta, causal, hoist_scale):
    """dq ``(B, Sq, H, Dh)`` in q's dtype from aligned CUDA operands."""
    _check_device(q)
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    global dq_launches, dq_sm90_launches
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            err = LIBRARY_DQ_SM90.lib().flash_attention_bwd_dq_sm90(
                *ptrs, B, Sq, Sk, H, KV, Dh, int(causal), Dh ** -0.5, stream)
        else:
            err = LIBRARY_BWD.lib().flash_attention_bwd_dq(
                *ptrs, _DTYPES[q.dtype], B, Sq, Sk, H, KV, Dh, int(causal),
                int(hoist_scale), Dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dq launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)})")
    if q.dtype == torch.bfloat16:
        dq_sm90_launches += 1
    else:
        dq_launches += 1
    return dq


def dkv_kernel(q, k, v, dout, lse, delta, causal, hoist_scale):
    """Per-q-head dk and dv ``(B, Sk, H, Dh)`` in q's dtype from aligned
    CUDA operands."""
    _check_device(q)
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    dkh = torch.empty((B, Sk, H, Dh), dtype=q.dtype, device=q.device)
    dvh = torch.empty_like(dkh)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dkh.data_ptr(), dvh.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    global dkv_launches, dkv_sm90_launches
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            err = LIBRARY_DKV_SM90.lib().flash_attention_bwd_dkv_sm90(
                *ptrs, B, Sq, Sk, H, k.shape[2], Dh, int(causal),
                Dh ** -0.5, stream)
        else:
            err = LIBRARY_BWD.lib().flash_attention_bwd_dkv(
                *ptrs, _DTYPES[q.dtype], B, Sq, Sk, H, k.shape[2], Dh,
                int(causal), int(hoist_scale), Dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)})")
    if q.dtype == torch.bfloat16:
        dkv_sm90_launches += 1
    else:
        dkv_launches += 1
    return dkh, dvh


def flash_attention_bwd(q, k, v, dout, out, lse, *, causal: bool = True,
                        block_q: int, block_k: int,
                        hoist_scale: bool = False):
    """Gradients ``(dq, dk, dv)`` of the flash forward on CUDA tensors, in
    the dtypes of q, k, v: ``delta`` in fp32, the dQ and dK/dV kernels,
    the GQA group sum. ``out`` and ``lse`` are the forward's; the block
    sizes are the forward's schedule (checked; the backward's tiles are
    fixed)."""
    check_args(q, k, v)
    _check_kernel(q, k, block_q, block_k)
    KV = k.shape[2]
    delta = _ref.row_delta(dout, out)
    q, k, v, dout = (aligned(x) for x in (q, k, v, dout))
    lse = lse.contiguous()
    dq = dq_kernel(q, k, v, dout, lse, delta, causal, hoist_scale)
    dkh, dvh = dkv_kernel(q, k, v, dout, lse, delta, causal, hoist_scale)
    return (dq, _ref.group_sum(dkh, KV).to(k.dtype),
            _ref.group_sum(dvh, KV).to(v.dtype))
