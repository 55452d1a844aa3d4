"""Wrappers, build and launch counters of the CUDA dense flash attention
kernels, the ports of the TPU kernels in
``src/repro/kernels/flash_attention.py`` (the GP-FLASH baseline):

* ``csrc/flash_attention_fwd.cu``: ``_flash_kernel``, the forward with
  the online softmax, the optional causal mask, GQA, ragged ``Sq``/``Sk``
  and the ``hoist_scale`` rewrite, at the schedule's ``block_q`` /
  ``block_k``;
* ``csrc/flash_attention_bwd.cu``: ``_flash_dq_kernel`` and
  ``_flash_dkv_kernel``, the recomputation backward (per-q-head dK/dV;
  the GQA sum and ``delta = rowsum(dO * O)`` are plain PyTorch around the
  launches, as the reference's jnp epilogue and prologue).

The kernels are compiled at first use (``kernels/build.py``: nvcc for
``sm_90a``, a plain C entry point, ``ctypes``). The wrappers take CUDA
tensors only: they launch a kernel or raise. ``kernels/ops.py`` sends
CPU tensors to the plain versions (``kernels/ref.py``).
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
# shared memory one block may have on sm_90 (the card's opt-in limit)
SMEM_LIMIT = 232448

launches = 0      # forward launches since the last reset_count()
dq_launches = 0   # dQ launches
dkv_launches = 0  # dK/dV launches


def reset_count() -> None:
    global launches, dq_launches, dkv_launches
    launches = dq_launches = dkv_launches = 0


def _bind(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = (
        [vp] * 5 + [i32] * 11 + [ctypes.c_float, vp])
    lib.flash_attention_fwd.restype = i32


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


def fwd_smem_bytes(d_head: int, block_q: int, block_k: int) -> int:
    """Shared memory of one forward CTA: the q tiles, a k and a v stage
    (fp32 rows padded by 4) and the 64 x 68 probability tile."""
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
                f"tiles in registers: block_q in {BLOCK_QS})")
    if block_k <= 0 or block_k % TILE:
        return (f"block_k={block_k} (k/v stages are whole {TILE}-row "
                f"chunks)")
    smem = fwd_smem_bytes(d_head, block_q, block_k)
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


def _check_kernel(q, k, block_q, block_k):
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"flash_attention has no kernel for device {q.device}")
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
    lib = LIBRARY.lib()
    q, k, v = aligned(q), aligned(k), aligned(v)
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    global launches
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None, _DTYPES[q.dtype],
            B, Sq, Sk, H, KV, Dh, block_q, block_k, int(causal),
            int(hoist_scale), Dh ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"block_q={block_q}, block_k={block_k})")
    launches += 1
    return (out, lse) if return_lse else out


def dq_kernel(q, k, v, dout, lse, delta, causal, hoist_scale):
    """dq ``(B, Sq, H, Dh)`` in q's dtype from aligned CUDA operands."""
    B, Sq, H, Dh = q.shape
    lib = LIBRARY_BWD.lib()
    dq = torch.empty_like(q)
    global dq_launches
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _DTYPES[q.dtype], B, Sq, k.shape[1], H, k.shape[2], Dh,
            int(causal), int(hoist_scale), Dh ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dq launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)})")
    dq_launches += 1
    return dq


def dkv_kernel(q, k, v, dout, lse, delta, causal, hoist_scale):
    """Per-q-head dk and dv ``(B, Sk, H, Dh)`` in q's dtype from aligned
    CUDA operands."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    lib = LIBRARY_BWD.lib()
    dkh = torch.empty((B, Sk, H, Dh), dtype=q.dtype, device=q.device)
    dvh = torch.empty_like(dkh)
    global dkv_launches
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dkh.data_ptr(),
            dvh.data_ptr(), _DTYPES[q.dtype], B, Sq, Sk, H, k.shape[2], Dh,
            int(causal), int(hoist_scale), Dh ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)})")
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
