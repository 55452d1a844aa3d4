"""Wrapper, build and launch counter of the CUDA cluster-sparse attention
forward (``csrc/cluster_attention_fwd.cu``), the port of the TPU kernel
``_cluster_kernel_biased`` (``src/repro/kernels/cluster_attention.py``).

The kernel is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point, loaded with ``ctypes``. The
build lands in ``_build/<key>/`` next to this file, keyed on a hash of
the source and the flags, so a fresh checkout builds it once.

The wrapper takes CUDA tensors only: it launches the kernel or raises.
``kernels/ops.py`` sends CPU tensors to the plain version
(``kernels/ref.py``). Build and launch errors propagate: nothing falls
back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "cluster_attention_fwd.cu"
BUILD_ROOT = _HERE / "_build"
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0          # kernel launches since the last reset_count()
_lib = None
build_log = ""        # nvcc's output of the build this process loaded
build_seconds = 0.0   # 0.0 when the library was already on disk


def reset_count() -> None:
    global launches
    launches = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = pathlib.Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and on PATH)")
    return found


def build() -> pathlib.Path:
    """Compile the kernel library if it is not already built; returns its
    path. Raises with nvcc's output if compilation fails."""
    global build_log, build_seconds
    nvcc = _nvcc()
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        [nvcc] + NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / key
    lib = out_dir / "libcluster_attention_fwd.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".tmp-{os.getpid()}.so"
    t0 = time.perf_counter()
    r = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{build_log}")
    os.replace(tmp, lib)
    return lib


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.cluster_attention_fwd.argtypes = (
            [vp] * 8 + [i32] * 12 + [ctypes.c_float, vp])
        lib.cluster_attention_fwd.restype = i32
        _lib = lib
    return _lib


def check_args(q, k, v, block_idx, buckets, bias_table):
    """Raise unless the arguments meet the op's dtype, device and shape
    contract (``kernels/ref.py``)."""
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
    nq, mb = block_idx.shape[-2:]
    if S % nq:
        raise ValueError(f"sequence {S} is not tiled by {nq} q-block rows")
    bq = S // nq
    want = tuple(block_idx.shape) + (bq, buckets.shape[-1])
    if buckets.dtype != torch.int8 or tuple(buckets.shape) != want:
        raise ValueError(f"buckets must be int8 {tuple(block_idx.shape)} + "
                         f"({bq}, bk), got {buckets.dtype} "
                         f"{tuple(buckets.shape)}")
    if S % buckets.shape[-1]:
        raise ValueError(f"sequence {S} is not tiled by k-blocks of "
                         f"{buckets.shape[-1]}")
    if bias_table.dim() != 2 or bias_table.shape[0] != H:
        raise ValueError(f"bias_table must be (H={H}, n_buckets), got "
                         f"{tuple(bias_table.shape)}")
    for name, x in (("block_idx", block_idx), ("buckets", buckets),
                    ("bias_table", bias_table)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def cluster_attention_fwd(q, k, v, block_idx, buckets, bias_table, *,
                          return_lse: bool = False):
    """Biased cluster-sparse attention forward on CUDA tensors (shape
    contract in ``kernels/ref.py``): launches the kernel, or raises.
    ``block_idx`` entries are -1 or k-block ids below ``S // bk``, as the
    layout builders emit them; the kernel reads whatever block an entry
    names, so the values are the caller's contract (checking them would
    cost a device sync per call)."""
    check_args(q, k, v, block_idx, buckets, bias_table)
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"cluster_attention has no kernel for device {q.device}")
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    nq, mb = block_idx.shape[-2:]
    bq, bk = S // nq, buckets.shape[-1]
    nb = bias_table.shape[1]
    lib = _library()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    block_idx, buckets = block_idx.contiguous(), buckets.contiguous()
    bias = bias_table.float().contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    global launches
    with torch.cuda.device(q.device):
        err = lib.cluster_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), block_idx.data_ptr(),
            buckets.data_ptr(), bias.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None, _DTYPES[q.dtype],
            B, S, H, KV, Dh, nq, mb, bq, bk, nb, int(block_idx.dim() == 3),
            Dh ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        # e.g. 1 (invalid value): the tiles of bq, bk, Dh and n_buckets
        # need more shared memory than one block may have on this card
        raise RuntimeError(f"cluster_attention_fwd launch failed: CUDA "
                           f"error {err} (bq={bq}, bk={bk}, Dh={Dh}, "
                           f"n_buckets={nb})")
    launches += 1
    return (out, lse) if return_lse else out
