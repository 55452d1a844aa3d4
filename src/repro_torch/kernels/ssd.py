"""Wrapper, build and launch counter of the CUDA Mamba2 SSD chunked scan
``csrc/ssd.cu``, the port of the TPU kernel ``_ssd_kernel``
(``src/repro/kernels/ssd.py``): chunk-parallel, as ``ssd_chunked`` is (C
B^T per chunk once for all heads, the chunk states, a short scan over
the chunks, y), bf16 on the tensor cores and fp32 on CUDA cores. Forward
only: the reference has no SSD backward kernel either.

The kernel is compiled at first use (``kernels/build.py``). The wrapper
takes CUDA tensors only: it launches the kernel or raises.
``kernels/ops.py`` sends CPU tensors to the plain version
(``models/ssm.ssd_chunked``).
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.flash_attention import torch_dtype

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D_HEAD = 64      # y's 64 x 64 output tile holds dh columns
MAX_CHUNK = 1024     # the prefix sum takes 8 positions a thread
TILE = 64            # rows, columns and depth of a staged operand tile
SMEM_LIMIT = 232448  # shared memory one block may have on sm_90

launches = 0  # kernel launches since the last reset_count()


def reset_count() -> None:
    global launches
    launches = 0


def _bind(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_fwd.argtypes = [vp] * 10 + [i32] * 7 + [vp]
    lib.ssd_fwd.restype = i32


LIBRARY = CudaLibrary(pathlib.Path(__file__).resolve().parent / "csrc" /
                      "ssd.cu", _bind)


def smem_bytes(chunk: int) -> int:
    """Shared memory of one CTA of the SSD kernels, at most (fp32): two
    64 x 64 operand tiles (rows padded to 68 floats; bf16 takes three of
    72 halves, 27648 bytes, less), the chunk's prefix sums and dt or
    weights, and 4 floats of scratch. The tiles stream N, dh and the
    chunk 64 at a time, so only the chunk adds to it."""
    return 2 * TILE * 68 * 4 + 4 * (2 * chunk + 4)


# every chunk the kernels take fits in a block's shared memory
assert smem_bytes(MAX_CHUNK) <= SMEM_LIMIT


def check_launch(d_head: int, n_state: int, chunk: int, dtype) -> str | None:
    """Why the SSD kernels do not take ``(d_head, n_state, chunk, dtype)``
    (``chunk`` as the kernels see it: ``min(chunk, S)``; ``dtype`` a torch
    dtype or its name), or None when they do. Any ``n_state`` goes: the
    kernels stream it in tiles."""
    if torch_dtype(dtype) not in _DTYPES:
        return f"dtype {dtype} (the kernel takes float32 and bfloat16)"
    if not 0 < d_head <= MAX_D_HEAD:
        return f"dh={d_head} (the kernel takes dh <= {MAX_D_HEAD})"
    if not 0 < chunk <= MAX_CHUNK:
        return f"chunk={chunk} (the kernel takes chunks <= {MAX_CHUNK})"
    return None


def check_args(x, dt, a, b, c, chunk: int) -> int:
    """Raise unless the arguments meet the op's contract (x ``(B, S, H,
    dh)``, dt ``(B, S, H)``, a ``(H,)``, b/c ``(B, S, N)``, one device, a
    chunk that tiles S); returns the chunk length ``min(chunk, S)``."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, dh), got {tuple(x.shape)}")
    B, S, H, _ = x.shape
    if tuple(dt.shape) != (B, S, H) or tuple(a.shape) != (H,):
        raise ValueError(f"dt must be {(B, S, H)} and a {(H,)}, got "
                         f"{tuple(dt.shape)} and {tuple(a.shape)}")
    if b.dim() != 3 or tuple(b.shape[:2]) != (B, S) or b.shape != c.shape:
        raise ValueError(f"b and c must be (B, S, N) = ({B}, {S}, N), got "
                         f"{tuple(b.shape)} and {tuple(c.shape)}")
    for name, t in (("dt", dt), ("a", a), ("b", b), ("c", c)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    Q = min(int(chunk), S)
    if Q <= 0 or S % Q:
        raise ValueError(f"sequence {S} is not tiled by chunk {Q}")
    return Q


def ssd_fwd(x, dt, a, b, c, *, chunk: int):
    """The SSD scan on CUDA tensors: y ``(B, S, H, dh)`` in x's dtype and
    the final state ``(B, H, dh, N)`` fp32. x, b and c share a dtype
    (float32 or bfloat16); dt and a are fp32. Launches the kernel or
    raises."""
    Q = check_args(x, dt, a, b, c, chunk)
    if x.device.type != "cuda":
        raise NotImplementedError(f"ssd has no kernel for device {x.device}")
    B, S, H, dh = x.shape
    N = b.shape[-1]
    reason = check_launch(dh, N, Q, x.dtype)
    if reason is None and (b.dtype != x.dtype or c.dtype != x.dtype):
        reason = f"b/c dtypes {b.dtype}/{c.dtype} (they must be x's)"
    if reason is None and (dt.dtype != torch.float32
                           or a.dtype != torch.float32):
        reason = f"dt/a dtypes {dt.dtype}/{a.dtype} (they must be float32)"
    if reason is not None:
        raise NotImplementedError(
            f"the SSD kernel does not take {reason}; x {tuple(x.shape)}, b "
            f"{tuple(b.shape)}, chunk {Q}")
    lib = LIBRARY.lib()
    x, dt, a, b, c = (t.contiguous() for t in (x, dt, a, b, c))
    y = torch.empty_like(x)
    state = torch.empty((B, H, dh, N), dtype=torch.float32, device=x.device)
    # fp32 scratch: C B^T per chunk, the chunk states (scanned in place
    # into the state before each chunk), exp(total) per chunk and head
    nc = S // Q
    f32 = {"dtype": torch.float32, "device": x.device}
    cb = torch.empty((B, nc, Q, Q), **f32)
    st = torch.empty((B, nc, H, N, dh), **f32)
    decay = torch.empty((B, nc, H), **f32)
    global launches
    with torch.cuda.device(x.device):
        err = lib.ssd_fwd(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                          b.data_ptr(), c.data_ptr(), y.data_ptr(),
                          state.data_ptr(), cb.data_ptr(), st.data_ptr(),
                          decay.data_ptr(), _DTYPES[x.dtype], B, S, H, dh, N,
                          Q, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_fwd launch failed: CUDA error {err} (x "
                           f"{tuple(x.shape)}, b {tuple(b.shape)}, chunk "
                           f"{Q})")
    launches += 1
    return y, state
