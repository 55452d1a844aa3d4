"""Timing primitives of the autotuner: CUDA events around each call,
``warmup`` discarded calls, then a trimmed mean (drop the min and max,
mean the rest — robust to one hiccup without hiding a consistent
regression), or for the regression check the fastest call, and the peak
device memory of the timed calls from
``torch.cuda.max_memory_allocated``.

Only CUDA calls are timed: a time of the plain version on the CPU is not
a time of the kernel, so :func:`time_candidate` raises without CUDA.
"""

from __future__ import annotations

import numpy as np
import torch


def time_candidate(fn, *args, device, warmup: int = 2, iters: int = 5,
                   reduce: str = "trimmed"):
    """``(us, peak_bytes)`` of ``fn(*args)`` on the CUDA ``device``: CUDA
    events around each of ``iters`` calls after ``warmup`` discarded
    ones, reduced by their ``trimmed`` mean (the search) or their ``min``
    (the regression check: on a case bound by host-side launch work,
    interference only ever adds time)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"wall-clock timing needs a CUDA device, got "
                           f"{device}: the plain version on the CPU is not "
                           f"the kernel")
    with torch.cuda.device(device):
        for _ in range(warmup):
            fn(*args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ts = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) * 1e3)
        peak = torch.cuda.max_memory_allocated()
    ts.sort()
    if reduce == "min":
        return ts[0], peak
    return float(np.mean(ts[1:-1] if len(ts) > 2 else ts)), peak
