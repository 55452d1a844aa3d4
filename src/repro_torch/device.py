"""Device resolution shared by the port's entry points.

Entry points default to ``device="cuda"``. Asking for CUDA where there is
none raises: nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' explicitly to run on the CPU")
    return dev
