"""Device resolution shared by the port's entry points.

Entry points default to ``device="cuda"``. Asking for CUDA where there is
none raises: nothing falls back to the CPU on its own. Inside a fake
mode (``repro_torch.fake``) a CUDA device needs no card: its tensors are
fake, nothing is allocated on it and nothing launched.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA, no CUDA
    device is available and no fake mode is active."""
    from repro_torch import fake

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available() \
            and not fake.active():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' explicitly to run on the CPU")
    return dev
