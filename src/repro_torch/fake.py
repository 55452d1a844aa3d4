"""Fake tensors: the shapes of a program without its memory or its
launches.

The fit-and-roofline sweep (``launch/dryrun.py``) traces one rank's step
of a model at full width under ``torch._subclasses.FakeTensorMode``:
every tensor is a ``FakeTensor`` with a shape, a dtype and a device and
no storage, and no kernel is launched. CUDA fake tensors need no card.

The port's code asks :func:`active` (is a fake mode on the dispatch
stack?) or :func:`is_fake` (is this tensor fake?) where a real run would
read values on the host or draw numbers: ``device.resolve`` lets a CUDA
device through without a card inside a fake mode,
``layers.seeded_init`` skips its draw, the MoE counts its routes without
a data-dependent shape, and the cluster kernels' launches
(:func:`launch_op`) give their outputs' shapes from their fake
implementations. Real tensors never take these branches.
"""

from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def active() -> bool:
    """Whether a ``FakeTensorMode`` is on the dispatch mode stack."""
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor."""
    return isinstance(t, FakeTensor)


def mode() -> FakeTensorMode:
    """A fresh fake mode that takes the real tensors a trace meets (a
    layout built on the host, a constant) as constants."""
    return FakeTensorMode(allow_non_fake_inputs=True)



def launch_op(qualname: str):
    """Decorator: the kernel launch ``fn`` registered as the custom op
    ``qualname`` (its ``register_fake`` gives a fake trace the launch's
    outputs). The op, and the dispatcher with it, is called only where a
    dispatch mode can see it (one on the stack: a fake trace, a
    ``FlopCounterMode``, ``launch/dryrun.StepTrace``) or on a fake
    tensor; elsewhere the launch is ``fn`` itself, called directly."""
    def wrap(fn):
        op = torch.library.custom_op(qualname, fn, mutates_args=())

        @functools.wraps(fn)
        def launch(*args):
            if torch._C._len_torch_dispatch_stack() or is_fake(args[0]):
                return op(*args)
            return fn(*args)

        launch.op = op
        launch.register_fake = op.register_fake
        return launch
    return wrap
