"""Pipeline parallelism, the GPipe schedule: the port of
``repro.parallel.pipeline`` on a ``torch.distributed`` group of
``n_stages`` ranks, one stage a rank.

``pipeline_apply(stage_fn, stage_params, microbatches, group)`` runs
``n_micro + n_stages - 1`` ticks, as the reference's scan does: at tick
t stage 0 takes microbatch ``min(t, n_micro - 1)`` and every other stage
what the previous stage sent it at tick t - 1 (zeros when nothing was
sent, as ``ppermute`` gives); the last stage keeps its output of tick t
as microbatch ``t - n_stages + 1``; the outputs reach every rank.

Each rank holds only its own stage's parameters. The activations move
stage to stage through an all-to-all of equal chunks whose only
non-zero chunk goes to the next stage (``collectives.all_to_all``,
counted under ``"pipeline"``). Differentiable in the stage's parameters
and the microbatches: the backward runs the ticks in reverse, each
recomputing its stage's forward and sending the gradient of its input
to the previous stage, so every rank makes the same collective calls in
the same order. The outputs are replicated: the gradients are those of
one loss of them (every rank computing it, the last stage's cotangent
is the one taken), and the microbatches' gradient is summed over the
ranks, as the transpose of the reference's replicated input is.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel import collectives as C


def _shift(y, group, step: int):
    """What rank ``r - step`` of ``group`` sends, received by rank ``r``
    (zeros where that rank does not exist), each rank sending ``y``."""
    p, r = C.size(group), C.rank(group)
    parts = torch.zeros((p, *y.shape), dtype=y.dtype, device=y.device)
    if 0 <= r + step < p:
        parts[r + step] = y
    got = C.all_to_all(parts, group, kind="pipeline")
    if 0 <= r - step < p:
        return got[r - step]
    return torch.zeros_like(y)


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, group, stage_fn, mbs, *params):
        p, s = C.size(group), C.rank(group)
        n_micro = mbs.shape[0]
        ctx.group, ctx.stage_fn = group, stage_fn
        ctx.save_for_backward(mbs, *params)
        buf = torch.zeros_like(mbs[0])
        outs = torch.zeros_like(mbs)
        xs = []
        for t in range(n_micro + p - 1):
            x = mbs[min(t, n_micro - 1)] if s == 0 else buf
            xs.append(x)
            y = stage_fn(params, x)
            if s == p - 1 and t >= p - 1:
                outs[t - (p - 1)] = y
            buf = _shift(y, group, 1)
        ctx.xs = xs
        last = p - 1 if group is None else dist.get_global_rank(group, p - 1)
        return C.broadcast_(outs, last, group)

    @staticmethod
    def backward(ctx, g_outs):
        group, stage_fn = ctx.group, ctx.stage_fn
        mbs, *params = ctx.saved_tensors
        p, s = C.size(group), C.rank(group)
        n_micro = mbs.shape[0]
        g_mbs = torch.zeros_like(mbs)
        g_params = [torch.zeros_like(w) for w in params]
        g_y = torch.zeros_like(mbs[0])   # from the next stage's input
        for t in reversed(range(n_micro + p - 1)):
            if s == p - 1 and t >= p - 1:
                g_y = g_y + g_outs[t - (p - 1)]
            x = ctx.xs[t].detach().requires_grad_()
            leaves = [w.detach().requires_grad_() for w in params]
            with torch.enable_grad():
                y = stage_fn(tuple(leaves), x)
                got = torch.autograd.grad(y, [x, *leaves], g_y,
                                          allow_unused=True)
            for acc, g in zip(g_params, got[1:]):
                if g is not None:
                    acc += g
            if s == 0:
                g_mbs[min(t, n_micro - 1)] += got[0]
            g_y = _shift(got[0], group, -1)
        C.all_reduce_(g_mbs, group)
        return (None, None, g_mbs, *g_params)


def pipeline_apply(stage_fn, stage_params, microbatches, group):
    """``microbatches`` (n_micro, mb, ...), the same on every rank,
    through the ``C.size(group)`` stages: ``stage_fn(stage_params, x)``
    on each rank with its own stage's parameters (a sequence of tensors,
    which ``stage_fn`` must read from its argument: the backward calls it
    on detached copies), x and the result of one shape. Returns the last
    stage's outputs (n_micro, mb, ...) on every rank."""
    return _Pipeline.apply(group, stage_fn, microbatches,
                           *tuple(stage_params))
