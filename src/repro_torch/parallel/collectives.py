"""The collectives of the port's sequence and data parallelism, on
``torch.distributed``, each one differentiable where the model needs it.

Everything is written on three calls that mean the same in every torch
version the port runs on: ``dist.all_to_all_single`` (equal splits),
``dist.all_reduce`` and ``dist.broadcast``; the port makes no
point-to-point call. The all-gather and the reduce-scatter
(``GatherSeq``, ``ScatterSeq``: ``seqpar_attention``, the MoE's expert
parallelism, the Mamba2 mixer on a sequence shard) are all-to-alls too: an all-gather is an all-to-all of the
local chunk repeated P times, a reduce-scatter an all-to-all of the P
chunks summed on arrival. The pipeline's stage-to-stage shift
(``parallel/pipeline.py``) is an all-to-all whose one non-zero chunk
goes to the next stage.

Gloo and CUDA tensors: gloo takes CUDA tensors for all three calls
(``tools/gloo_cuda_probe.py``: torch 2.11 with CUDA 12.8 on an H100, two
ranks on one card, none refused) and moves their bytes through the host
itself, so the wrappers hand them over as they are and nothing stages
them explicitly. NCCL takes CUDA tensors too, and needs a card for each
rank.

``BYTES`` counts the payload a rank hands to each kind of call (bytes of
its local operand, the reference's unit): the all-to-alls apart from
the all-gathers, reduce-scatters and pipeline shifts built on them
(``cluster_parallel`` holds the all-to-all bytes of a sharded attention
call to ``cluster_a2a_budget``), and the all-reduces
(``optim/compress.py`` reads the bytes its reductions send).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

BYTES = {"all_to_all": 0, "all_gather": 0, "reduce_scatter": 0,
         "pipeline": 0, "all_reduce": 0}


def reset_bytes() -> None:
    for k in BYTES:
        BYTES[k] = 0


def control_device(group=None) -> torch.device:
    """Where a small control tensor (a flag, a timing) lives for a
    collective on ``group``: the current card for NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def size(group) -> int:
    return dist.get_world_size(group)


def rank(group) -> int:
    return dist.get_rank(group)


def all_to_all(x: torch.Tensor, group, *,
               kind: str = "all_to_all") -> torch.Tensor:
    """``x`` (P, ...): chunk ``j`` goes to rank ``j``; returns (P, ...)
    whose chunk ``j`` came from rank ``j``; its bytes count under
    ``kind``. Not differentiable (see :class:`AllToAll`)."""
    x = x.contiguous()
    BYTES[kind] += x.numel() * x.element_size()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM):
    """In-place all-reduce of ``t``; returns ``t``."""
    BYTES["all_reduce"] += t.numel() * t.element_size()
    dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None):
    """In-place broadcast of ``t`` from global rank ``src``."""
    dist.broadcast(t, src, group=group)
    return t


class AllToAll(torch.autograd.Function):
    """:func:`all_to_all` with autograd. An all-to-all of equal chunks is
    its own adjoint: the backward is the same all-to-all of the
    gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


class SumAcross(torch.autograd.Function):
    """The sum of ``x`` over ``group`` in the forward; the identity in the
    backward. For a loss's numerator and count: every rank holds the
    global sum, and each backpropagates only its own share of it, so the
    gradients summed over the group are the global loss's."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class AllReduce(torch.autograd.Function):
    """The sum of ``x`` over ``group`` in the forward and of the gradient
    in the backward (the reference's ``psum``). For a partial sum that
    every rank goes on to use in its own part of the computation, such
    as the Mamba2 mixer's gated-norm sum of squares over its channels:
    the loss depends on the total through every rank's part, so each
    rank's gradient of it is the sum over the ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class GatherSeq(torch.autograd.Function):
    """All-gather of ``x`` (B, S/P, ...) along dim 1 into (B, S, ...), the
    ranks' shards in rank order; the backward is the reduce-scatter of
    the gradient (each rank gets the sum over the ranks of its shard's
    rows)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_seq(x, group, "all_gather")

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_seq(g, ctx.group, "all_gather"), None


def _gather_seq(x, group, kind):
    p = size(group)
    rep = x.unsqueeze(0).expand(p, *x.shape)
    got = all_to_all(rep, group, kind=kind)           # (P, B, S/P, ...)
    return got.movedim(0, 1).flatten(1, 2)


def _reduce_scatter_seq(x, group, kind):
    p = size(group)
    B, S = x.shape[:2]
    if S % p:
        raise ValueError(f"a sequence of {S} does not split {p} ways")
    parts = x.reshape(B, p, S // p, *x.shape[2:]).movedim(1, 0)
    return all_to_all(parts, group, kind=kind).sum(0)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather of ``x`` (n, ...) along dim 0 into (P n, ...), the ranks'
    rows in rank order (no autograd): the whole of a tensor each rank of
    ``group`` holds a part of."""
    return _gather_seq(x.unsqueeze(0), group, "all_gather")[0]


class ScatterSeq(torch.autograd.Function):
    """The dual of :class:`GatherSeq`: reduce-scatter of ``x`` (B, S, ...)
    along dim 1, rank i getting (B, S/P, ...), the sum over the ranks of
    their rows of its shard; the backward is the all-gather of the
    gradient. Each rank holds a partial sum of the whole sequence (the
    MoE's experts on this rank) and keeps its shard of the total."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter_seq(x, group, "reduce_scatter")

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.group, "reduce_scatter"), None
