"""Kernel dispatch: one call site per op, the implementation picked by the
device of the tensors.

The port's counterpart of ``repro.kernels.ops.cluster_attention``, with
one rule instead of the reference's modes and fallbacks:

* a CUDA tensor launches the hand-written kernels (the forward, and in
  the backward the dQ and dK/dV kernels; the biased ones with buckets,
  the unbiased ones without), or raises on a call the kernels do not
  take;
* a CPU tensor takes the plain PyTorch versions (``kernels/ref.py``);
* ``impl="plain"`` forces the plain versions on any device. It exists
  for ``chip_smoke.py``, which holds the kernels against them on the
  card.

There is no environment knob and no warn-and-fall-back: on the card a
fallback would hide the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cluster_attention as _ca
from repro_torch.kernels import cluster_attention_bwd as _cab
from repro_torch.kernels import ref as _ref

IMPLS = (None, "plain")


class _ClusterAttention(torch.autograd.Function):
    """Cluster-sparse attention with the recomputation backward, biased
    (buckets and a bias table) or unbiased (neither, optionally causal):
    saves q, k, v, O and the logsumexp; the layout arrays get no gradient,
    and without a table there is no bias gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias_table, block_idx, buckets, block_idx_t,
                causal, plain):
        fwd = _ref.cluster_sparse_attention if plain \
            else _ca.cluster_attention_fwd
        out, lse = fwd(q, k, v, block_idx, buckets, bias_table,
                       causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, bias_table, block_idx, buckets,
                              block_idx_t, out, lse)
        ctx.causal, ctx.plain = causal, plain
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, bias_table, block_idx, buckets, block_idx_t, out, lse = \
            ctx.saved_tensors
        bwd = _ref.cluster_attention_bwd if ctx.plain \
            else _cab.cluster_attention_bwd
        dq, dk, dv, dbias = bwd(q, k, v, dout.contiguous(), out, lse,
                                block_idx, buckets, bias_table, block_idx_t,
                                causal=ctx.causal)
        return dq, dk, dv, dbias, None, None, None, None, None


def cluster_attention(q, k, v, block_idx, buckets=None, bias_table=None,
                      block_idx_t=None, *, causal: bool = False,
                      return_lse: bool = False, impl: str | None = None):
    """Cluster-sparse attention over a reformation layout. q
    ``(B, S, H, Dh)``, k/v ``(B, S, KV, Dh)``; ``block_idx`` ``(nq, mb)``
    shared by the batch or ``(B, nq, mb)`` per graph; ``buckets`` int8 with
    the matching leading dims plus ``(bq, bk)``; ``bias_table``
    ``(H, n_buckets)`` (zeros when omitted with buckets). Block sizes are
    implied: ``bq = S // nq``, ``bk = buckets.shape[-1]``, or ``bk = bq``
    without buckets. Without buckets the op is unbiased and ``causal``
    masks positionally (``qpos < kpos``), the token LM's local+global
    form; with buckets the masking lives in them. With ``return_lse`` it
    also returns the per-row logsumexp ``(B*H, S)`` fp32.

    Differentiable in q, k, v and ``bias_table``. ``block_idx_t`` is the
    transposed layout ``(nk, mt, 2)`` / ``(B, nk, mt, 2)`` the dK/dV
    backward walks (derived at the dense bound ``mt = nq`` when
    omitted); the forward never reads it."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if causal and buckets is not None:
        raise ValueError("the bucketed cluster kernel has no causal mask "
                         "(masking lives in the buckets)")
    if buckets is not None and bias_table is None:
        bias_table = torch.zeros((q.shape[2], 1), dtype=torch.float32,
                                 device=q.device)
    plain = impl == "plain" or q.device.type == "cpu"
    # the kernels' shape contract holds on every device
    _ca.check_args(q, k, v, block_idx, buckets, bias_table)
    if block_idx_t is not None:
        _cab.check_block_idx_t(q, block_idx, buckets, block_idx_t)
    grad = torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in (q, k, v, bias_table))
    if not grad:
        fwd = _ref.cluster_sparse_attention if plain \
            else _ca.cluster_attention_fwd
        return fwd(q, k, v, block_idx, buckets, bias_table, causal=causal,
                   return_lse=return_lse)
    out, lse = _ClusterAttention.apply(q, k, v, bias_table, block_idx,
                                       buckets, block_idx_t, causal, plain)
    return (out, lse) if return_lse else out
