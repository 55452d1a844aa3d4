"""Kernel dispatch: one call site per op, the implementation picked by the
device of the tensors.

The port's counterpart of ``repro.kernels.ops.cluster_attention``, with
one rule instead of the reference's modes and fallbacks:

* a CUDA tensor launches the hand-written kernel, or raises on a call
  the kernel does not take;
* a CPU tensor takes the plain PyTorch version (``kernels/ref.py``);
* ``impl="plain"`` forces the plain version on any device. It exists for
  ``chip_smoke.py``, which holds the kernel against it on the card.

There is no environment knob and no warn-and-fall-back: on the card a
fallback would hide the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cluster_attention as _ca
from repro_torch.kernels import ref as _ref

IMPLS = (None, "plain")


def cluster_attention(q, k, v, block_idx, buckets=None, bias_table=None, *,
                      causal: bool = False, return_lse: bool = False,
                      impl: str | None = None):
    """Cluster-sparse attention over a reformation layout. q
    ``(B, S, H, Dh)``, k/v ``(B, S, KV, Dh)``; ``block_idx`` ``(nq, mb)``
    shared by the batch or ``(B, nq, mb)`` per graph; ``buckets`` int8 with
    the matching leading dims plus ``(bq, bk)``; ``bias_table``
    ``(H, n_buckets)`` (zeros when omitted). Block sizes are implied:
    ``bq = S // nq``, ``bk = buckets.shape[-1]``. With ``return_lse`` it
    also returns the per-row logsumexp ``(B*H, S)`` fp32."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if causal and buckets is not None:
        raise ValueError("the bucketed cluster kernel has no causal mask "
                         "(masking lives in the buckets)")
    if buckets is not None and bias_table is None:
        bias_table = torch.zeros((q.shape[2], 1), dtype=torch.float32,
                                 device=q.device)
    plain = impl == "plain" or q.device.type == "cpu"
    if buckets is None and not plain:
        raise NotImplementedError(
            "cluster_attention without buckets needs the unbiased kernel "
            "(_cluster_kernel, row 2 of the kernel table in PERF.md), which "
            "is not ported yet")
    if not plain:
        return _ca.cluster_attention_fwd(q, k, v, block_idx, buckets,
                                         bias_table, return_lse=return_lse)
    if buckets is not None:     # the kernel's shape contract holds here too
        _ca.check_args(q, k, v, block_idx, buckets, bias_table)
    return _ref.cluster_sparse_attention(
        q, k, v, block_idx, buckets, bias_table, causal=causal,
        return_lse=return_lse)
