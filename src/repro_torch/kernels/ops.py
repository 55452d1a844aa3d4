"""Kernel dispatch: one call site per op, the implementation picked by the
device of the tensors.

The port's counterpart of ``repro.kernels.ops`` (``cluster_attention``,
``flash_attention``, ``ssd``, ``paged_attention``), with one rule instead
of the reference's modes and fallbacks:

* a CUDA tensor launches the hand-written kernels (the forward, and in
  the backward the dQ and dK/dV kernels; for the cluster op the biased
  ones with buckets, the unbiased ones without), or raises on a call the
  kernels do not take;
* a CPU tensor takes the plain PyTorch versions (``kernels/ref.py``);
* ``impl="plain"`` forces the plain versions on any device. It exists
  for ``chip_smoke.py``, which holds the kernels against them on the
  card.

There is no environment knob and no warn-and-fall-back: on the card a
fallback would hide the kernel. ``paged_attention`` is the exception the
reference makes too: it has no kernel, so its plain version runs on every
device.

The cluster op's rewrites (``hoist_scale``, ``fuse_bias``) and row
chunking, the flash block sizes and ``hoist_scale``, and the SSD chunk
come from the autotuner's winner table (:func:`resolve_schedule`,
``repro_torch.tune.runtime``), or from ``DEFAULT_SCHEDULES`` without
one. A table gated on the CPU is stale for CUDA tensors: no entry that
was not gated on the kernels reaches them. The launch checks of the
flash and SSD kernels are re-exported here for the tuner's enumerator,
which reaches the kernels through this module only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cluster_attention as _ca
from repro_torch.kernels import cluster_attention_bwd as _cab
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd as _ssd
from repro_torch.tune import runtime as _tune_rt
from repro_torch.tune.schedule import DEFAULT_SCHEDULES, shape_bucket

IMPLS = (None, "plain")

# what the flash and SSD kernels take, for the tuner's enumerator
flash_check_launch = _fa.check_launch
ssd_check_launch = _ssd.check_launch
# a fake layout tensor's host array, for the split plan of a fake trace
# and the sweep's count of the live blocks
keep_host_copy = _ca.keep_host_copy
host_layout = _ca.host_layout


def _cluster_fwd(plain, q, k, v, block_idx, buckets, bias_table, causal,
                 return_lse, sched):
    """The forward of ``sched`` = ``(hoist_scale, fuse_bias, row_chunk)``:
    the plain version takes all three, the kernels the two rewrites
    (row chunking is the plain version's, as in the reference)."""
    hoist, fuse, row_chunk = sched
    if plain:
        return _ref.cluster_sparse_attention(
            q, k, v, block_idx, buckets, bias_table, causal=causal,
            return_lse=return_lse, hoist_scale=hoist, fuse_bias=fuse,
            row_chunk=row_chunk)
    return _ca.cluster_attention_fwd(q, k, v, block_idx, buckets, bias_table,
                                     causal=causal, return_lse=return_lse,
                                     hoist_scale=hoist, fuse_bias=fuse)


class _ClusterAttention(torch.autograd.Function):
    """Cluster-sparse attention with the recomputation backward, biased
    (buckets and a bias table) or unbiased (neither, optionally causal):
    saves q, k, v, O and the logsumexp; the layout arrays get no gradient,
    and without a table there is no bias gradient. The backward runs
    under the forward's schedule ``sched``."""

    @staticmethod
    def forward(ctx, q, k, v, bias_table, block_idx, buckets, block_idx_t,
                causal, plain, sched):
        out, lse = _cluster_fwd(plain, q, k, v, block_idx, buckets,
                                bias_table, causal, True, sched)
        ctx.save_for_backward(q, k, v, bias_table, block_idx, buckets,
                              block_idx_t, out, lse)
        ctx.causal, ctx.plain, ctx.sched = causal, plain, sched
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, bias_table, block_idx, buckets, block_idx_t, out, lse = \
            ctx.saved_tensors
        hoist, fuse, row_chunk = ctx.sched
        args = (q, k, v, dout.contiguous(), out, lse, block_idx, buckets,
                bias_table, block_idx_t)
        if ctx.plain:
            grads = _ref.cluster_attention_bwd(
                *args, causal=ctx.causal, hoist_scale=hoist, fuse_bias=fuse,
                row_chunk=row_chunk)
        else:
            grads = _cab.cluster_attention_bwd(
                *args, causal=ctx.causal, hoist_scale=hoist, fuse_bias=fuse)
        return (*grads, None, None, None, None, None, None)


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
    omitted); the forward never reads it.

    The schedule is the winner table's for this shape bucket (memoised,
    :func:`resolve_schedule`), as the reference resolves it:
    ``hoist_scale`` on every path, ``fuse_bias`` where there are buckets,
    and ``row_chunk`` on the plain version, which the kernels do not
    read."""
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
    s = resolve_schedule("cluster_attention", seq_len=q.shape[1],
                         heads=q.shape[2], d_head=q.shape[3], dtype=q.dtype,
                         device_type=q.device.type)
    sched = (s.hoist_scale, s.fuse_bias and buckets is not None,
             _sched_field(s, "row_chunk"))
    grad = torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in (q, k, v, bias_table))
    if not grad:
        return _cluster_fwd(plain, q, k, v, block_idx, buckets, bias_table,
                            causal, return_lse, sched)
    out, lse = _ClusterAttention.apply(q, k, v, bias_table, block_idx,
                                       buckets, block_idx_t, causal, plain,
                                       sched)
    return (out, lse) if return_lse else out


# ------------------------------------------------------------------ paged

def paged_attention(q, k_pool, v_pool, block_tables, cache_len, *,
                    q_offset=None, window: int = 0, n_global: int = 0,
                    mask=None):
    """Paged-KV attention for the serving engine: every decode step and
    chunked-prefill chunk reads the shared physical block pool through a
    per-request block table (shape contract in
    :func:`repro_torch.kernels.ref.paged_attention`). ``window``/
    ``n_global`` apply the TorchGT cluster-sparse decode mask.

    The plain version on every device: the reference has no Pallas kernel
    for the block-table gather (``src/repro/kernels/ops.py:496-518``, where
    ``ref`` serves every mode), so the port owes none."""
    return _ref.paged_attention(q, k_pool, v_pool, block_tables, cache_len,
                                q_offset=q_offset, window=window,
                                n_global=n_global, mask=mask)


# -------------------------------------------------------------- schedules

# (op, shape signature, device type, tune generation) -> Schedule
_SCHED_MEMO: dict = {}


def resolve_schedule(op: str, *, seq_len: int, heads: int | None = None,
                     d_head: int | None = None, dtype="float32",
                     device_type: str = "cpu"):
    """The effective ``Schedule`` for this op and shape: the winner
    table's entry for its bucket, else ``DEFAULT_SCHEDULES`` (a missing,
    stale or corrupt table, a bucket miss, or a CPU-gated table for a
    CUDA call warns once; none raises). Memoized per shape signature,
    device type and tune generation, so a table swap changes what later
    calls resolve."""
    key = (op, int(seq_len), heads, d_head, str(dtype), device_type,
           _tune_rt.generation())
    sched = _SCHED_MEMO.get(key)
    if sched is None:
        if len(_SCHED_MEMO) > 4096:   # stale generations never hit again
            _SCHED_MEMO.clear()
        bucket = shape_bucket(op, seq_len=seq_len, heads=heads,
                              d_head=d_head, dtype=dtype)
        sched = _tune_rt.lookup(op, bucket, device_type=device_type)
        _SCHED_MEMO[key] = sched
    return sched


def _sched_field(sched, name: str):
    """A schedule field with the op default as backstop (a hand-written
    table entry may omit fields)."""
    val = getattr(sched, name)
    return getattr(DEFAULT_SCHEDULES[sched.op], name) if val is None else val


# ------------------------------------------------------------------ flash

class _FlashAttention(torch.autograd.Function):
    """Dense flash attention with the recomputation backward: saves q, k,
    v, O and the logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, hoist, plain):
        fwd = _ref.flash_fwd if plain else _fa.flash_attention_fwd
        out, lse = fwd(q, k, v, causal=causal, block_q=block_q,
                       block_k=block_k, hoist_scale=hoist, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.meta = (causal, block_q, block_k, hoist, plain)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, block_q, block_k, hoist, plain = ctx.meta
        bwd = _ref.flash_bwd if plain else _fa.flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, dout.contiguous(), out, lse, causal=causal,
                         block_q=block_q, block_k=block_k, hoist_scale=hoist)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, block_q=None,
                    block_k=None, impl: str | None = None):
    """Dense flash attention. q ``(B, Sq, H, Dh)``, k/v ``(B, Sk, KV, Dh)``
    (GQA, ragged ``Sq``/``Sk``); returns ``(B, Sq, H, Dh)`` in q's dtype.
    Differentiable in q, k, v.

    ``block_q``/``block_k`` default to the autotuner's answer for this
    shape bucket; passing them overrides the tile sizes while
    ``hoist_scale`` still comes from the resolved schedule. On a CUDA
    tensor they must be a launch the kernels take
    (``flash_attention.check_launch``), or the call raises; the plain
    version on the CPU takes them as its chunk sizes."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    _fa.check_args(q, k, v)
    sched = resolve_schedule("flash_attention", seq_len=q.shape[1],
                             heads=q.shape[2], d_head=q.shape[3],
                             dtype=q.dtype, device_type=q.device.type)
    block_q = _sched_field(sched, "block_q") if block_q is None else block_q
    block_k = _sched_field(sched, "block_k") if block_k is None else block_k
    plain = impl == "plain" or q.device.type == "cpu"
    grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    if not grad:
        fwd = _ref.flash_fwd if plain else _fa.flash_attention_fwd
        return fwd(q, k, v, causal=causal, block_q=block_q, block_k=block_k,
                   hoist_scale=sched.hoist_scale)
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k,
                                 sched.hoist_scale, plain)


# -------------------------------------------------------------------- ssd

def ssd(x, dt, a, b, c, *, chunk=None, impl: str | None = None):
    """Mamba2 SSD chunked scan: x ``(B, S, H, dh)``, dt ``(B, S, H)``, a
    ``(H,)``, b/c ``(B, S, N)``; returns y ``(B, S, H, dh)`` in x's dtype
    and the final state ``(B, H, dh, N)`` fp32. ``chunk`` defaults to the
    autotuner's answer for this shape bucket; a chunk that does not tile
    the sequence raises (the reference falls back).

    The CUDA kernel is forward only, as the reference's: a CUDA call that
    needs a gradient raises. The plain version on the CPU is
    differentiable."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if chunk is None:
        sched = resolve_schedule("ssd", seq_len=x.shape[1], heads=x.shape[2],
                                 d_head=x.shape[3], dtype=x.dtype,
                                 device_type=x.device.type)
        chunk = _sched_field(sched, "chunk")
    Q = _ssd.check_args(x, dt, a, b, c, chunk)
    if impl == "plain" or x.device.type == "cpu":
        return _ref.ssd_ref(x, dt, a, b, c, Q)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b, c)):
        raise NotImplementedError(
            "ssd on CUDA is forward only: the SSD scan has no backward "
            "kernel (neither has the reference's Pallas _ssd_kernel); call "
            "it under torch.no_grad() or on CPU tensors")
    return _ssd.ssd_fwd(x, dt, a, b, c, chunk=Q)
