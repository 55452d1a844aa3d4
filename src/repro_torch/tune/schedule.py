"""Schedule contract of the port's kernel autotuner.

A :class:`Schedule` is everything the dispatch layer may legally vary
about a kernel launch without changing its math: the flash kernels'
``block_q``/``block_k`` (q rows a forward CTA holds, k rows of a k/v
stage), the SSD kernel's ``chunk``, and the dataflow rewrites:

``hoist_scale``
    multiply the softmax scale onto the q tile once, as it is loaded,
    instead of onto every score — the flash and cluster forwards and
    their backward kernels rebuild the same scores (a flag of each fp32
    kernel; the bf16 kernels fold the scale into their fp32 ``exp2``
    argument either way).
``fuse_bias``
    the cluster kernels' sentinel-column bias lookup: the bias table
    grows one ``-1e30`` column onto which the masked bucket -1 lands, so
    ``s + bias`` replaces the clip and the select (biased cluster op
    only).
``row_chunk``
    the q-block rows of one pass of the cluster op's plain version (the
    reference's oracle chunking: the largest divisor of ``nq`` not above
    it); the kernels do not read it.

``Schedule``, ``DEFAULT_SCHEDULES``, ``SCHEDULE_CACHE_VERSION`` and
:func:`shape_bucket` are the reference's (``repro.tune.schedule``), so a
bucket string means the same shape in both packages. Legality is the
port kernels' own: :func:`enumerate_schedules` prunes every candidate the
kernel would refuse (``kernels/flash_attention.check_launch``,
``kernels/ssd.check_launch``, both reached through ``kernels/ops.py``;
a cluster ``fuse_bias`` without buckets, a ``row_chunk`` that does not
divide the layout's q-block rows), with the reason, before it is timed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# bump when the Schedule fields / bucket key format / rewrite semantics
# change: tables recorded under another version are stale and dispatch
# warns + falls back to DEFAULT_SCHEDULES instead of misreading them
SCHEDULE_CACHE_VERSION = 1

_FIELD_DOC = {
    "block_q": "flash q-tile rows",
    "block_k": "flash k-tile cols",
    "chunk": "SSD scan chunk / serve prefill chunk",
    "row_chunk": "cluster oracle q-row chunk",
    "hoist_scale": "scale Q once before the k-loop",
    "fuse_bias": "sentinel-column bias lookup, no where-pair",
}


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One legal launch configuration for one op (unused fields None)."""

    op: str
    block_q: int | None = None
    block_k: int | None = None
    chunk: int | None = None
    row_chunk: int | None = None
    hoist_scale: bool = False
    fuse_bias: bool = False

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Schedule":
        """Tolerant of unknown keys (newer writers) — version skew is
        handled one level up by the table's version field."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def describe(self) -> str:
        parts = [f"{k}={getattr(self, k)}" for k in _FIELD_DOC
                 if getattr(self, k) not in (None, False)]
        return f"{self.op}({', '.join(parts) or 'defaults'})"


# the one home of the block-size constants: kernels take these as
# required arguments, dispatch resolves winner table -> this dict
DEFAULT_SCHEDULES: dict[str, Schedule] = {
    "flash_attention": Schedule("flash_attention", block_q=128, block_k=128),
    "cluster_attention": Schedule("cluster_attention", row_chunk=8),
    "ssd": Schedule("ssd", chunk=256),
    "paged_attention": Schedule("paged_attention", chunk=32),
}


def dtype_name(dtype) -> str:
    """The numpy name of ``dtype`` (a torch dtype, a numpy dtype or a
    name): ``float32``, ``bfloat16``, ..."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    try:
        return np.dtype(dtype).name
    except TypeError:   # bfloat16 is no numpy dtype without ml_dtypes
        return str(dtype).rsplit(".", 1)[-1]


def shape_bucket(op: str, *, seq_len: int, heads: int | None = None,
                 d_head: int | None = None, dtype="float32") -> str:
    """Winner-table key: op + pow2-bucketed sequence length + head
    geometry + dtype. Sequences bucket to the next power of two so a
    244-token graph and a 250-token graph share one entry (schedules
    are not that shape-sensitive; the table stays small)."""
    s = 1 << max(0, int(seq_len) - 1).bit_length()
    parts = [op, f"S{s}"]
    if heads:
        parts.append(f"H{int(heads)}")
    if d_head:
        parts.append(f"D{int(d_head)}")
    parts.append(dtype_name(dtype))
    return "/".join(parts)


# ------------------------------------------------------------ enumerator

def enumerate_schedules(op: str, case: dict, pruned: list | None = None
                        ) -> list[Schedule]:
    """Legal candidate schedules for ``op`` on ``case`` (a dict from
    :mod:`repro_torch.tune.cases` carrying the concrete shapes, and for
    the cluster op its layout ``lay``). The reference's candidate grid,
    in its order, each candidate kept only if the port's kernel takes it;
    the default is always candidate 0, so a search can never come back
    empty or lose to the status quo by omission. With a list ``pruned``,
    each refused candidate is appended to it as ``(schedule, reason)``."""
    from repro_torch.kernels import ops as kops

    def refuse(cand, reason):
        if pruned is not None:
            pruned.append((cand, reason))

    default = DEFAULT_SCHEDULES[op]
    out = [default]
    dtype = case.get("dtype", "float32")

    if op == "flash_attention":
        Dh = case["d_head"]
        for bq in (32, 64, 128, 256):
            for bk in (32, 64, 128, 256):
                reason = kops.flash_check_launch(Dh, bq, bk, dtype)
                for hoist in (False, True):
                    cand = Schedule(op, block_q=bq, block_k=bk,
                                    hoist_scale=hoist)
                    if cand == default:
                        continue
                    if reason is None:
                        out.append(cand)
                    else:
                        refuse(cand, reason)

    elif op == "cluster_attention":
        # the block shape is the layout's; candidates vary the rewrites
        # and the plain version's row chunk
        lay = case["lay"]
        nq = lay.block_idx.shape[-2]
        for fuse in (False, True):
            for hoist in (False, True):
                for rc in (4, 8, 16):
                    cand = Schedule(op, row_chunk=rc, hoist_scale=hoist,
                                    fuse_bias=fuse)
                    if cand == default:
                        continue
                    if fuse and lay.buckets is None:
                        refuse(cand, "fuse_bias needs buckets: the unbiased "
                                     "op has no bias table to extend")
                    elif nq % min(rc, nq):
                        refuse(cand, f"row_chunk {rc} does not divide the "
                                     f"{nq} q-block rows")
                    else:
                        out.append(cand)

    elif op == "ssd":
        S = case["seq_len"]
        N = case.get("n_state", 1)
        for chunk in (64, 128, 256, 512):
            cand = Schedule(op, chunk=chunk)
            Q = min(chunk, S)
            reason = (f"chunk {Q} does not tile the sequence {S}" if S % Q
                      else kops.ssd_check_launch(case["d_head"], N, Q,
                                                 dtype))
            if reason is not None:
                refuse(cand, reason)
            elif cand != default:
                out.append(cand)

    elif op == "paged_attention":
        for chunk in (16, 32, 64):
            cand = Schedule(op, chunk=chunk)
            if cand != default:
                out.append(cand)
    else:
        raise ValueError(f"unknown op {op!r}")
    return out
