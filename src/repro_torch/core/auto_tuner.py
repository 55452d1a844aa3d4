"""Cluster dimensionality for the reformation layout: the port's copy of
``repro.core.auto_tuner.choose_cluster_dim``.

The constants below are the reference's heuristic, kept byte for byte
because they decide the layout and the port's layouts must equal the
reference's. They model a TPU core's fast memory, not an H100; a
Hopper-specific cluster size is work for a later PR.
"""

from __future__ import annotations

VMEM_BYTES = 16 * 1024 * 1024     # the reference's per-core budget


def choose_cluster_dim(seq_len: int, d_model: int, bq: int = 128) -> int:
    """Cluster dimensionality k — adapted from the paper's L2 formula
    k = floor(sqrt(Q_L2 / (i*d))): the cluster side is a multiple of bq
    that keeps the per-cluster k/v panel within a quarter of the
    reference's fast-memory budget."""
    panel = VMEM_BYTES // 4
    side = max(bq, min(seq_len,
                       (panel // max(d_model, 1) // bq) * bq or bq))
    k = max(1, seq_len // side)
    return k
