"""Synthetic LM token pipeline with host-sharded loading — the port's copy
of ``repro.data.lm_pipeline``: the same numpy batches, byte for byte.

Deterministic, seekable stream (step -> batch is a pure function) so that
restarts can replay/skip to the exact step without data loss or
duplication.

In a multi-host deployment each host materializes only its slice
(``host_id`` of ``n_hosts``); on a single host we return the full batch.
Batches are numpy arrays: ``tasks.BatchFnTask`` moves them to the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def lm_batch(cfg: LMDataConfig, step: int, *, host_id: int = 0,
             n_hosts: int = 1):
    """Markov-ish synthetic tokens: learnable structure (bigram bias) so
    training loss actually descends in integration tests."""
    b_local = cfg.global_batch // n_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host_id]))
    shape = (b_local, cfg.seq_len + 1)
    # learnable structure at two scales: (1) support restricted to V/8
    # tokens (unigram skew: loss drops from ln(V) to ~ln(V/8) within a few
    # steps), (2) deterministic bigram continuation with p=0.5
    support = max(2, cfg.vocab_size // 8)
    base = rng.integers(0, support, shape, dtype=np.int64)
    follow = rng.random(shape) < 0.5
    for t in range(1, shape[1]):
        nxt = (base[:, t - 1] * 7 + 3) % support
        base[:, t] = np.where(follow[:, t], nxt, base[:, t])
    tokens = base[:, :-1].astype(np.int32)
    labels = base[:, 1:].astype(np.int32)
    return {"tokens": tokens, "labels": labels}
