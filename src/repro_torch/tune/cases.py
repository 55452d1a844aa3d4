"""Canonical tuning cases, one per op: the reference's
(``repro.tune.cases``) with the same signatures plus ``device``, and
inputs from seeded numpy instead of ``jax.random``.

Every case dict carries the shape fields ``enumerate_schedules`` and the
buckets read (``seq_len``, ``heads``, ``d_head``, ``dtype``), the device,
and ``fns(impl)``, which builds the forward-only closure and the
``(loss, grads)`` closure (None for a forward-only op) over the op's
dispatch: ``impl=None`` is the kernel on a CUDA device and the plain
version on the CPU, ``impl="plain"`` the plain version everywhere. Both
closures resolve their schedule from the winner table when they run.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve


def _tensor(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _grad_fn(loss, n_args: int):
    """``(loss, grads)`` of ``loss`` in its first ``n_args`` arguments."""
    def vg(*args):
        leaves = [a.detach().requires_grad_() for a in args[:n_args]]
        with torch.enable_grad():
            val = loss(*leaves, *args[n_args:])
            grads = torch.autograd.grad(val, leaves)
        return val.detach(), grads
    return vg


def _no_grad(loss):
    def fwd(*args):
        with torch.no_grad():
            return loss(*args)
    return fwd


def cluster_grad_case(n_nodes: int, *, bq: int = 64, d_b: int = 8,
                      heads: int = 4, d_head: int = 32, seed: int = 0,
                      device="cuda"):
    """One SBM graph layout and the forward-only and (loss, grads)
    closures over ops.cluster_attention (the biased kernels). Each call
    runs under the schedule the winner table holds for the case's bucket
    (``hoist_scale``, ``fuse_bias``, ``row_chunk``), so the search times
    and gates every candidate through the op's own dispatch, as it does
    the flash case's."""
    from repro_torch.core.graph import sbm_graph
    from repro_torch.core.reformation import build_layout
    from repro_torch.kernels import ops as kops

    dev = resolve(device)
    g = sbm_graph(n_nodes, 4, p_in=min(0.5, 40.0 / n_nodes),
                  p_out=1.0 / n_nodes, seed=seed)
    lay = build_layout(g, bq=bq, bk=bq, k_clusters=4, d_b=d_b, n_global=1)
    S = lay.seq_len
    rng = np.random.default_rng(seed)
    q = _tensor(rng.standard_normal((1, S, heads, d_head), np.float32), dev)
    bt = _tensor((rng.standard_normal((heads, lay.n_buckets)) * 0.2)
                 .astype(np.float32), dev)
    bi = _tensor(lay.block_idx, dev)[None]
    bu = _tensor(lay.buckets, dev)[None]
    bit = _tensor(lay.block_idx_t, dev)[None]

    def fns(impl=None):
        def loss(q, bt):
            return kops.cluster_attention(q, q, q, bi, bu, bt, bit,
                                          impl=impl).float().sum()
        return _no_grad(loss), _grad_fn(loss, 2)

    return {"op": "cluster_attention", "lay": lay, "seq_len": S, "q": q,
            "bt": bt, "fns": fns, "args": (q, bt), "B": 1, "heads": heads,
            "d_head": d_head, "n_buckets": lay.n_buckets, "dtype": "float32",
            "device": dev}


def flash_case(seq_len: int = 256, *, heads: int = 4, d_head: int = 32,
               seed: int = 0, device="cuda"):
    """Dense causal self-attention (k = v = q) over ops.flash_attention."""
    from repro_torch.kernels import ops as kops

    dev = resolve(device)
    rng = np.random.default_rng(seed)
    q = _tensor(rng.standard_normal((1, seq_len, heads, d_head), np.float32),
                dev)

    def fns(impl=None):
        def loss(q):
            return kops.flash_attention(q, q, q, causal=True,
                                        impl=impl).float().sum()
        return _no_grad(loss), _grad_fn(loss, 1)

    return {"op": "flash_attention", "seq_len": seq_len, "q": q,
            "fns": fns, "args": (q,), "B": 1, "heads": heads,
            "kv_heads": heads, "d_head": d_head, "dtype": "float32",
            "device": dev}


def ssd_case(seq_len: int = 256, *, heads: int = 2, d_head: int = 8,
             n_state: int = 4, seed: int = 0, device="cuda"):
    """Mamba2 SSD chunked scan over ops.ssd, forward only (the SSD kernel
    has no backward: the tuner times and gates the forward alone)."""
    from repro_torch.kernels import ops as kops

    dev = resolve(device)
    rng = np.random.default_rng(seed)
    B = 1
    x = rng.standard_normal((B, seq_len, heads, d_head), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, seq_len, heads)) - 2))
    a = -np.exp(rng.standard_normal(heads) * 0.3)
    b = rng.standard_normal((B, seq_len, n_state), np.float32)
    c = rng.standard_normal((B, seq_len, n_state), np.float32)
    x, dt, a, b, c = (_tensor(np.asarray(t, np.float32), dev)
                      for t in (x, dt, a, b, c))

    def fns(impl=None):
        def loss(x):
            y, _ = kops.ssd(x, dt, a, b, c, impl=impl)
            return y.float().sum()
        return _no_grad(loss), None

    return {"op": "ssd", "seq_len": seq_len, "x": x, "fns": fns,
            "args": (x,), "B": B, "heads": heads, "d_head": d_head,
            "n_state": n_state, "dtype": "float32", "device": dev}


def paged_case(max_len: int = 256, *, heads: int = 4, d_head: int = 32,
               device="cuda"):
    """Paged attention has no kernel — its ``chunk`` schedule is the
    serving loop's prefill chunking, with no effect on op math, so the
    case carries shapes only (the search scores it with the offline cost
    model and skips the gate)."""
    return {"op": "paged_attention", "seq_len": max_len, "heads": heads,
            "d_head": d_head, "fns": None, "args": (), "B": 1,
            "dtype": "float32", "device": resolve(device)}
