"""Schedule search: score legal candidates, gate winners on equivalence
with the plain version, emit a winner table and BENCH_autotune records.

Two scoring backends share one selection loop:

wall-clock (``offline=False``, CUDA only)
    Every candidate is timed through the real dispatch path on the card:
    a one-entry winner table is installed (``runtime.use_table``), and
    :func:`repro_torch.tune.timing.time_candidate` takes a trimmed mean
    of CUDA-event times of the kernel path. Forward and (loss, grads) are
    timed separately. The cluster op's candidates that differ only in
    ``row_chunk``, which the kernels do not read, are one launch and
    are timed once (:func:`launched`). On a host-bound case a winner
    other than the default must confirm its lead timed in turns with it
    (:func:`fastest_in_turns`), as ``check_regression`` times them.
    Without CUDA it raises: the plain version on the CPU is not the
    kernel.

offline (``offline=True``, the CPU / CI mode)
    The reference's deterministic cost model (:func:`_offline_cost`):
    the same winner on every run, no timers.

Either way the loop walks candidates best-score-first and the FIRST one
that passes the gate (:func:`oracle_equivalent`) wins — the default is
gated like the rest, and a search none passes raises: forward and
gradients under the candidate within atol = rtol = 1e-4 of the plain
version under the defaults, on the case's fp32 inputs. On CUDA that
holds the kernel path to the plain path; on the CPU, where no kernel
exists, it holds the plain version under the candidate's chunking to the
plain version under the defaults, and the log says that no kernel was
gated. The table records where it was gated (``backend``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.tune import cases as tune_cases
from repro_torch.tune import runtime, timing
from repro_torch.tune.schedule import (DEFAULT_SCHEDULES, Schedule,
                                       enumerate_schedules, shape_bucket)
from repro_torch.tune.table import WinnerTable

TUNABLE_OPS = ("cluster_attention", "flash_attention", "ssd",
               "paged_attention")

# the one schema of BENCH_autotune records (the reference's). In offline
# runs fwd_us/bwd_us carry cost-model units, not microseconds — the
# ``source`` field says which.
AUTOTUNE_SCHEMA = ("op", "bucket", "mode", "schedule", "source", "fwd_us",
                   "bwd_us", "default_fwd_us", "default_bwd_us", "speedup")

# a wall-clock winner other than the default, on a case whose default
# call takes under CONFIRM_BELOW_US (host-side launch work, where one
# timing of each candidate is mostly noise), keeps its place only if it
# is still faster when the two are timed in turns CONFIRM_ROUNDS times,
# as check_regression times them
CONFIRM_BELOW_US = 20_000.0
CONFIRM_ROUNDS = 3

_TILE_OVERHEAD = 4096   # per-grid-cell cost: DMA setup + pipeline bubble
_BWD_FACTOR = 2.5       # recompute backward ~ dq pass + dkv pass + fwd


def backend_name(device) -> str:
    """Where a table's winners were gated: ``cuda:<card name>`` or
    ``cpu``."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


def default_case(op: str, device="cuda") -> dict:
    """The canonical case per op, the reference's shapes: the cluster
    case is the tier-1 bench case (S_target 256 -> 244 nodes)."""
    if op == "cluster_attention":
        return tune_cases.cluster_grad_case(244, bq=32, heads=4, d_head=32,
                                            device=device)
    if op == "flash_attention":
        return tune_cases.flash_case(256, heads=4, d_head=32, device=device)
    if op == "ssd":
        return tune_cases.ssd_case(256, device=device)
    if op == "paged_attention":
        return tune_cases.paged_case(256, device=device)
    raise ValueError(f"unknown op {op!r}")


def bucket_of(case: dict) -> str:
    return shape_bucket(case["op"], seq_len=case["seq_len"],
                        heads=case.get("heads"), d_head=case.get("d_head"),
                        dtype=case.get("dtype", "float32"))


def _candidate_table(case: dict, sched: Schedule) -> WinnerTable:
    tbl = WinnerTable(backend=backend_name(case["device"]))
    tbl.put(bucket_of(case), sched, source="candidate")
    return tbl


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [y for z in x for y in _leaves(z)]
    return [x]


def _trees_close(a, b, *, atol: float, rtol: float) -> bool:
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        return False
    return all(torch.allclose(x.float(), y.float(), atol=atol, rtol=rtol)
               for x, y in zip(la, lb))


def oracle_equivalent(case: dict, sched: Schedule, *, atol: float = 1e-4,
                      rtol: float = 1e-4) -> bool:
    """Gate: under ``sched`` the case's dispatch path (the kernels on a
    CUDA device, the plain version with ``sched``'s chunking on the CPU)
    must give the forward and gradients of the plain version under the
    defaults. Ops without a kernel (paged attention) pass trivially."""
    if case.get("fns") is None:
        return True
    with runtime.use_table(_candidate_table(case, sched)):
        kf, kg = case["fns"](None)
        got = (kg or kf)(*case["args"])
    with runtime.use_table(None):
        rf, rg = case["fns"]("plain")
        want = (rg or rf)(*case["args"])
    return _trees_close(got, want, atol=atol, rtol=rtol)


def time_schedule(case: dict, sched: Schedule, *, warmup: int = 2,
                  iters: int = 5, reduce: str = "trimmed"):
    """(fwd_us, bwd_us) of the case's kernel path under ``sched`` on the
    card; ``bwd_us`` is the full (loss, grads) call (forward included),
    0.0 for a forward-only op. Raises without CUDA."""
    with runtime.use_table(_candidate_table(case, sched)):
        fwd, vg = case["fns"](None)
        kw = {"device": case["device"], "warmup": warmup, "iters": iters,
              "reduce": reduce}
        fwd_us, _ = timing.time_candidate(fwd, *case["args"], **kw)
        bwd_us = 0.0
        if vg is not None:   # forward-only kernels (ssd) time fwd alone
            bwd_us, _ = timing.time_candidate(vg, *case["args"], **kw)
    return fwd_us, bwd_us


def fastest_in_turns(case: dict, scheds, *, warmup: int = 2,
                     iters: int = 5, rounds: int = 3) -> list:
    """Each of ``scheds``' fastest forward plus fastest (loss, grads)
    call in microseconds, the schedules timed in turns ``rounds`` times
    (:func:`time_schedule`, the fastest of ``iters`` calls each time): on
    a case bound by host-side launch work, interference only ever adds
    time, and turns spread it over the schedules."""
    kw = {"warmup": warmup, "iters": iters, "reduce": "min"}
    times = [[] for _ in scheds]
    for _ in range(rounds):
        for t, sched in zip(times, scheds):
            t.append(time_schedule(case, sched, **kw))
    return [sum(min(r[i] for r in t) for i in (0, 1)) for t in times]


def launched(op: str, sched: Schedule, device) -> Schedule:
    """``sched`` as ``device`` runs it: the cluster kernels do not read
    ``row_chunk`` (the plain version's q-row chunking), so on CUDA the
    cluster op's candidates that differ only there are one launch, taken
    at the op default's ``row_chunk``."""
    if op == "cluster_attention" and torch.device(device).type == "cuda":
        return dataclasses.replace(
            sched, row_chunk=DEFAULT_SCHEDULES[op].row_chunk)
    return sched


# ------------------------------------------------------- offline cost model

def _offline_cost(op: str, case: dict, s: Schedule) -> float:
    """Deterministic per-candidate cost in abstract element-op units,
    copied verbatim from the reference: the TPU-shaped ordering (padded
    128-lane tiles, a per-grid-cell overhead, the rewrite savings), used
    only for deterministic CPU / CI runs. It knows nothing of the H100;
    the wall-clock search on the card is what picks the card's winners.
    Charges padded tile work, a fixed per-grid-cell overhead, and the
    rewrite savings; the absolute scale is meaningless — only the
    ordering is consumed."""
    S = case["seq_len"]
    dh = case.get("d_head") or 64
    dh_pad = dh + (-dh % 128)
    B, H = case.get("B", 1), case.get("heads", 1)

    if op == "flash_attention":
        bq, bk = min(s.block_q, S), min(s.block_k, S)
        nq, nk = -(-S // bq), -(-S // bk)
        cells = B * H * nq * nk
        work = cells * bq * bk * (2 * dh_pad + 8)
        scale = (B * H * nq * bq * dh_pad if s.hoist_scale
                 else cells * bq * bk)
        return float(work + scale + cells * _TILE_OVERHEAD)

    if op == "cluster_attention":
        lay = case["lay"]
        nq, mb = lay.block_idx.shape[-2:]
        bq = S // nq
        bk = lay.buckets.shape[-1] if lay.buckets is not None else bq
        cells = B * H * nq * mb
        work = cells * bq * bk * (2 * dh_pad + 8)
        scale = (B * H * nq * bq * dh_pad if s.hoist_scale
                 else cells * bq * bk)
        # biased tile: clip + take + where-pair (3 elementwise sweeps)
        # vs fused sentinel take + add (1)
        bias = cells * bq * bk * (1 if s.fuse_bias else 3)
        # ref-path q-row chunking: mild prior keeping the measured sweet
        # spot (8) on ties — the kernel ignores row_chunk entirely
        rc_pen = 64 * abs((s.row_chunk or 8) - 8)
        return float(work + scale + bias + cells * _TILE_OVERHEAD + rc_pen)

    if op == "ssd":
        c = min(s.chunk, S)
        return float(S * c * 4 + (S // c) * 2 * _TILE_OVERHEAD)

    if op == "paged_attention":
        c = s.chunk
        return float(-(-S // c) * 2 * _TILE_OVERHEAD + c * 64)

    raise ValueError(f"unknown op {op!r}")


# ------------------------------------------------------------- the search

def tune_op(op: str, *, offline: bool = False, case: dict | None = None,
            device="cuda", warmup: int = 2, iters: int = 5,
            log=None) -> tuple[Schedule, dict]:
    """Search ``op`` on ``case`` (default: :func:`default_case` on
    ``device``). Returns ``(winner, record)`` where record follows
    ``AUTOTUNE_SCHEMA``. ``warmup``/``iters`` are the wall-clock timing's
    calls per candidate."""
    case = default_case(op, device) if case is None else case
    bucket = bucket_of(case)
    pruned = []
    cands = enumerate_schedules(op, case, pruned)
    use_model = offline or case.get("fns") is None
    on_cuda = case["device"].type == "cuda"
    if not use_model:   # time each launch once
        kept = []
        for c in cands:
            k = launched(op, c, case["device"])
            if k in kept:
                pruned.append((c, "the kernels do not read row_chunk"))
            else:
                kept.append(k)
        cands = kept
    mode = "offline" if use_model else "wallclock"
    source = "offline-cost-model" if use_model else "wallclock"
    if log:
        reasons = {}
        for c, why in pruned:
            reasons.setdefault(why, []).append(c)
        for why, cs in reasons.items():
            log(f"# tune: {op}: pruned {len(cs)} candidate(s), e.g. "
                f"{cs[0].describe()}: {why}")
        if case.get("fns") is not None and not on_cuda:
            log(f"# tune: {op}: on the cpu the gate holds the plain version "
                f"under each candidate's chunking to the defaults; no "
                f"kernel was gated")

    scored = []  # (total, fwd_us, bwd_us, index)
    for i, c in enumerate(cands):
        if use_model:
            cost = _offline_cost(op, case, c)
            scored.append((cost, round(cost, 1),
                           round(_BWD_FACTOR * cost, 1), i))
        else:
            f, b = time_schedule(case, c, warmup=warmup, iters=iters)
            scored.append((f + b, round(f, 1), round(b, 1), i))
            if log:
                log(f"# tune: {op}: {c.describe()} fwd {f:.1f} us, "
                    f"fwd+grads {b:.1f} us")
    by_index = {s[3]: s for s in scored}
    d_fwd, d_bwd = by_index[0][1], by_index[0][2]
    winner = None
    for _, f, b, i in sorted(scored):
        c = cands[i]
        if oracle_equivalent(case, c):
            winner, w_fwd, w_bwd = c, f, b
            break
        if log:
            log(f"# tune: {op}: pruned {c.describe()} — mismatch with the "
                f"plain version on the gate")
    if winner is None:   # the default too: the kernel disagrees
        raise RuntimeError(f"tune: {op}: no candidate, the default "
                           f"included, matched the plain version on {bucket}")
    default = cands[0]
    if not use_model and winner != default and \
            d_fwd + d_bwd < CONFIRM_BELOW_US:
        w_us, d_us = fastest_in_turns(case, [winner, default], warmup=warmup,
                                      iters=iters, rounds=CONFIRM_ROUNDS)
        kept = w_us < d_us or not oracle_equivalent(case, default)
        if log:
            log(f"# tune: {op}: {winner.describe()} in turns with the "
                f"default, fastest calls: {w_us:.1f} vs {d_us:.1f} us; "
                + ("kept" if kept else "the default wins"))
        if not kept:
            winner, w_fwd, w_bwd = default, d_fwd, d_bwd

    speedup = (d_fwd + d_bwd) / max(w_fwd + w_bwd, 1e-9)
    rec = dict(zip(AUTOTUNE_SCHEMA, (
        op, bucket, mode, winner.to_json(), source, w_fwd, w_bwd,
        d_fwd, d_bwd, round(speedup, 3))))
    if log:
        log(f"# tune: {op}: {winner.describe()} @ {bucket} "
            f"({source}, speedup {rec['speedup']}x over default)")
    return winner, rec


def tune_all(ops=None, *, offline: bool = False, device="cuda", log=None):
    """Tune every op (or the given subset) on their default cases;
    returns ``(table, records)`` — the table ready to
    :meth:`~repro_torch.tune.table.WinnerTable.save`, the records ready
    for the BENCH file."""
    table = WinnerTable(backend=backend_name(device))
    records = []
    for op in (ops or TUNABLE_OPS):
        winner, rec = tune_op(op, offline=offline, device=device, log=log)
        table.put(rec["bucket"], winner, source=rec["source"],
                  mode=rec["mode"], fwd_us=rec["fwd_us"],
                  bwd_us=rec["bwd_us"], default_fwd_us=rec["default_fwd_us"],
                  default_bwd_us=rec["default_bwd_us"])
        records.append(rec)
    return table, records


def check_regression(table: WinnerTable, *, threshold: float = 1.2,
                     op: str = "cluster_attention", case: dict | None = None,
                     device="cuda", warmup: int = 2, iters: int = 5,
                     rounds: int = 3, log=None) -> dict:
    """CI guard: WALL-CLOCK (even after an offline search) the table's
    schedule for ``op`` against the default on ``case`` (default: the
    op's default case); the tuned pick must stay within ``threshold``x.
    Catches a cost model drifting away from the machine. The two are
    timed in turns, ``rounds`` times each, and each side's fastest calls
    are compared: the default cases take about a millisecond of
    host-side launch work on the card, where the trimmed means of the
    same schedule came out up to 27% apart and the fastest calls up to
    10%. A tuned schedule that launches as the default does
    (:func:`launched`) is the same launch: it is timed once, ratio 1.
    Needs CUDA."""
    case = default_case(op, device) if case is None else case
    bucket = bucket_of(case)
    default = DEFAULT_SCHEDULES[op]
    tabled = table.lookup(bucket) or default
    sched = launched(op, tabled, case["device"])
    scheds = [default] if sched == default else [default, sched]
    us = fastest_in_turns(case, scheds, warmup=warmup, iters=iters,
                          rounds=rounds)
    d_us, t_us = us[0], us[-1]
    ratio = t_us / max(d_us, 1e-9)
    out = {"op": op, "bucket": bucket, "mode": "wallclock",
           "schedule": tabled.to_json(), "tuned_us": round(t_us, 1),
           "default_us": round(d_us, 1), "ratio": round(ratio, 3),
           "threshold": threshold, "ok": bool(ratio <= threshold)}
    if log:
        verdict = "ok" if out["ok"] else "REGRESSION"
        log(f"# tune-check: {op} tuned {out['tuned_us']}us vs default "
            f"{out['default_us']}us (ratio {out['ratio']} <= {threshold}: "
            f"{verdict})")
    return out
