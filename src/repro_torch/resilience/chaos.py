"""Chaos sweep: run the injected fault matrix end to end — the port of
``repro.resilience.chaos``.

``python -m repro_torch.resilience`` trains the SmolLM smoke LM on the
reference's token stream (``seq_len`` 32, batch 2) under every training
fault kind, drives the serve engine through overload and deadline
faults, and writes ``RESILIENCE_report_torch.json``. Each record
states how the fault was recovered and what the recovery promises:

* ``replay: "exact"`` — the recovered run's final parameters and moments
  were checked bitwise-identical to an unfaulted baseline (rollback and
  replay, preemption resume, checkpoint-generation fallback);
* ``replay: "skip"`` — the bad step was skipped by the guard; the run
  completes finite but takes one fewer update than the baseline (by
  design, no bitwise claim).

The cases (``preempt_rescued`` / ``preempt_unrescued`` are the port's
counterparts of the reference's ``_donated`` / ``_undonated``: the port's
worst crash instant is inside the in-place update, with or without a
rescue copy) also check where each recovery lands: the skipped step, the
rollback's target and the generations it passed over, the resume step
and the generation a corrupt checkpoint falls back to.
:func:`run_training_cases` runs them on any trainer factory, so the
tests and ``chip_smoke.py`` hold the GT graph-level and link runs to the
same cases.

The serve cases (``serve_overload``, ``serve_deadline``) drive the
token-serving engine (``serve/engine.py``) on the Qwen3 smoke model
through an arrival burst against a bounded queue and through deadlines
shed at admission and mid-flight, as the reference's do. Their replay is
``"n/a"``: the claim is typed rejection and shedding with the warm
engine adding no signature. Any unrecovered fault makes the report fail
(the CLI exits non-zero).
"""

from __future__ import annotations

import contextlib
import json
import tempfile
import warnings

import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.resilience.faults import Preempted

LM_CKPT_EVERY = 2   # the reference sweep's cadence


def lm_factory(*, steps: int, device="cuda"):
    """``(config name, make)``: ``make(ckpt_dir, **cfg)`` builds a fresh
    SmolLM smoke model (seed 0) and its Trainer on the reference's token
    stream, as the reference's sweep does."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch
    from repro_torch.models.lm import LMModel
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tasks import BatchFnTask

    cfg = get_smoke_config("smollm_135m")
    dc = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)

    def make(ckpt_dir, **kw):
        model = LMModel(cfg, device=device, seed=0)
        tc = TrainerConfig(steps=steps, ckpt_every=LM_CKPT_EVERY,
                           ckpt_dir=ckpt_dir, lr=1e-3, warmup=2, **kw)
        return Trainer(model, tc, task=BatchFnTask(lambda s: lm_batch(dc, s)))

    return cfg.name, make


def state_of(tr) -> list[torch.Tensor]:
    """Host copies of a trainer's parameters and moments, in order."""
    from repro_torch.runtime.trainer import host_copy

    return host_copy((*tr.params, *tr.opt.state_tensors()))


def bitwise(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(a, b))


def default_at(steps: int) -> dict:
    """The reference sweep's fault steps for a run of ``steps``."""
    return {"skip": steps // 2, "rollback": (steps // 2, steps // 2 + 2),
            "preempt": steps - 3, "corrupt": steps}


def _warned(caught, text: str) -> bool:
    return any(text in str(w.message) for w in caught)


def training_cases(make, *, steps: int, ckpt_every: int, at: dict,
                   baseline: list):
    """``[(name, kind, fn)]``; ``fn(dir, caught_warnings)`` returns
    ``(ok, replay, facts)``."""
    ce = ckpt_every

    def nonfinite_skip(d, caught):
        s = at["skip"]
        tr = make(d, fault_plan=f"nonfinite@{s}", max_bad_steps=0)
        status = tr.run()
        skipped = [h["step"] for h in tr.history if h["skipped"]]
        finite = bool(torch.isfinite(torch.tensor(
            tr.history[-1]["loss"]))) and all(
            bool(torch.isfinite(p).all()) for p in tr.params)
        ok = status == "done" and skipped == [s + 1] and finite
        return ok, "skip", {"status": status, "skipped_steps": skipped,
                            "want_skipped": [s + 1], "finite": finite}

    def nonfinite_rollback(d, caught):
        lo, hi = at["rollback"]
        tr = make(d, fault_plan=f"nonfinite@{lo}-{hi}", max_bad_steps=3)
        status = tr.run()
        rb = [(r.at_step, r.to_step) for r in tr.rollbacks]
        # the newest generation saved before the streak began; the ones
        # saved inside it (bad > 0) are passed over with a warning
        want = [(hi + 1, (lo // ce) * ce)]
        passed = list(range((lo // ce + 1) * ce, hi + 2, ce))
        warned = all(_warned(caught, f"checkpoint step {g} (saved inside "
                             f"a bad streak)") for g in passed)
        eq = bitwise(baseline, state_of(tr))
        ok = status == "done" and rb == want and warned and eq
        return ok, "exact", {"status": status, "rollbacks": rb,
                             "want_rollbacks": want,
                             "passed_over": passed,
                             "passed_over_warned": warned,
                             "bitwise_equal": eq}

    def preempt(d, rescued):
        p = at["preempt"]
        tr = make(d, fault_plan=f"preempt@{p}",
                  rescue_every=1 if rescued else 0)
        died = False
        try:
            tr.run()
        except Preempted:
            died = True
        # the crash save writes the rescue copy, or nothing (the state
        # was torn inside the update)
        saved = Checkpointer(d).latest_step()
        want = p if rescued else (p // ce) * ce
        tr2 = make(d)
        status = tr2.run()
        resumed = tr2.history[0]["step"] - 1 if tr2.history else None
        eq = bitwise(baseline, state_of(tr2))
        ok = died and saved == want and resumed == want and \
            status == "done" and eq
        return ok, "exact", {"preempted": died, "latest_after_crash": saved,
                             "resumed_at": resumed, "want_resume": want,
                             "status": status, "bitwise_equal": eq}

    def ckpt_corrupt(d, caught):
        tr = make(d, fault_plan=f"ckpt_corrupt@{at['corrupt']}")
        status = tr.run()
        issues = tr.ckpt.verify(at["corrupt"])
        # a fresh trainer falls back to the newest verified generation
        # and replays the tail
        tr2 = make(d)
        status2 = tr2.run()
        resumed = tr2.history[0]["step"] - 1 if tr2.history else None
        want = ((steps - 1) // ce) * ce
        warned = _warned(caught, f"checkpoint step {at['corrupt']} failed "
                                 f"verification")
        eq = bitwise(baseline, state_of(tr2))
        ok = status == status2 == "done" and bool(issues) and warned and \
            resumed == want and eq
        return ok, "exact", {"corrupted": tr.fault_log,
                             "verify_issues": len(issues),
                             "fallback_warned": warned,
                             "resumed_at": resumed, "want_resume": want,
                             "replayed_steps": len(tr2.history),
                             "bitwise_equal": eq}

    return [
        ("nonfinite_skip", "nonfinite", nonfinite_skip),
        ("nonfinite_rollback", "nonfinite", nonfinite_rollback),
        ("preempt_rescued", "preempt",
         lambda d, caught: preempt(d, rescued=True)),
        ("preempt_unrescued", "preempt",
         lambda d, caught: preempt(d, rescued=False)),
        ("ckpt_corrupt", "ckpt_corrupt", ckpt_corrupt),
    ]


def run_training_cases(make, *, steps: int, ckpt_every: int,
                       at: dict | None = None, only: str | None = None,
                       around=None) -> dict:
    """An unfaulted baseline, then every training case whose name holds
    ``only``, each in its own checkpoint directory. ``around(name)``, a
    context manager, wraps the baseline and each case (``chip_smoke.py``
    counts kernel launches there). Returns ``{"baseline": trainer,
    "baseline_status", "records"}``."""
    around = around or (lambda name: contextlib.nullcontext())
    at = {**default_at(steps), **(at or {})}
    with tempfile.TemporaryDirectory() as d, around("baseline"):
        base = make(d)
        base_status = base.run()
    if base_status != "done":
        raise RuntimeError(f"unfaulted baseline did not finish: "
                           f"{base_status!r}")
    baseline = state_of(base)

    def in_dir(name, fn):
        def call(caught):
            with tempfile.TemporaryDirectory() as d, around(name):
                return fn(d, caught)
        return call

    records = [run_case(name, kind, in_dir(name, fn))
               for name, kind, fn in training_cases(
                   make, steps=steps, ckpt_every=ckpt_every, at=at,
                   baseline=baseline)
               if only is None or only in name]
    return {"baseline": base, "baseline_status": base_status,
            "records": records}


def run_case(name: str, kind: str, call) -> dict:
    """One case's record: ``call(caught_warnings)`` returns ``(ok,
    replay, facts)``; a case that raises is recorded unrecovered."""
    rec = {"fault": name, "kind": kind}
    try:
        with warnings.catch_warnings(record=True) as caught:
            # recovery paths warn by design (fallback, rollback); the
            # case checks the warnings it expects
            warnings.simplefilter("always")
            ok, replay, facts = call(caught)
        rec.update(recovered=bool(ok), replay=replay,
                   detail=" ".join(f"{k}={v}" for k, v in facts.items()),
                   n_warnings=len(caught), facts=facts)
    # the sweep must survive every fault: a crash IS the finding —
    # recorded unrecovered here and turned into a failing report
    except Exception as e:  # noqa: BLE001  # repro-lint: disable=REP008
        rec.update(recovered=False, replay="none",
                   detail=f"sweep case died: {type(e).__name__}: {e}",
                   n_warnings=0, facts={})
    return rec


def serve_cases(device) -> list:
    """``[(name, kind, fn)]`` of the reference's serve faults on the port's
    engine; ``fn(caught_warnings)`` returns ``(ok, replay, facts)``."""

    def build_engine(**kw):
        from repro_torch.configs import get_smoke_config
        from repro_torch.models.lm import LMModel
        from repro_torch.serve import ServeEngine
        model = LMModel(get_smoke_config("qwen3_0_6b"), device=device, seed=0)
        return ServeEngine(model, batch_slots=2, page=8, max_len=128,
                           chunk=8, **kw)

    def serve_overload(caught):
        from repro_torch.serve import Admitted, Rejected
        eng = build_engine(max_queue=3)
        res = eng.inject_burst(8, max_tokens=4, seed=0)
        n_adm = sum(isinstance(r, Admitted) for r in res)
        n_rej = sum(isinstance(r, Rejected) and r.reason == "overloaded"
                    for r in res)
        stats = eng.run()
        ok = (n_adm == 3 and n_rej == 5 and stats["requests"] == 3
              and stats["rejected_overload"] == 5
              and stats["queue_peak"] <= 3
              and stats["traced_programs"] == 2)
        return ok, "n/a", {"admitted": n_adm, "rejected": n_rej, **{
            k: stats[k] for k in ("requests", "rejected_overload",
                                  "queue_peak", "traced_programs")}}

    def serve_deadline(caught):
        eng = build_engine()
        eng.submit("warm", [1, 2, 3], 3)
        eng.run()   # warm: both programs seen
        eng.submit("past", [1, 2, 3], 4, deadline=-1.0)
        eng.submit("slow", [1, 2, 3, 4], 100, deadline=0.001)
        eng.submit("ok", [5, 6, 7], 4)
        stats = eng.run()   # a warm engine: budget 0 new signatures
        sheds = {r.rid: r.reason for r in eng.rejected}
        ok = ("ok" in eng.done and len(eng.done["ok"]) == 4
              and sheds.get("past") == "deadline"
              and sheds.get("slow") == "deadline"
              and "past" in eng.shed and "slow" in eng.shed
              and stats["shed_deadline"] == 2
              and stats["traced_programs"] == 2)
        return ok, "n/a", {
            "shed": sheds,
            "partial_tokens": {k: len(v) for k, v in eng.shed.items()},
            "traced_programs": stats["traced_programs"]}

    return [("serve_overload", "burst", serve_overload),
            ("serve_deadline", "burst", serve_deadline)]


def run_chaos(report_path: str = "RESILIENCE_report_torch.json", *,
              offline: bool = True, steps: int = 8,
              only: str | None = None, device="cuda") -> dict:
    """Run the fault matrix: the training faults on the SmolLM smoke LM,
    the serve faults on the Qwen3 smoke engine; write and return the
    report dict."""
    arch, make = lm_factory(steps=steps, device=device)
    out = run_training_cases(make, steps=steps, ckpt_every=LM_CKPT_EVERY,
                             only=only)
    records = out["records"] + [
        run_case(name, kind, fn)
        for name, kind, fn in serve_cases(device)
        if only is None or only in name]
    for rec in records:
        state = "recovered" if rec["recovered"] else "UNRECOVERED"
        print(f"[chaos] {rec['fault']:20s} {state}  ({rec['detail']})")
    unrecovered = [r["fault"] for r in records if not r["recovered"]]
    doc = {
        "tool": "repro_torch.resilience",
        "mode": "offline" if offline else "live",
        "arch": arch, "steps": steps, "device": str(device),
        "baseline_status": out["baseline_status"],
        "faults": [{k: v for k, v in r.items() if k != "facts"}
                   for r in records],
        "unrecovered": unrecovered,
        "ok": not unrecovered,
    }
    with open(report_path, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"[chaos] {len(records) - len(unrecovered)}/{len(records)} "
          f"faults recovered -> {report_path}")
    return doc
