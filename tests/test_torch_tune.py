"""The port's kernel autotuner (``repro_torch.tune``) on the CPU, against
the reference's (``repro.tune``) where the two must agree:

* the Schedule JSON round trip, and ``shape_bucket`` strings equal to
  the reference's (a bucket means the same shape in both packages);
* the winner table round trip (readable by the reference too), and bad
  tables that load as absent;
* the runtime's warn-once-and-defaults policy, the silent fresh
  checkout, and a CPU-gated table treated as stale for CUDA dispatch;
* dispatch consulting the installed table (memoized per generation);
* the enumerator: the default first, candidates the port's kernels
  refuse pruned with the reason, the SSD chunks that do not tile the
  sequence pruned as in the reference;
* ``_offline_cost`` equal to the reference's on the same case shapes;
* the search on the CPU (offline, gated plain-vs-plain; wall-clock
  raises) and ``python -m repro_torch.tune --offline --device cpu``
  writing both artifacts;
* the trainer's ``--retune-every`` reloading the table during a run.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro.tune import schedule as jschedule
from repro.tune import search as jsearch
from repro.tune.table import WinnerTable as JWinnerTable
from repro_torch.kernels import ops as tops
from repro_torch.tune import cases as tcases
from repro_torch.tune import runtime as rt
from repro_torch.tune import search
from repro_torch.tune.schedule import (DEFAULT_SCHEDULES,
                                       SCHEDULE_CACHE_VERSION, Schedule,
                                       enumerate_schedules, shape_bucket)
from repro_torch.tune.table import _KNOWN_CODECS, WinnerTable

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True)
def _clean_tune_state(tmp_path, monkeypatch):
    """Every test starts from the fresh-checkout state in an empty
    directory and leaves no table behind."""
    monkeypatch.chdir(tmp_path)
    rt.reset()
    yield
    rt.reset()


def _one_entry_table(sched=None, bucket="flash_attention/S256/float32",
                     backend="cpu"):
    t = WinnerTable(backend=backend)
    t.put(bucket, sched or Schedule("flash_attention", block_q=64,
                                    block_k=64))
    return t


# ------------------------------------------------------------ schedules

def test_schedule_json_round_trip_matches_reference():
    s = Schedule("flash_attention", block_q=64, block_k=256,
                 hoist_scale=True)
    assert Schedule.from_json(s.to_json()) == s
    assert Schedule.from_json({**s.to_json(), "future_field": 1}) == s
    ref = jschedule.Schedule("flash_attention", block_q=64, block_k=256,
                             hoist_scale=True)
    assert s.to_json() == ref.to_json()
    assert Schedule.from_json(ref.to_json()) == s
    assert s.describe() == ref.describe()
    assert {op: d.to_json() for op, d in DEFAULT_SCHEDULES.items()} == \
        {op: d.to_json() for op, d in jschedule.DEFAULT_SCHEDULES.items()}
    assert SCHEDULE_CACHE_VERSION == jschedule.SCHEDULE_CACHE_VERSION


@pytest.mark.parametrize("op,S,H,D", [
    ("flash_attention", 256, 4, 32), ("flash_attention", 16384, 16, 128),
    ("ssd", 250, 80, 64), ("cluster_attention", 244, 4, 32),
    ("paged_attention", 1, None, None), ("ssd", 16385, 2, 8)])
def test_shape_bucket_equals_reference(op, S, H, D):
    import jax.numpy as jnp
    for ours, theirs in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16),
                         ("float32", "float32"), (np.float32, np.float32)):
        assert shape_bucket(op, seq_len=S, heads=H, d_head=D, dtype=ours) \
            == jschedule.shape_bucket(op, seq_len=S, heads=H, d_head=D,
                                      dtype=theirs)


# ---------------------------------------------------------------- table

def test_winner_table_round_trip_and_reference_reads_it(tmp_path):
    path = str(tmp_path / "winners.json")
    t = _one_entry_table(backend="cuda:NVIDIA H100 80GB HBM3")
    assert t.codec in _KNOWN_CODECS
    t.save(path)
    loaded, reason = WinnerTable.load(path)
    assert reason is None and loaded.backend == t.backend
    assert loaded.version == SCHEDULE_CACHE_VERSION
    assert loaded.lookup("flash_attention/S256/float32") == \
        Schedule("flash_attention", block_q=64, block_k=64)
    assert loaded.lookup("unknown/bucket") is None
    theirs, reason = JWinnerTable.load(path)
    assert reason is None and theirs.entries == loaded.entries


@pytest.mark.parametrize("corruption", ["stale_version", "bad_codec",
                                        "garbage", "no_entries", "missing"])
def test_bad_tables_load_as_absent(tmp_path, corruption):
    path = str(tmp_path / "winners.json")
    if corruption == "garbage":
        with open(path, "w") as fh:
            fh.write('{"version": 1, "entries": {tr')
    elif corruption != "missing":
        raw = _one_entry_table().to_json()
        if corruption == "stale_version":
            raw["version"] = SCHEDULE_CACHE_VERSION + 1
        elif corruption == "bad_codec":
            raw["codec"] = "json+brotli"
        elif corruption == "no_entries":
            raw["entries"] = "oops"
        with open(path, "w") as fh:
            json.dump(raw, fh)
    table, reason = WinnerTable.load(path)
    assert table is None and reason is not None


# -------------------------------------------------------------- runtime

def test_stale_table_warns_once_and_dispatch_uses_defaults(tmp_path):
    path = str(tmp_path / "stale.json")
    raw = _one_entry_table().to_json()
    raw["version"] = SCHEDULE_CACHE_VERSION + 1
    with open(path, "w") as fh:
        json.dump(raw, fh)
    rt.reset(path)
    with pytest.warns(RuntimeWarning, match=r"repro_torch\.tune: stale"):
        sched = rt.lookup("flash_attention", "flash_attention/S256/float32")
    assert sched == DEFAULT_SCHEDULES["flash_attention"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the second lookup is silent
        assert rt.lookup("ssd", "x") == DEFAULT_SCHEDULES["ssd"]


def test_corrupt_and_missing_tables_warn_fresh_checkout_is_silent(tmp_path):
    path = str(tmp_path / "corrupt.json")
    with open(path, "w") as fh:
        fh.write("not json at all {{{")
    rt.reset(path)
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert rt.lookup("ssd", "ssd/S256/float32") == \
            DEFAULT_SCHEDULES["ssd"]
    with pytest.warns(RuntimeWarning, match="no winner table"):
        assert not rt.refresh(str(tmp_path / "nowhere.json"))
    rt.reset()   # the default path, absent in this empty directory
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert rt.lookup("ssd", "ssd/S256/float32") == \
            DEFAULT_SCHEDULES["ssd"]


def test_refresh_loads_the_default_path_and_bucket_miss_warns(tmp_path):
    winner = Schedule("ssd", chunk=64)
    _one_entry_table(winner, "ssd/S256/H2/D8/float32").save(
        rt.DEFAULT_TABLE_PATH)
    assert rt.refresh()
    assert rt.lookup("ssd", "ssd/S256/H2/D8/float32") == winner
    with pytest.warns(RuntimeWarning, match="no entry for ssd/S512"):
        assert rt.lookup("ssd", "ssd/S512/H2/D8/float32") == \
            DEFAULT_SCHEDULES["ssd"]


def test_cpu_gated_table_is_stale_for_cuda_dispatch():
    winner = Schedule("flash_attention", block_q=64, block_k=64,
                      hoist_scale=True)
    bucket = shape_bucket("flash_attention", seq_len=128, heads=2,
                          d_head=32, dtype=torch.float32)
    with rt.use_table(_one_entry_table(winner, bucket, backend="cpu")):
        assert tops.resolve_schedule("flash_attention", seq_len=128,
                                     heads=2, d_head=32,
                                     dtype=torch.float32) == winner
        with pytest.warns(RuntimeWarning, match="gated on 'cpu'"):
            got = tops.resolve_schedule("flash_attention", seq_len=128,
                                        heads=2, d_head=32,
                                        dtype=torch.float32,
                                        device_type="cuda")
        assert got == DEFAULT_SCHEDULES["flash_attention"]
    with rt.use_table(_one_entry_table(winner, bucket,
                                       backend="cuda:NVIDIA H100")):
        assert rt.lookup("flash_attention", bucket,
                         device_type="cuda") == winner


def test_dispatch_consults_installed_table():
    bucket = shape_bucket("flash_attention", seq_len=128, heads=2,
                          d_head=16, dtype="float32")
    winner = Schedule("flash_attention", block_q=32, block_k=32,
                      hoist_scale=True)
    with rt.use_table(_one_entry_table(winner, bucket)):
        got = tops.resolve_schedule("flash_attention", seq_len=128,
                                    heads=2, d_head=16, dtype="float32")
        assert got == winner
        # memoized: same generation -> the identical object
        assert tops.resolve_schedule("flash_attention", seq_len=128,
                                     heads=2, d_head=16,
                                     dtype="float32") is got
    # leaving the context bumped the generation: back to defaults
    assert tops.resolve_schedule(
        "flash_attention", seq_len=128, heads=2, d_head=16,
        dtype="float32") == DEFAULT_SCHEDULES["flash_attention"]


# ------------------------------------------------------------ enumerator

def _shape_case(op, **kw):
    return {"op": op, "B": 1, "dtype": "float32", **kw}


@pytest.mark.parametrize("d_head,n_legal", [(32, 12), (64, 12), (128, 8)])
def test_enumerator_default_first_unique_and_kernel_pruned(d_head, n_legal):
    case = _shape_case("flash_attention", seq_len=256, heads=4,
                       kv_heads=4, d_head=d_head)
    pruned = []
    cands = enumerate_schedules("flash_attention", case, pruned)
    assert cands[0] == DEFAULT_SCHEDULES["flash_attention"]
    assert len(set(cands)) == len(cands) == n_legal
    assert len(cands) + len(pruned) == 32   # the reference's grid
    assert {c.block_q for c in cands} == {64, 128}
    for c, why in pruned:
        assert why and c not in cands
    if d_head == 128:
        assert any("shared memory" in why for _, why in pruned)


def test_enumerator_ssd_pruning_matches_reference_where_the_kernel_fits():
    for S in (96, 256, 1000, 16384):
        case = _shape_case("ssd", seq_len=S, heads=2, d_head=8, n_state=4)
        ours = [c.to_json() for c in enumerate_schedules("ssd", case)]
        theirs = [c.to_json()
                  for c in jschedule.enumerate_schedules("ssd", case)]
        assert ours == theirs, S
    pruned = []
    case = _shape_case("ssd", seq_len=256, heads=2, d_head=128, n_state=4)
    assert enumerate_schedules("ssd", case, pruned) == \
        [DEFAULT_SCHEDULES["ssd"]]
    assert all("dh=128" in why for _, why in pruned)


def _cluster_layout(kind):
    """A layout of ``nq`` q-block rows: the tuner's graph case (8 rows,
    buckets), the LM's causal local+global layout (8 rows, no buckets),
    or 6 rows with buckets, which row_chunk 4 does not divide."""
    from types import SimpleNamespace

    from repro_torch.core.reformation import lm_local_global_layout
    if kind == "graph":
        return tcases.cluster_grad_case(244, bq=32, device="cpu")["lay"]
    if kind == "lm":
        return lm_local_global_layout(1024, window=256, n_global=128)
    return SimpleNamespace(block_idx=np.zeros((6, 3), np.int32),
                           buckets=np.zeros((6, 3, 16, 16), np.int8))


@pytest.mark.parametrize("kind,n_cands,reasons", [
    ("graph", 12, set()),
    ("lm", 6, {"fuse_bias needs buckets: the unbiased op has no bias "
               "table to extend"}),
    ("ragged_rows", 8, {"row_chunk 4 does not divide the 6 q-block rows"}),
], ids=("graph", "lm", "ragged_rows"))
def test_enumerator_offers_cluster_rewrites(kind, n_cands, reasons):
    """The reference's grid of ``fuse_bias`` x ``hoist_scale`` x
    ``row_chunk`` in {4, 8, 16}, the default first and once; what the
    port's kernels refuse is pruned with its reason: ``fuse_bias``
    without buckets, a row chunk that does not divide ``nq``."""
    pruned = []
    case = {"op": "cluster_attention", "lay": _cluster_layout(kind)}
    cands = enumerate_schedules("cluster_attention", case, pruned)
    assert cands[0] == DEFAULT_SCHEDULES["cluster_attention"]
    assert len(cands) == len(set(cands)) == n_cands
    assert len(cands) + len(pruned) == 12
    assert {why for _, why in pruned} == reasons
    if kind == "lm":
        assert not any(c.fuse_bias for c in cands)
        assert {c.hoist_scale for c in cands} == {False, True}
    if kind == "ragged_rows":
        assert all(c.row_chunk != 4 for c in cands)


# ------------------------------------------------------------ cost model

def test_offline_cost_equals_reference():
    """The same cost for every candidate of the reference's enumerator, on
    the reference's default cases and the port's, shape for shape."""
    for op in ("cluster_attention", "flash_attention", "ssd",
               "paged_attention"):
        ref_case = jsearch.default_case(op)
        our_case = search.default_case(op, device="cpu")
        assert search.bucket_of(our_case) == jsearch.bucket_of(ref_case)
        for c in jschedule.enumerate_schedules(op, ref_case):
            ours = search._offline_cost(op, our_case,
                                        Schedule.from_json(c.to_json()))
            assert ours == jsearch._offline_cost(op, ref_case, c), c


# ---------------------------------------------------------------- search

def test_offline_search_on_cpu_gates_plain_versions():
    logs = []
    table, recs = search.tune_all(("flash_attention", "ssd"), offline=True,
                                  device="cpu", log=logs.append)
    assert table.backend == "cpu"
    assert [r["op"] for r in recs] == ["flash_attention", "ssd"]
    for r in recs:
        assert r["source"] == "offline-cost-model" and r["speedup"] >= 1.0
        assert table.lookup(r["bucket"]) == Schedule.from_json(r["schedule"])
    assert any("no kernel was gated" in m for m in logs)
    case = tcases.flash_case(128, heads=2, d_head=32, device="cpu")
    assert search.oracle_equivalent(case, Schedule(
        "flash_attention", block_q=64, block_k=256, hoist_scale=True))


def test_wallclock_search_and_check_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    case = tcases.ssd_case(64, device="cpu")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        search.tune_op("ssd", case=case)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        search.check_regression(WinnerTable(backend="cpu"), op="ssd",
                                case=case)
    with pytest.raises(RuntimeError, match="is_available"):
        search.default_case("ssd")   # device="cuda" by default


def test_cuda_search_times_each_cluster_launch_once(monkeypatch):
    """The cluster kernels do not read ``row_chunk``: on CUDA the
    wall-clock search times each (``hoist_scale``, ``fuse_bias``) launch
    once, at the default row chunk, and ``check_regression`` times a
    winner that differs from the default only there as the default."""
    case = dict(tcases.cluster_grad_case(244, bq=32, device="cpu"),
                device=torch.device("cuda"))
    timed, logs = [], []
    monkeypatch.setattr(search, "time_schedule",
                        lambda case, s, **kw: timed.append(s) or (1.0, 2.0))
    monkeypatch.setattr(search, "oracle_equivalent", lambda case, s: True)
    winner, rec = search.tune_op("cluster_attention", case=case,
                                 log=logs.append)
    assert timed == [Schedule("cluster_attention", row_chunk=8,
                              hoist_scale=h, fuse_bias=f)
                     for f in (False, True) for h in (False, True)]
    assert winner == DEFAULT_SCHEDULES["cluster_attention"]
    assert rec["speedup"] == 1.0
    assert any("pruned 8 candidate(s)" in m
               and "the kernels do not read row_chunk" in m for m in logs)
    timed.clear()
    table = WinnerTable(backend="cuda:test")
    table.put(rec["bucket"], Schedule("cluster_attention", row_chunk=4))
    out = search.check_regression(table, case=case, rounds=3)
    assert timed == [DEFAULT_SCHEDULES["cluster_attention"]] * 3
    assert out["ratio"] == 1.0 and out["schedule"]["row_chunk"] == 4


@pytest.mark.parametrize("lead_holds", [False, True])
def test_cuda_search_confirms_a_host_bound_lead_in_turns(monkeypatch,
                                                         lead_holds):
    """On a host-bound case the search's one timing of each candidate is
    mostly noise: a winner other than the default keeps its place only
    if it is still faster than the default when the two are timed in
    turns (the fastest calls, as ``check_regression`` times them);
    otherwise the default wins."""
    case = dict(tcases.cluster_grad_case(244, bq=32, device="cpu"),
                device=torch.device("cuda"))
    fast = Schedule("cluster_attention", row_chunk=8, hoist_scale=True,
                    fuse_bias=True)
    turns = []

    def fake(case, s, **kw):
        if kw.get("reduce") == "min":   # timed in turns
            turns.append(s)
            lead = (s == fast) == lead_holds
            return (1.0, 2.0) if lead else (1.5, 3.0)
        return (0.5, 1.0) if s == fast else (1.0, 2.0)
    monkeypatch.setattr(search, "time_schedule", fake)
    monkeypatch.setattr(search, "oracle_equivalent", lambda case, s: True)
    logs = []
    winner, rec = search.tune_op("cluster_attention", case=case,
                                 log=logs.append)
    default = DEFAULT_SCHEDULES["cluster_attention"]
    assert turns == [fast, default] * search.CONFIRM_ROUNDS
    assert winner == (fast if lead_holds else default)
    assert rec["speedup"] == (2.0 if lead_holds else 1.0)
    assert any("in turns with the default" in m and
               ("kept" if lead_holds else "the default wins") in m
               for m in logs)
    # a case whose default call takes longer than the bound is not
    # host-bound: its search timing stands
    turns.clear()
    monkeypatch.setattr(search, "CONFIRM_BELOW_US", 2.0)
    winner, _ = search.tune_op("cluster_attention", case=case)
    assert winner == fast and turns == []


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    return subprocess.run([sys.executable, "-m", "repro_torch.tune", *args],
                          capture_output=True, text=True, env=env,
                          cwd=str(cwd))


def test_offline_cli_on_cpu_writes_artifacts(tmp_path):
    proc = _cli("--offline", "--device", "cpu", "--ops",
                "ssd,paged_attention", cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    loaded, reason = WinnerTable.load(str(tmp_path / rt.DEFAULT_TABLE_PATH))
    assert reason is None and len(loaded.entries) == 2
    assert loaded.backend == "cpu"
    with open(tmp_path / "BENCH_autotune_torch.json") as fh:
        data = json.load(fh)
    assert tuple(data["schema"]) == search.AUTOTUNE_SCHEMA
    assert len(data["records"]) == 2
    for rec in data["records"]:
        assert rec["source"] == "offline-cost-model"
        assert rec["speedup"] >= 1.0
    assert "no kernel was gated" in proc.stdout
    assert not os.path.exists(tmp_path / "TUNE_winners.json")


def test_cli_device_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    proc = _cli("--offline", "--ops", "paged_attention", cwd=tmp_path)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_trainer_retune_every_reloads_the_winner_table(tmp_path, capsys,
                                                       monkeypatch):
    """``--retune-every 2`` on a 4-step run reloads the table from
    ``--tune-table`` after steps 2 and 4, and the table in force after the
    run is the file's."""
    from repro_torch.launch import train as train_cli

    path = str(tmp_path / "winners.json")
    table = _one_entry_table(Schedule("ssd", chunk=64),
                             "ssd/S256/H2/D8/float32")
    table.save(path)
    calls = []
    refresh = rt.refresh
    monkeypatch.setattr(rt, "refresh",
                        lambda p=None: calls.append(p) or refresh(p))
    gen = rt.generation()
    # the graph model's cluster op reads the table too, which has no entry
    # for its bucket: it warns (once a load) and takes the default
    with pytest.warns(RuntimeWarning,
                      match="no entry for cluster_attention/S128"):
        tr = train_cli.main(["--arch", "gt", "--smoke", "--task", "graph",
                             "--graphs", "8", "--batch-graphs", "4",
                             "--steps", "4", "--device", "cpu",
                             "--retune-every", "2", "--tune-table", path])
    assert "status=done" in capsys.readouterr().out
    assert len(tr.history) == 4
    assert calls == [path, path]
    assert rt.generation() == gen + 2
    assert rt.active_table().entries == table.entries
