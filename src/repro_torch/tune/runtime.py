"""Process-global autotune state consulted by the dispatch layer.

``kernels/ops.py`` calls :func:`lookup` when an op runs (PyTorch runs
eagerly: a table swap applies from the next call on). Lookups are cheap
on the hot path: ops memoizes per (op, shape signature, device type,
:func:`generation`), and every table swap bumps the generation.

Fallback policy (never raise, warn once per cause): a missing, stale or
corrupt table -> warn + ``DEFAULT_SCHEDULES``; a loaded table without an
entry for the bucket -> warn (once per bucket) + ``DEFAULT_SCHEDULES``;
a table gated on the CPU (``backend`` ``cpu``: only the plain version was
gated) asked for a CUDA call -> warn + ``DEFAULT_SCHEDULES``, so no entry
that was not gated on the kernels reaches them. The one silent case:
nothing at the default path, the fresh-checkout state.

The reference's environment knobs are gone: the table is the file
``DEFAULT_TABLE_PATH`` in the working directory, or the path given to
:func:`refresh` or :func:`reset`. The default name differs from the
reference's, so a JAX table in the same directory is never read.
"""

from __future__ import annotations

import contextlib
import warnings

from repro_torch.tune.schedule import DEFAULT_SCHEDULES, Schedule
from repro_torch.tune.table import WinnerTable

DEFAULT_TABLE_PATH = "TUNE_winners_torch.json"

_state: dict = {"table": None, "loaded": False, "generation": 0,
                "path": DEFAULT_TABLE_PATH}
_warned: set[str] = set()


def generation() -> int:
    """Bumped on every table swap — dispatch memo keys include it."""
    return _state["generation"]


def _warn_once(key: str, msg: str) -> None:
    if key in _warned:
        return
    _warned.add(key)
    warnings.warn(f"repro_torch.tune: {msg}", RuntimeWarning, stacklevel=3)


def active_table() -> WinnerTable | None:
    """The loaded winner table, loading lazily on first use. Missing,
    stale or corrupt tables warn once and resolve to None (defaults) —
    except nothing at the default path, which is silent: nobody asked
    for a table."""
    if not _state["loaded"]:
        path = _state["path"]
        table, reason = WinnerTable.load(path)
        _state["table"] = table
        _state["loaded"] = True
        if reason is not None and not (path == DEFAULT_TABLE_PATH
                                        and reason.startswith("no winner")):
            _warn_once("load", f"{reason} — dispatch uses the built-in "
                               f"DEFAULT_SCHEDULES")
    return _state["table"]


def lookup(op: str, bucket: str, *, device_type: str = "cpu") -> Schedule:
    """Winner schedule for ``bucket``, falling back to the op default.
    Never raises. A CUDA call (``device_type="cuda"``) takes entries only
    from a table gated on CUDA."""
    table = active_table()
    if table is None:
        return DEFAULT_SCHEDULES[op]
    if device_type == "cuda" and not table.backend.startswith("cuda"):
        where = table.backend or "an unknown backend"
        _warn_once("backend", f"the winner table was gated on {where!r}, "
                              f"not on the CUDA kernels — CUDA dispatch "
                              f"uses the built-in DEFAULT_SCHEDULES")
        return DEFAULT_SCHEDULES[op]
    sched = table.lookup(bucket)
    if sched is not None:
        return sched
    _warn_once(f"miss:{bucket}",
               f"winner table has no entry for {bucket} — using the "
               f"default {DEFAULT_SCHEDULES[op].describe()}")
    return DEFAULT_SCHEDULES[op]


def set_table(table: WinnerTable | None) -> None:
    """Install an in-memory table (the tuner and tests use this; None
    means pure defaults, silent). Bumps the generation."""
    _state["table"] = table
    _state["loaded"] = True
    _state["generation"] += 1
    _warned.clear()


@contextlib.contextmanager
def use_table(table: WinnerTable | None):
    """Temporarily install ``table`` (None = pure defaults, silent) and
    restore the previous state on exit — the search runs every candidate
    through the real dispatch path with a one-entry table, and tests pin
    winners without leaking into later tests."""
    prev_table, prev_loaded = _state["table"], _state["loaded"]
    set_table(table)
    try:
        yield
    finally:
        _state["table"], _state["loaded"] = prev_table, prev_loaded
        _state["generation"] += 1
        _warned.clear()


def refresh(path: str | None = None) -> bool:
    """Reload the winner table from ``path`` (default: the current path)
    and make it the path of later loads. Never raises; on any load
    problem the in-memory table is REPLACED by defaults-only (warn once):
    a refresh says the file is the truth. Returns True iff a table was
    loaded."""
    if path is not None:
        _state["path"] = path
    table, reason = WinnerTable.load(_state["path"])
    _state["table"] = table
    _state["loaded"] = True
    _state["generation"] += 1
    _warned.clear()
    if reason is not None:
        _warn_once("load", f"{reason} — dispatch uses the built-in "
                           f"DEFAULT_SCHEDULES")
    return table is not None


def reset(path: str = DEFAULT_TABLE_PATH) -> None:
    """Forget any loaded table and warning state; the next lookup loads
    ``path`` (a missing file at a path other than the default warns)."""
    _state["table"] = None
    _state["loaded"] = False
    _state["path"] = path
    _state["generation"] += 1
    _warned.clear()
