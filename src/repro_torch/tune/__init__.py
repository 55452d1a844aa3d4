"""Kernel autotuning for the port's CUDA kernels: schedule search, a
persistent winner table, and the runtime state the dispatch layer
consults (``kernels/ops.py`` resolves the flash block sizes and the SSD
chunk here at call time).

Light by design: importing ``repro_torch.tune`` pulls in only the
schedule contract, the table codec and the runtime state. The search,
the canonical cases and the timing harness live behind
``repro_torch.tune.search`` / ``cases`` / ``timing`` and the
``python -m repro_torch.tune`` CLI.
"""

from repro_torch.tune.runtime import (DEFAULT_TABLE_PATH, active_table,
                                      generation, lookup, refresh, reset,
                                      set_table, use_table)
from repro_torch.tune.schedule import (DEFAULT_SCHEDULES,
                                       SCHEDULE_CACHE_VERSION, Schedule,
                                       enumerate_schedules, shape_bucket)
from repro_torch.tune.table import WinnerTable

__all__ = [
    "DEFAULT_SCHEDULES", "DEFAULT_TABLE_PATH", "SCHEDULE_CACHE_VERSION",
    "Schedule", "WinnerTable", "active_table", "enumerate_schedules",
    "generation", "lookup", "refresh", "reset", "set_table", "shape_bucket",
    "use_table",
]
