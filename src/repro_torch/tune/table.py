"""Persistent winner table: the autotuner's output, dispatch's input.

One JSON file (default ``TUNE_winners_torch.json``, gitignored) holding
the winning :class:`~repro_torch.tune.schedule.Schedule` per shape
bucket, in the reference's format (``repro.tune.table``), plus enough
provenance to refuse to misread it later:

* ``version`` — :data:`~repro_torch.tune.schedule.SCHEDULE_CACHE_VERSION`;
  a table recorded under any other version is *stale* and loads as
  absent (warn + defaults), never as wrong schedules;
* ``codec`` — recorded as the reference's checkpoint manifest records
  its codec (:func:`default_codec`); readers treat an unknown codec as
  stale rather than guess at the payload;
* ``backend`` — where the winners were gated: ``cuda:<card name>`` when
  every winner's kernel path matched the plain path on the card, ``cpu``
  when only the plain version was gated (no kernel runs there). Dispatch
  of CUDA tensors treats a ``cpu`` table as stale.

Loading NEVER raises: a missing file, unreadable JSON, wrong version or
unknown codec all return ``(None, reason)``, and the runtime layer warns
once and serves ``DEFAULT_SCHEDULES``.
"""

from __future__ import annotations

import json
import os

from repro_torch.tune.schedule import SCHEDULE_CACHE_VERSION, Schedule

_KNOWN_CODECS = ("json", "json+zstd", "json+zlib")


def default_codec() -> str:
    """zstd when available (fast, high ratio), zlib otherwise (stdlib):
    the port's copy of ``repro.ckpt.checkpoint.default_codec``."""
    try:
        import zstandard  # noqa: F401
        return "zstd"
    except ImportError:
        return "zlib"


class WinnerTable:
    """In-memory winner table; ``entries`` maps bucket -> record dict
    ``{"schedule": {...}, "fwd_us", "bwd_us", "default_fwd_us",
    "default_bwd_us", "source"}`` (timing fields optional)."""

    def __init__(self, *, version: int | None = None, codec: str | None = None,
                 backend: str = "", entries: dict | None = None):
        self.version = SCHEDULE_CACHE_VERSION if version is None else version
        self.codec = f"json+{default_codec()}" if codec is None else codec
        self.backend = backend
        self.entries: dict[str, dict] = dict(entries or {})

    def lookup(self, bucket: str) -> Schedule | None:
        rec = self.entries.get(bucket)
        if rec is None:
            return None
        return Schedule.from_json(rec["schedule"])

    def put(self, bucket: str, schedule: Schedule, **stats) -> None:
        self.entries[bucket] = {"schedule": schedule.to_json(), **stats}

    def to_json(self) -> dict:
        return {"version": self.version, "codec": self.codec,
                "backend": self.backend, "entries": self.entries}

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(self.to_json(), fh, indent=2, sort_keys=True)
        os.replace(tmp, path)  # atomic: readers never see a torn table

    @classmethod
    def load(cls, path: str) -> tuple["WinnerTable | None", str | None]:
        """(table, None) on success; (None, reason) on ANY problem —
        missing, corrupt, stale version, unknown codec. Never raises."""
        if not os.path.exists(path):
            return None, f"no winner table at {path}"
        try:
            with open(path) as fh:
                raw = json.load(fh)
        except (OSError, ValueError) as e:
            return None, f"unreadable winner table {path}: {e!r}"
        if not isinstance(raw, dict) or not isinstance(
                raw.get("entries", None), dict):
            return None, f"malformed winner table {path} (no entries dict)"
        version = raw.get("version")
        if version != SCHEDULE_CACHE_VERSION:
            return None, (f"stale winner table {path}: schedule-cache "
                          f"version {version!r} != current "
                          f"{SCHEDULE_CACHE_VERSION}")
        codec = raw.get("codec", "json")
        if codec not in _KNOWN_CODECS:
            return None, (f"winner table {path} recorded under unknown "
                          f"codec {codec!r}")
        return cls(version=version, codec=codec,
                   backend=raw.get("backend", ""),
                   entries=raw["entries"]), None
