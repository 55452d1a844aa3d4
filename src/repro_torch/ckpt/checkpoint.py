"""Async, verified checkpoints — the port of ``repro.ckpt.checkpoint``,
on the reference's on-disk format byte for byte, so each package reads
the other's checkpoints.

Format: a step directory ``step_{n:08d}/`` holding one compressed blob
per tree leaf (``leaf_{i:05d}.npy.{codec}``, the raw array bytes in C
order; leaves flattened by sorted key, joined with ``/``) plus
``manifest.json`` (``step``, ``codec``, ``leaves`` — each leaf's file,
shape, numpy dtype string and the crc32 of its raw bytes — and an
optional ``extra`` dict). Writes go to ``.tmp-*`` and are renamed; a
``COMMITTED`` marker makes partly written checkpoints invisible to
``latest_step``; only the newest ``keep`` generations stay.

* leaves are torch tensors on any device, numpy arrays or Python
  scalars. ``save`` snapshots every leaf to host memory synchronously —
  a COPY, since a CPU tensor's ``.numpy()`` aliases storage that the
  optimizer updates in place while the background thread compresses —
  then compresses and writes on a background thread; ``wait`` joins
  before the next save or exit;
* bf16 needs no ``ml_dtypes``: a bf16 tensor's bytes are written through
  an int16 view and read back with ``torch.frombuffer``, so a bf16 leaf
  of either package reads back bit for bit. ``restore`` returns numpy
  leaves by default (a bf16 leaf then needs ``ml_dtypes``) or torch
  tensors on ``device``;
* codecs: zstd when the optional ``zstandard`` package is installed, else
  stdlib zlib; the codec is recorded per checkpoint, and manifests
  without the field are zstd, as in the reference;
* verified lineage: ``restore`` verifies every leaf's crc32 by default
  and raises :class:`CheckpointCorrupt` naming the leaf; ``verify``
  audits a generation, ``generations`` lists committed steps newest
  first, ``restore_latest_verified`` walks them until one passes (with a
  RuntimeWarning for each it skips), and ``corrupt`` is the matching
  fault hook: one seeded byte flip in one leaf blob.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
import zlib

import numpy as np
import torch

SEP = "/"

# numpy dtype string (as the manifest records it) -> torch dtype
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


class CheckpointCorrupt(RuntimeError):
    """A checkpoint leaf failed checksum/size/decode verification."""


def _compress(codec: str, data: bytes) -> bytes:
    if codec == "zstd":
        import zstandard
        return zstandard.ZstdCompressor(level=1).compress(data)
    if codec == "zlib":
        return zlib.compress(data, 1)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _decompress(codec: str, data: bytes) -> bytes:
    if codec == "zstd":
        try:
            import zstandard
        except ImportError as e:
            raise RuntimeError(
                "checkpoint was written with the zstd codec; install the "
                "optional 'zstandard' package to restore it") from e
        return zstandard.ZstdDecompressor().decompress(data)
    if codec == "zlib":
        return zlib.decompress(data)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def default_codec() -> str:
    """zstd when available (fast, high ratio), zlib otherwise (stdlib)."""
    try:
        import zstandard  # noqa: F401
        return "zstd"
    except ImportError:
        return "zlib"


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    return {SEP.join(prefix): tree}


def _unflatten(flat):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split(SEP)
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _host(leaf):
    """A host copy of one leaf: a CPU tensor that owns its storage, or a
    numpy array (numpy leaves and scalars as ``np.asarray`` gives them,
    as the reference's ``device_get``)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


def snapshot(tree):
    """Host copies of every leaf of a nested dict (the blocking part of
    ``save``; also the trainer's rescue copy)."""
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    return _host(tree)


def _raw(v) -> tuple[bytes, list, str]:
    """(C-order bytes, shape, numpy dtype string) of a host leaf."""
    if isinstance(v, torch.Tensor):
        if v.dtype not in _NAMES:
            raise ValueError(f"no checkpoint dtype for {v.dtype}")
        bits = v.view(torch.int16) if v.dtype == torch.bfloat16 else v
        return bits.numpy().tobytes(), list(v.shape), _NAMES[v.dtype]
    return v.tobytes(), list(v.shape), str(v.dtype)


def _torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"checkpoint dtype {name!r} has no torch dtype")
    return _DTYPES[name]


def _numpy_dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        try:
            import ml_dtypes
        except ImportError as e:
            raise RuntimeError(
                "a bfloat16 leaf restores to numpy only with the "
                "'ml_dtypes' package; pass device= for torch leaves") from e
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 codec: str | None = None):
        self.dir = directory
        self.keep = keep
        self.codec = codec or default_codec()
        if self.codec not in ("zstd", "zlib"):
            # fail fast: the async save path compresses on a daemon
            # thread, where a bad codec would only die in a traceback
            raise ValueError(f"unknown checkpoint codec {self.codec!r}")
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------ save

    def save(self, step: int, tree, *, blocking: bool = False,
             extra: dict | None = None):
        """``extra`` is a JSON-safe dict stored verbatim in the manifest
        (the trainer keeps the task's state there; ``load_extra`` reads
        it back)."""
        self.wait()
        host = {k: _host(v) for k, v in _flatten(tree).items()}
        codec = self.codec

        def write():
            tmp = os.path.join(self.dir, f".tmp-{step:08d}")
            final = os.path.join(self.dir, f"step_{step:08d}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {"step": step, "codec": codec, "leaves": {}}
            if extra is not None:
                manifest["extra"] = extra
            for i, (k, v) in enumerate(host.items()):
                fn = f"leaf_{i:05d}.npy.{codec}"
                raw, shape, dtype = _raw(v)
                with open(os.path.join(tmp, fn), "wb") as f:
                    f.write(_compress(codec, raw))
                manifest["leaves"][k] = {
                    "file": fn, "shape": shape, "dtype": dtype,
                    # lineage checksum of the raw (uncompressed) bytes —
                    # restore verifies against this by default
                    "crc32": zlib.crc32(raw)}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write("ok")
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
            return

        def background():
            try:
                write()
            # not swallowed: wait() re-raises it in the caller's thread,
            # so a failed async save never passes for a written one
            except BaseException as e:  # repro-lint: disable=REP008
                self._error = e

        self._thread = threading.Thread(target=background, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the background write; re-raise its error, if it had one,
        so a failed async save never passes for a written one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------ load

    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "COMMITTED")):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def generations(self):
        """Committed steps newest-first — rollback enumerates these."""
        return list(reversed(self.all_steps()))

    def load_extra(self, step: int) -> dict | None:
        """The manifest's ``extra`` metadata dict (None if absent)."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f).get("extra")

    def _read_raw(self, d: str, codec: str, k: str, meta: dict,
                  verify: bool) -> bytes:
        path = os.path.join(d, meta["file"])
        with open(path, "rb") as f:
            blob = f.read()
        try:
            raw = _decompress(codec, blob)
        except Exception as e:
            # any codec failure on committed bytes means corruption;
            # surface it as the typed lineage error (note the re-raise)
            raise CheckpointCorrupt(
                f"leaf {k!r} ({meta['file']}) of step {d} failed to "
                f"decompress: {e}") from e
        name = meta["dtype"]
        itemsize = _DTYPES[name].itemsize if name in _DTYPES else \
            np.dtype(name).itemsize
        want = int(np.prod(meta["shape"], dtype=np.int64)) * itemsize
        if len(raw) != want:
            raise CheckpointCorrupt(
                f"leaf {k!r} ({meta['file']}) of step {d}: size mismatch "
                f"({len(raw)} bytes, manifest says {want})")
        if verify and "crc32" in meta and zlib.crc32(raw) != meta["crc32"]:
            raise CheckpointCorrupt(
                f"leaf {k!r} ({meta['file']}) of step {d}: crc32 mismatch "
                f"— checkpoint bytes are corrupt")
        return raw

    def verify(self, step: int) -> list[str]:
        """Audit one generation without materializing it into a tree.
        Returns a list of human-readable issues (empty = verified)."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        if not os.path.exists(os.path.join(d, "COMMITTED")):
            return [f"step {step}: missing COMMITTED marker"]
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            return [f"step {step}: unreadable manifest ({e})"]
        codec = manifest.get("codec", "zstd")
        issues = []
        for k, meta in manifest["leaves"].items():
            try:
                self._read_raw(d, codec, k, meta, verify=True)
            except (CheckpointCorrupt, OSError) as e:
                issues.append(str(e))
        return issues

    def restore(self, step: int, *, verify: bool = True, device=None):
        """The tree saved at ``step``: numpy leaves, or with ``device``
        torch tensors there. Leaves are checksum-verified against the
        manifest by default (``verify=False`` skips the crc pass but
        size/decode corruption still raises :class:`CheckpointCorrupt`)."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        codec = manifest.get("codec", "zstd")  # pre-codec manifests: zstd
        flat = {}
        for k, meta in manifest["leaves"].items():
            raw = self._read_raw(d, codec, k, meta, verify)
            if device is None:
                flat[k] = np.frombuffer(
                    raw, _numpy_dtype(meta["dtype"])).reshape(meta["shape"])
            else:
                dtype = _torch_dtype(meta["dtype"])
                t = (torch.frombuffer(bytearray(raw), dtype=dtype) if raw
                     else torch.empty(0, dtype=dtype))
                flat[k] = t.reshape(meta["shape"]).to(device)
        return _unflatten(flat)

    def restore_latest_verified(self, *, device=None):
        """Restore the newest generation that passes verification.

        Walks committed generations newest-first; a generation that fails
        checksum/size/decode verification is skipped with a
        RuntimeWarning and the next-older one is tried. Returns
        ``(tree, step)`` or None when no generation survives — the
        recovery ladder's checkpoint rung (corrupt latest falls back to
        an older verified generation; nothing verified means re-init).
        """
        for s in self.generations():
            try:
                tree = self.restore(s, device=device)
            except (CheckpointCorrupt, OSError, ValueError, KeyError) as e:
                warnings.warn(
                    f"repro_torch.ckpt: checkpoint step {s} failed "
                    f"verification ({e}); falling back to the previous "
                    f"generation", RuntimeWarning, stacklevel=2)
                continue
            return tree, s
        return None

    # ----------------------------------------------------- fault hook

    def corrupt(self, step: int, seed: int = 0) -> tuple[str, int]:
        """Deterministic fault-injection hook (repro_torch.resilience):
        flip one seeded byte in one leaf blob of a committed checkpoint.
        The manifest and COMMITTED marker are left intact, so directory
        discovery still trusts the generation — only checksum
        verification can catch the damage. Returns (file, offset)."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = sorted(manifest["leaves"].values(), key=lambda m: m["file"])
        rng = np.random.default_rng(seed)
        meta = leaves[int(rng.integers(len(leaves)))]
        path = os.path.join(d, meta["file"])
        with open(path, "rb") as f:
            blob = bytearray(f.read())
        off = int(rng.integers(len(blob)))
        blob[off] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(blob))
        return meta["file"], off
