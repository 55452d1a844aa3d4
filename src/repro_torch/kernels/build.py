"""Build of the port's CUDA sources: each ``csrc/*.cu`` is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C entry point
and loaded with ``ctypes``.

A build lands in ``_build/<key>/`` next to this file, keyed on a hash of
the source, the ``csrc/*.cuh`` headers it may include and the flags, so a
fresh checkout builds each source once.
:func:`build_all` starts one ``nvcc`` per source, all at once, and waits
for them together. Build errors raise with nvcc's output: nothing falls
back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_HERE = pathlib.Path(__file__).resolve().parent
BUILD_ROOT = _HERE / "_build"
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = pathlib.Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and on PATH)")
    return found


class CudaLibrary:
    """One ``.cu`` source and the library built from it. ``bind(lib)``
    declares the ctypes signatures of its C entry points."""

    def __init__(self, source: pathlib.Path, bind):
        self.source = source
        self._bind = bind
        self._lib = None
        self.log = ""          # nvcc's output of the build this process ran
        self.seconds = 0.0     # 0.0 when the library was already on disk

    def path(self) -> pathlib.Path:
        text = self.source.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(self.source.parent.glob("*.cuh")))
        key = hashlib.sha256(text + " ".join(
            [_nvcc()] + NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_ROOT / key / f"lib{self.source.stem}.so"

    def _start(self):
        """Start nvcc unless the library is on disk; returns
        ``(process, tmp path, start time)`` or None."""
        lib = self.path()
        if lib.exists():
            return None
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.parent / f".tmp-{os.getpid()}-{lib.name}"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, time.perf_counter()

    def _finish(self, started) -> None:
        proc, tmp, t0 = started
        self.log = proc.communicate()[0]
        self.seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n{self.log}")
        os.replace(tmp, self.path())

    def build(self) -> pathlib.Path:
        build_all([self])
        return self.path()

    def lib(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._bind(lib)
            self._lib = lib
        return self._lib


def build_all(libraries) -> None:
    """Compile every library not yet on disk, one nvcc each, all started
    together; raises on the first that fails, after all have ended."""
    started = [(lib, lib._start()) for lib in libraries]
    errors = []
    for lib, st in started:
        if st is not None:
            try:
                lib._finish(st)
            except RuntimeError as e:
                errors.append(e)
    if errors:
        raise errors[0]
