"""The ctypes declarations of every CUDA library of the port against the C
entry points of its source, on the CPU: each ``extern "C"`` function is
bound, with one argument type per C parameter (a pointer as
``c_void_p``, an ``int`` as ``c_int``, a ``float`` as ``c_float``) and an
``int`` result. A count off by one would shift every later argument of
a launch on the card."""

import ctypes
import re

import pytest

from repro_torch.kernels import cluster_attention as tca
from repro_torch.kernels import cluster_attention_bwd as tcab
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd as tks

LIBRARIES = {
    "cluster_attention_fwd": tca.LIBRARY,
    "cluster_attention_fwd_sm90": tca.LIBRARY_SM90,
    "cluster_attention_unbiased_fwd": tca.LIBRARY_UNBIASED,
    "cluster_attention_unbiased_fwd_sm90": tca.LIBRARY_UNBIASED_SM90,
    "cluster_attention_bwd": tcab.LIBRARY,
    "cluster_attention_bwd_dq_sm90": tcab.LIBRARY_DQ_SM90,
    "cluster_attention_bwd_dkv_sm90": tcab.LIBRARY_DKV_SM90,
    "cluster_attention_unbiased_bwd": tcab.LIBRARY_UNBIASED,
    "cluster_attention_unbiased_bwd_sm90": tcab.LIBRARY_UNBIASED_SM90,
    "flash_attention_fwd": tfa.LIBRARY,
    "flash_attention_fwd_sm90": tfa.LIBRARY_SM90,
    "flash_attention_bwd": tfa.LIBRARY_BWD,
    "flash_attention_bwd_dq_sm90": tfa.LIBRARY_DQ_SM90,
    "flash_attention_bwd_dkv_sm90": tfa.LIBRARY_DKV_SM90,
    "ssd": tks.LIBRARY,
}


class _Recorder:
    """Stands in for a loaded library: remembers what ``bind`` sets."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        fn = self.fns.setdefault(name, type("Fn", (), {})())
        return fn


def _c_entry_points(source: str):
    """``{name: [ctypes type per parameter]}`` of the ``extern "C"``
    functions in ``source``."""
    block = source[source.index('extern "C" {'):]
    out = {}
    for name, params in re.findall(r"\bint\s+(\w+)\s*\(([^)]*)\)\s*\{",
                                   block):
        kinds = []
        for p in params.split(","):
            p = " ".join(p.split())
            kinds.append(ctypes.c_void_p if "*" in p else
                         ctypes.c_float if p.startswith("float ") else
                         ctypes.c_int if p.startswith("int ") else p)
        out[name] = kinds
    return out


def test_every_source_has_a_library():
    csrc = next(iter(LIBRARIES.values())).source.parent
    assert sorted(p.stem for p in csrc.glob("*.cu")) == sorted(LIBRARIES)


@pytest.mark.parametrize("stem", sorted(LIBRARIES))
def test_bindings_match_c_entry_points(stem):
    lib = LIBRARIES[stem]
    assert lib.source.stem == stem
    want = _c_entry_points(lib.source.read_text())
    assert want, f"{stem}: no extern \"C\" entry point found"
    rec = _Recorder()
    lib._bind(rec)
    assert sorted(rec.fns) == sorted(want)
    for name, kinds in want.items():
        fn = rec.fns[name]
        assert list(fn.argtypes) == kinds, name
        assert fn.restype is ctypes.c_int, name
