"""The port's checkpoints against the JAX package, on the CPU: the same
tree saved by ``repro.ckpt.checkpoint.Checkpointer`` and by the port's
gives byte-identical directories (zlib); each restores the other's bit
for bit (bf16 and 0-d int32 leaves included); the reference's checkpoint
tests, ported (garbage collection, atomic commit, checksums, ``verify``,
generation fallback, ``extra``, codecs); a save followed at once by an
in-place update restores the bytes of the save; ``params_to_jax`` inverts
``params_from_jax`` exactly for every arch; ``AdamW``'s state dict; and
the train CLI's ``--ckpt-dir`` resume and ``--fault-plan``. Every
comparison is exact.
"""

import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_smoke_config as jsmoke
from repro.models import build
from repro_torch.ckpt.checkpoint import CheckpointCorrupt, Checkpointer
from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.launch import train as train_cli
from repro_torch.optim.adamw import AdamW

EXTRA = {"task": {"task": "graph_level", "tuner": {"pos": 3,
                                                   "ladder": [0.0, 0.5]},
                  "moves": []}}


def _tree():
    """A nested numpy tree with the leaf kinds a trainer saves."""
    rng = np.random.default_rng(0)
    return {"params": {"layers": {"w": rng.standard_normal(
                (2, 3, 4)).astype(np.float32)},
                       "head": rng.standard_normal(5).astype(np.float32),
                       "emb": (rng.standard_normal((4, 3)) / 3).astype(
                           ml_dtypes.bfloat16)},
            "ids": np.arange(6, dtype=np.int64).reshape(2, 3),
            "mask": np.array([True, False, True]),
            "step": np.asarray(7, np.int32), "bad": np.asarray(0, np.int32)}


def _as_torch(tree):
    """The same tree as torch tensors (bf16 through its bits)."""
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(tree.copy())


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _bits(x) -> np.ndarray:
    """A leaf's dtype name, shape and raw bytes, comparable across numpy
    and torch."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).split(".")[1]
        raw = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x)
        return name, tuple(x.shape), raw.numpy().tobytes()
    return str(x.dtype), tuple(x.shape), np.ascontiguousarray(x).tobytes()


def _assert_same_tree(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(la) == sorted(lb)
    for k in la:
        assert _bits(la[k]) == _bits(lb[k]), k


def _dir_bytes(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            with open(os.path.join(root, f), "rb") as fh:
                out[os.path.relpath(os.path.join(root, f), d)] = fh.read()
    return out


# --------------------------------------------------- the format, shared

@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_port_and_reference_write_identical_bytes(tmp_path, leaves):
    tree = _tree()
    JCheckpointer(str(tmp_path / "ref"), codec="zlib").save(
        7, tree, blocking=True, extra=EXTRA)
    Checkpointer(str(tmp_path / "port"), codec="zlib").save(
        7, tree if leaves == "numpy" else _as_torch(tree), blocking=True,
        extra=EXTRA)
    ref, port = _dir_bytes(tmp_path / "ref"), _dir_bytes(tmp_path / "port")
    assert sorted(ref) == sorted(port)
    assert "step_00000007/COMMITTED" in port
    for name in ref:
        assert port[name] == ref[name], name
    manifest = json.loads(port["step_00000007/manifest.json"])
    assert manifest["leaves"]["params/emb"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["step"] == {
        "file": manifest["leaves"]["step"]["file"], "shape": [],
        "dtype": "int32", "crc32": manifest["leaves"]["step"]["crc32"]}


@pytest.mark.parametrize("device", [None, "cpu"])
def test_port_restores_reference_checkpoint_bitwise(tmp_path, device):
    tree = _tree()
    JCheckpointer(str(tmp_path), codec="zlib").save(3, tree, blocking=True,
                                                    extra=EXTRA)
    ck = Checkpointer(str(tmp_path))
    got = ck.restore(3, device=device)
    _assert_same_tree(got, tree)
    if device is not None:
        assert got["params"]["emb"].dtype == torch.bfloat16
        assert got["step"].shape == () and got["step"].dtype == torch.int32
    assert ck.load_extra(3) == EXTRA
    assert ck.verify(3) == []


def test_reference_restores_port_checkpoint_bitwise(tmp_path):
    tree = _tree()
    Checkpointer(str(tmp_path), codec="zlib").save(
        3, _as_torch(tree), blocking=True, extra=EXTRA)
    got = jax.tree.map(np.asarray, JCheckpointer(str(tmp_path)).restore(3))
    _assert_same_tree(got, tree)
    assert got["params"]["emb"].dtype == np.dtype(ml_dtypes.bfloat16)
    assert got["bad"].shape == () and got["bad"].dtype == np.int32
    assert JCheckpointer(str(tmp_path)).load_extra(3) == EXTRA


# ------------------------------------- the reference's tests, ported

def test_gc_keeps_newest_generations_and_commits_atomically(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        ck.save(step, {"x": torch.full((4,), float(step))}, blocking=True)
    assert ck.all_steps() == [3, 4]
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp-")]
    np.testing.assert_array_equal(ck.restore(4)["x"], np.full(4, 4.0))


def test_discovery_skips_uncommitted_generation(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(2, {"w": np.zeros(4, np.float32)}, blocking=True)
    ck.save(4, {"w": np.ones(4, np.float32)}, blocking=True)
    torn = tmp_path / "step_00000006"   # a write that never committed
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert ck.all_steps() == [2, 4]
    assert ck.generations() == [4, 2]
    assert ck.latest_step() == 4
    assert ck.restore_latest_verified()[1] == 4
    assert ck.verify(6) == ["step 6: missing COMMITTED marker"]


def test_checksums_verify_and_corruption_names_the_leaf(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(2, {"w": torch.arange(64, dtype=torch.float32),
                "b": torch.ones(5, dtype=torch.int32)}, blocking=True)
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        manifest = json.load(f)
    assert all("crc32" in m for m in manifest["leaves"].values())
    assert ck.verify(2) == []
    fn, off = ck.corrupt(2, seed=0)
    assert fn.startswith("leaf_") and off >= 0
    issues = ck.verify(2)
    assert len(issues) == 1 and fn in issues[0]
    with pytest.raises(CheckpointCorrupt, match=fn):
        ck.restore(2)
    # discovery still trusts the directory (marker intact): only
    # verification catches the damage
    assert ck.all_steps() == [2]


def test_restore_latest_verified_falls_back_a_generation(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(2, {"w": np.full(8, 2.0, np.float32)}, blocking=True)
    ck.save(4, {"w": np.full(8, 4.0, np.float32)}, blocking=True)
    ck.corrupt(4, seed=1)
    with pytest.warns(RuntimeWarning, match="step 4 failed verification"):
        tree, step = ck.restore_latest_verified(device="cpu")
    assert step == 2
    assert torch.equal(tree["w"], torch.full((8,), 2.0))
    ck.corrupt(2, seed=1)   # every generation corrupt: the re-init rung
    with pytest.warns(RuntimeWarning, match="failed verification"):
        assert ck.restore_latest_verified() is None


def test_extra_round_trips_and_defaults_to_none(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.ones(2)}, blocking=True, extra=EXTRA)
    ck.save(2, {"x": torch.ones(2)}, blocking=True)
    assert ck.load_extra(1) == EXTRA
    assert ck.load_extra(2) is None


def test_unknown_codec_rejected(tmp_path):
    with pytest.raises(ValueError, match="codec"):
        Checkpointer(str(tmp_path), codec="lz9")


def _codec_roundtrip(tmp_path, codec):
    ck = Checkpointer(str(tmp_path / codec), codec=codec)
    tree = {"w": torch.arange(24.0).reshape(4, 6),
            "n": {"b": torch.ones(3, dtype=torch.bfloat16) / 3},
            "step": torch.tensor(3, dtype=torch.int32)}
    ck.save(3, tree, blocking=True)
    with open(tmp_path / codec / "step_00000003" / "manifest.json") as f:
        assert json.load(f)["codec"] == codec
    _assert_same_tree(ck.restore(3, device="cpu"), tree)


def test_codec_zlib_roundtrip(tmp_path):
    _codec_roundtrip(tmp_path, "zlib")


@pytest.mark.optional_dep("zstandard")
def test_codec_zstd_roundtrip(tmp_path):
    _codec_roundtrip(tmp_path, "zstd")


def test_async_save_restores_the_bytes_of_the_save(tmp_path):
    """An update in place right after ``save`` returns (the optimizer's
    next step) must not reach the checkpoint: the snapshot is a copy,
    taken before the background write starts."""
    w = torch.randn(1 << 21, generator=torch.Generator().manual_seed(0))
    want = w.clone()
    ck = Checkpointer(str(tmp_path), codec="zlib")
    ck.save(1, {"w": w})
    w.add_(1.0)
    ck.wait()
    got = ck.restore(1, device="cpu")["w"]
    assert torch.equal(got, want) and not torch.equal(got, w)
    assert ck.verify(1) == []


def test_failed_async_write_raises_at_wait(tmp_path):
    ck = Checkpointer(str(tmp_path), codec="zlib")
    ck.save(1, {"w": torch.zeros(2, dtype=torch.complex64)})
    with pytest.raises(ValueError, match="no checkpoint dtype"):
        ck.wait()
    assert ck.all_steps() == []


# ----------------------------------------------------- parameter trees

@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_jax_inverts_params_from_jax(arch):
    tree = jax.tree.map(lambda x: np.array(x, copy=True),
                        build(jsmoke(arch)).init(jax.random.PRNGKey(0)))
    back = params_to_jax(params_from_jax(tree))
    la, lb = dict(_leaves(tree)), dict(_leaves(back))
    assert sorted(la) == sorted(lb)
    for k, v in la.items():
        assert lb[k].dtype == torch.float32 and v.dtype == np.float32, k
        np.testing.assert_array_equal(lb[k].numpy(), v, err_msg=k)


def test_adamw_state_dict_loads_into_the_same_tensors():
    params = [torch.zeros(3), torch.zeros(2, 2)]
    opt = AdamW(params, lr=1e-2)
    m0 = opt.m[1]
    opt.load_state_dict({"m": [torch.ones(3), torch.full((2, 2), 2.0)],
                         "v": [torch.ones(3), torch.ones(2, 2)], "step": 5})
    assert opt.m[1] is m0 and torch.equal(m0, torch.full((2, 2), 2.0))
    sd = opt.state_dict()
    assert sd["step"] == 5 and sd["m"][1] is m0
    with pytest.raises(ValueError, match="shape"):
        opt.load_state_dict({"m": [torch.ones(3), torch.ones(4)],
                             "v": [torch.ones(3), torch.ones(2, 2)],
                             "step": 1})


def test_adamw_midway_hook_sees_half_the_parameters_updated():
    params = [torch.zeros(2) for _ in range(4)]
    opt = AdamW(params, lr=0.1, weight_decay=0.0)
    seen = []
    opt.update([torch.ones(2)] * 4, midway=lambda: seen.append(
        [bool((p != 0).all()) for p in params]))
    assert seen == [[True, True, False, False]]
    assert all(bool((p != 0).all()) for p in params)


# ---------------------------------------------------------------- CLI

@pytest.mark.parametrize("argv", [
    ["--arch", "gt", "--smoke", "--task", "graph", "--graphs", "8",
     "--batch-graphs", "4"],
    ["--arch", "gt", "--smoke", "--task", "link", "--graph-nodes", "96"],
    ["--arch", "smollm_135m", "--smoke", "--seq", "32", "--batch", "2"]],
    ids=["graph", "link", "lm"])
def test_train_cli_resumes_from_ckpt_dir(capsys, tmp_path, argv):
    common = [*argv, "--device", "cpu", "--ckpt-dir", str(tmp_path),
              "--ckpt-every", "2"]
    first = train_cli.main([*common, "--steps", "2"])
    assert "resumed_at=0" in capsys.readouterr().out
    assert Checkpointer(str(tmp_path)).all_steps() == [2]
    second = train_cli.main([*common, "--steps", "4"])
    out = capsys.readouterr().out
    assert "resumed_at=2" in out and "status=done" in out
    assert [h["step"] for h in second.history] == [3, 4]
    assert len(first.history) == 2
    assert Checkpointer(str(tmp_path)).all_steps() == [2, 4]
    train_cli.main([*common, "--steps", "4"])
    assert "status=done (already at step 4)" in capsys.readouterr().out


def test_train_cli_fault_plan_prints_the_skipped_step(capsys, tmp_path):
    tr = train_cli.main(["--arch", "gt", "--smoke", "--task", "graph",
                         "--graphs", "8", "--batch-graphs", "4", "--steps",
                         "4", "--device", "cpu", "--fault-plan",
                         "nonfinite@2"])
    out = capsys.readouterr().out
    assert "skipped_steps=[3]" in out and "status=done" in out
    assert "'kind': 'nonfinite', 'step': 2" in out
    assert [h["skipped"] for h in tr.history] == [0, 0, 1, 0]
