"""AdamW's reduced-precision moments on the port (``optim/adamw.py``'s
``state_dtype``: float32, bfloat16, blockwise int8) against the JAX
package's ``AdamW``, on the CPU: the update over 5 steps on a tree whose
stacked leaves do not fill whole 256-blocks a layer (so an int8 block
straddles two layers, as in the reference, which quantizes a stacked leaf
whole), also in slices of one block; the trainer's state tree in the
reference optimizer's layout; checkpoints with bf16 and int8 moments
across the two packages, both ways; the re-init rung; the CLIs.

Tolerances: parameters within 1e-6 relative of the reference's, with
the 1e-7 absolute floor of ``test_torch_train.py``'s AdamW test for the
entries near zero (the port reads the bias corrections in float64, the
reference in fp32); fp32 moments within 1e-6 of their leaf's largest
entry (the fp32 update adds in place, as before this slice); bf16
moments equal; int8 moments equal but for at most INT8_OFF_SHARE of the
``q`` entries, each one quantization step apart, and as many ``s``
entries within 1e-6 relative (the fp32 arithmetic before the rounding
may fuse differently under XLA). Across packages, a trainer step resumed
from the other package's checkpoint: parameters within 1e-4 (the
cross-package resume of ``test_torch_resilience.py``); with int8
moments, but for at most INT8_OFF_SHARE of a leaf's entries, each one
whose second moment dequantizes to 0: there the update divides the
first moment by ``eps`` = 1e-8, which magnifies the steps' fp32
gradient differences 1e8-fold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.ckpt.checkpoint import Checkpointer as JCheckpointer
from repro.data.lm_pipeline import LMDataConfig as JLMDataConfig
from repro.data.lm_pipeline import lm_batch as jax_lm_batch
from repro.models import build
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import warmup_cosine as jwarmup_cosine
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (leaf_groups, lookup, params_from_jax,
                                 params_to_jax)
from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch
from repro_torch.launch import train as train_cli
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.adamw import AdamW, quantize8, warmup_cosine
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.tasks import BatchFnTask

TOL_PARAM = 1e-6
TOL_PARAM_ABS = 1e-7
INT8_OFF_SHARE = 0.01
DTYPES = ("float32", "bfloat16", "int8")

# (layers, per-layer shape): 37, 100 and 300 are no multiple of 256
SHAPES = {"embed.tok": ((), (7, 30)), "layers.n": ((3,), (37,)),
          "layers.w": ((3,), (10, 10)), "layers.big": ((2,), (300,)),
          "final": ((), (300,))}


def _tree(rng, scale=1.0):
    """A reference tree of SHAPES, and the port's names in order."""
    tree, names = {}, []
    for leaf, (lead, shape) in SHAPES.items():
        arr = (rng.standard_normal(lead + shape) * scale).astype(np.float32)
        top, rest = leaf.split(".", 1) if "." in leaf else (leaf, None)
        if rest is None:
            tree[top] = arr
        else:
            tree.setdefault(top, {})[rest] = arr
    for leaf, (lead, _) in SHAPES.items():
        if lead:
            top, rest = leaf.split(".", 1)
            names += [f"{top}.{i}.{rest}" for i in range(lead[0])]
        else:
            names.append(leaf)
    return tree, names


def _assert_int8_close(mine, ref, what, s_rtol=None):
    """q within one step and equal but for INT8_OFF_SHARE of its
    entries; s as many entries apart, within 1e-6 relative, or, from
    gradients that differ (``s_rtol``), every entry within ``s_rtol``."""
    q, rq = mine["q"].numpy().astype(int), np.asarray(ref["q"]).astype(int)
    s, rs = mine["s"].numpy(), np.asarray(ref["s"])
    assert q.shape == rq.shape and s.shape == rs.shape, what
    assert np.abs(q - rq).max() <= 1, what
    assert (q != rq).mean() <= INT8_OFF_SHARE, what
    if s_rtol is None:
        assert (s != rs).mean() <= INT8_OFF_SHARE, what
    np.testing.assert_allclose(s, rs, rtol=s_rtol or 1e-6, atol=0,
                               err_msg=what)


@pytest.mark.parametrize("slice_", [None, 256], ids=["whole", "one_block"])
@pytest.mark.parametrize("state_dtype", DTYPES)
def test_adamw_matches_reference(state_dtype, slice_, monkeypatch):
    """Five steps from the same parameters and gradients: parameters,
    and the moments as the reference holds them (per leaf, the stacked
    ones whole). ``one_block`` works through every leaf a block at a
    time: the slices straddle the layers."""
    if slice_:
        monkeypatch.setattr(tadamw, "SLICE", slice_)
    rng = np.random.default_rng(0)
    tree, names = _tree(rng)
    state = params_from_jax(tree)
    params = [state[n].clone() for n in names]
    groups = leaf_groups(names)
    opt = AdamW(params, lr=warmup_cosine(1e-2, 2, 10), weight_decay=0.1,
                state_dtype=state_dtype, groups=[g for _, g in groups])
    jopt = JAdamW(lr=jwarmup_cosine(1e-2, 2, 10), weight_decay=0.1,
                  state_dtype=state_dtype)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    for step in range(5):
        grads, _ = _tree(rng, scale=1.0 + step)
        jparams, jstate = jopt.update(jax.tree.map(jnp.asarray, grads),
                                      jstate, jparams)
        got = params_from_jax(grads)
        opt.update([got[n] for n in names])
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    for n, p in zip(names, params):
        np.testing.assert_allclose(p.numpy(), want[n].numpy(),
                                   rtol=TOL_PARAM, atol=TOL_PARAM_ABS,
                                   err_msg=n)
    for key in ("m", "v"):
        ref = jstate[key]
        mine = getattr(opt, key)
        if state_dtype == "int8":
            assert len(mine) == len(groups)
            for (leaf, _), qs in zip(groups, mine):
                _assert_int8_close(qs, lookup(ref, leaf), f"{key} {leaf}")
        else:
            tree_m = params_to_jax(dict(zip(names, mine)))
            for leaf, _ in groups:
                a, b = lookup(tree_m, leaf), lookup(ref, leaf)
                assert str(a.dtype).endswith(state_dtype), leaf
                assert a.shape == b.shape, leaf
                a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
                if state_dtype == "bfloat16":
                    np.testing.assert_array_equal(a, b, err_msg=leaf)
                else:   # the fp32 update, in place as before this slice
                    assert np.abs(a - b).max() <= \
                        TOL_PARAM * np.abs(b).max(), f"{key} {leaf}"
    assert opt.step == int(jstate["step"]) == 5


def test_per_layer_quantization_is_not_the_references():
    """The trap the test tree sets: quantizing each layer of a stacked
    leaf on its own gives other blocks and scales than the reference's
    whole-leaf quantization, which the port's groups reproduce."""
    x = np.random.default_rng(1).standard_normal((3, 37)).astype(np.float32)
    whole = quantize8(torch.from_numpy(x.reshape(-1)))
    per_layer = [quantize8(torch.from_numpy(row)) for row in x]
    assert whole[0].shape == (1, 256)
    assert torch.cat([q for q, _ in per_layer]).shape == (3, 256)
    deq_whole = (whole[0].float() * whole[1]).view(-1)[:111].view(3, 37)
    deq_layer = torch.stack([(q.float() * s).view(-1)[:37]
                             for q, s in per_layer])
    assert not torch.equal(deq_whole, deq_layer)


def test_zero_moments_quantize_to_zero():
    q, s = quantize8(torch.zeros(300))
    assert q.shape == (2, 256) and not q.any() and not s.any()
    assert q.dtype == torch.int8 and s.dtype == torch.float32


def test_midway_falls_before_the_group_holding_the_middle_parameter():
    """With groups, the preempt hook fires once, before the group that
    holds parameter len // 2; the groups before it are written, the
    others are not."""
    params = [torch.zeros(2) for _ in range(6)]
    # groups by first index: [0], [1, 4], [2, 5], [3]; param 3 is the middle
    opt = AdamW(params, lr=0.1, weight_decay=0.0, state_dtype="bfloat16",
                groups=[[2, 5], [0], [3], [1, 4]])
    seen = []
    opt.update([torch.ones(2)] * 6, midway=lambda: seen.append(
        [bool((p != 0).all()) for p in params]))
    assert seen == [[True, True, True, False, True, True]]


def test_unknown_state_dtype_raises_in_the_trainer():
    model = tlm.LMModel(_cfg(), device="cpu")
    with pytest.raises(ValueError, match="state_dtype"):
        Trainer(model, TrainerConfig(state_dtype="fp8"),
                task=BatchFnTask(lambda s: None))


# ----------------------------------------------------- the trainer state

def _cfg(port=True):
    get = get_smoke_config if port else jcfgs.get_smoke_config
    return get("qwen3_0_6b").replace(dtype="float32")


def _init_tree():
    return jax.tree.map(lambda x: np.array(x, copy=True),
                        build(_cfg(False)).init(jax.random.PRNGKey(0)))


def _port_trainer(state_dtype, **kw):
    model = tlm.LMModel(_cfg(), device="cpu")
    model.load_state_dict(params_from_jax(_init_tree()))
    dc = LMDataConfig(model.cfg.vocab_size, 32, 2, seed=5)
    return Trainer(model, TrainerConfig(steps=3, lr=1e-2, warmup=1,
                                        state_dtype=state_dtype, **kw),
                   task=BatchFnTask(lambda s: lm_batch(dc, s)))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _layout(tree) -> dict:
    """path -> (shape, dtype name) of every leaf."""
    out = {}
    for k, v in _leaves(tree):
        dt = v.dtype if not torch.is_tensor(v) else \
            str(v.dtype).split(".")[1]
        out[k] = (tuple(v.shape), str(dt))
    return out


@pytest.mark.parametrize("state_dtype", ["bfloat16", "int8"])
def test_port_checkpoint_restores_as_the_references(state_dtype, tmp_path):
    """A port run's checkpoint, restored by the reference's
    ``Checkpointer``: the reference ``AdamW``'s state tree (leaf names,
    shapes and dtypes, ``m/.../q`` int8 and ``m/.../s`` fp32 for int8),
    holding the port's values."""
    tr = _port_trainer(state_dtype, ckpt_dir=str(tmp_path), ckpt_every=100)
    assert tr.run() == "done"
    mine = tr.state_tree()
    got = JCheckpointer(str(tmp_path)).restore(3)
    want = JAdamW(lr=1e-2, state_dtype=state_dtype).init(
        jax.tree.map(jnp.asarray, _init_tree()))
    assert _layout(got["opt"]) == _layout({**want, "step": np.int32(0)})
    if state_dtype == "int8":
        q = got["opt"]["m"]["layers"]["attn"]["wq"]
        assert q["q"].dtype == np.int8 and q["s"].dtype == np.float32
    for (k, a), (_, b) in zip(_leaves(got["opt"]), _leaves(mine["opt"])):
        b = np.asarray(b) if not torch.is_tensor(b) else b.float().numpy()
        np.testing.assert_array_equal(np.asarray(a, np.float32), b,
                                      err_msg=k)


@pytest.mark.parametrize("state_dtype", ["bfloat16", "int8"])
def test_reference_checkpoint_resumes_in_the_port(state_dtype, tmp_path):
    """The reference trainer runs 3 steps, checkpointing at 2; the port's
    trainer resumes from that generation alone and takes step 3: its
    parameters agree with the reference's third step, its moments with
    the reference's (bf16 within 1e-2, the step's gradients being
    another package's; int8 ``q`` as ``test_adamw_matches_reference``
    holds it, ``s`` within 1e-4)."""
    import shutil

    jdc = JLMDataConfig(_cfg().vocab_size, 32, 2, seed=5)
    jtr = JTrainer(build(_cfg(False)), JTrainerConfig(
        steps=3, lr=1e-2, warmup=1, ckpt_dir=str(tmp_path / "ref"),
        ckpt_every=2, attn_impl="ref", state_dtype=state_dtype),
        lambda s: jax_lm_batch(jdc, s))
    jstate, status = jtr.run()
    assert status == "done"
    JCheckpointer(str(tmp_path / "ref")).wait()
    shutil.copytree(tmp_path / "ref" / "step_00000002",
                    tmp_path / "port" / "step_00000002")
    tr = _port_trainer(state_dtype, ckpt_dir=str(tmp_path / "port"),
                       ckpt_every=100)
    assert tr.run() == "done"
    assert [h["step"] for h in tr.history] == [3]
    want = params_from_jax(jax.tree.map(np.asarray, jstate["params"]))
    mine = tr.state_tree()["opt"]
    for leaf, idx in tr.leaves:
        got = torch.cat([tr.params[i].detach().reshape(-1) for i in idx])
        ref = torch.cat([want[tr.names[i]].reshape(-1) for i in idx])
        off = (got - ref).abs() > 1e-4
        if state_dtype == "int8":
            v = lookup(mine["v"], leaf)
            v0 = (v["q"].float() * v["s"]).view(-1)[:got.numel()] == 0
            assert not (off & ~v0).any(), leaf
            assert off.float().mean() <= INT8_OFF_SHARE, leaf
        else:
            assert not off.any(), leaf
    for key in ("m", "v"):
        for leaf, _ in tr.leaves:
            a, b = lookup(mine[key], leaf), lookup(jstate["opt"][key], leaf)
            if state_dtype == "int8":
                _assert_int8_close(a, b, f"{key} {leaf}", s_rtol=1e-4)
            else:
                assert a.dtype == torch.bfloat16
                np.testing.assert_allclose(
                    a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                    rtol=1e-2, atol=1e-6, err_msg=f"{key} {leaf}")


def test_reinit_zeroes_moments_in_their_layout():
    tr = _port_trainer("int8")
    tr.restore_or_init()
    tr.step("sparse", tr.task.batches(0))
    assert any(t.any() for t in tr.opt.state_tensors())
    shapes = [tuple(t.shape) for t in tr.opt.state_tensors()]
    tr._reinit()
    assert not any(t.any() for t in tr.opt.state_tensors())
    assert [tuple(t.shape) for t in tr.opt.state_tensors()] == shapes
    assert tr.opt.step == 0 and tr.steps_done == 0


# ---------------------------------------------------------------- CLIs

@pytest.mark.parametrize("argv", [
    ["--arch", "qwen3_0_6b", "--seq", "32", "--batch", "2"],
    ["--arch", "gt", "--task", "graph", "--graphs", "8",
     "--batch-graphs", "4"]], ids=["lm", "graph"])
def test_train_cli_takes_int8_moments(argv, capsys):
    tr = train_cli.main(argv + ["--smoke", "--steps", "3", "--device", "cpu",
                                "--state-dtype", "int8"])
    assert "status=done" in capsys.readouterr().out
    assert tr.opt.state_dtype == "int8"
    assert all(isinstance(m, dict) for m in tr.opt.m)
