"""Layer recomputation (``cfg.remat``) on the port against the JAX
package, on the CPU, for the three families that read it: the dense LM
(``lm_loss``), the graph model (``graph_loss``, sparse and dense) and the
SSM LM (``ssm_lm_loss``); the Mamba2 block the SSM LM is built of; and
the train CLI on the three archs that need recomputation to fit a card.

Tolerances (fp32): against the reference, losses within 1e-5 relative
and every parameter gradient within 1e-4 of the largest entry of its JAX
counterpart (the two frameworks sum in other orders), as in
``test_torch_lm.py``; the Mamba2 block's output and final state within
1e-5. Within the port, ``"block"`` and ``"dots"`` recompute the same
arithmetic as ``"none"``, so their losses and gradients are held bitwise
equal to it.
"""

import functools
import warnings
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import repro.configs as jcfgs
from repro.core import graph_model as jgm
from repro.core.graph import sbm_graph as jax_sbm
from repro.data.graph_pipeline import prepare_node_task as jax_prepare
from repro.models import api as japi
from repro.models import build
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.nn import param as nnp
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import graph_model as tgm
from repro_torch.core.graph import sbm_graph
from repro_torch.data.graph_pipeline import prepare_node_task
from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch
from repro_torch.kernels import ref as kref
from repro_torch.launch import train as train_cli
from repro_torch.models import api as tapi
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm

from _torch_cases import t

REMATS = ("none", "block", "dots")
# family -> the arch of its smoke config
FAMILIES = {"lm": "qwen3_0_6b", "graph": "graphormer_slim",
            "graph_dense": "graphormer_slim", "ssm": "mamba2_2_7b"}
LM_SEQ = 256          # the cluster-sparse branch's shortest sequence
SSM_SEQ = 64          # two chunks of the smoke config's 32


def _cfgs(family, remat):
    """The port's and the reference's smoke config, fp32, with ``remat``;
    the LM on its cluster-sparse backend (the published configs run
    dense attention)."""
    kw = {"dtype": "float32", "remat": remat}
    if family == "lm":
        kw["attn_backend"] = "cluster_sparse"
    arch = FAMILIES[family]
    return (get_smoke_config(arch).replace(**kw),
            jcfgs.get_smoke_config(arch).replace(**kw))


@functools.lru_cache(maxsize=None)
def _jax_tree(arch, seed=0):
    """The reference's init of ``arch``'s smoke config, shared by the
    cases (nothing writes to it)."""
    tree = jax.tree.map(lambda x: np.array(x, copy=True),
                        build(jcfgs.get_smoke_config(arch)).init(
                            jax.random.PRNGKey(seed)))
    if "bias_table" in tree:   # a nonzero table, so its gradient matters
        tree["bias_table"] = (np.random.default_rng(seed).standard_normal(
            tree["bias_table"].shape) * 0.5).astype(np.float32)
    return tree


def _model(family, cfg, tree=None):
    cls = {"lm": tlm.LMModel, "ssm": tapi.SSMLMModel}.get(family,
                                                          tgm.GraphModel)
    model = cls(cfg, device="cpu")
    if tree is not None:
        model.load_state_dict(params_from_jax(tree), strict=True)
    return model


def _host_batch(family, cfg):
    """Seeded numpy batch of the family's loss."""
    if family in ("lm", "ssm"):
        S = LM_SEQ if family == "lm" else SSM_SEQ
        return lm_batch(LMDataConfig(cfg.vocab_size, S, 2, seed=1), 0)
    g = sbm_graph(120, 4, 0.08, 0.004, feat_dim=cfg.feat_dim,
                  n_classes=cfg.n_classes, seed=2)
    return prepare_node_task(
        g, cfg, bq=32, bk=32, d_b=8, with_dense_buckets=True,
        train_mask=np.random.default_rng(0).random(g.n) < 0.5).batch


def _jax_batch(family, cfg):
    if family in ("lm", "ssm"):
        return _host_batch(family, cfg)
    jg = jax_sbm(120, 4, 0.08, 0.004, feat_dim=cfg.feat_dim,
                 n_classes=cfg.n_classes, seed=2)
    return jax_prepare(
        jg, cfg, bq=32, bk=32, d_b=8, with_dense_buckets=True,
        train_mask=np.random.default_rng(0).random(jg.n) < 0.5).batch


def _port_batch(family, cfg):
    host = _host_batch(family, cfg)
    if family in ("lm", "ssm"):
        return {k: t(v).long() for k, v in host.items()}
    return tgm.batch_to_torch(host, "cpu")


def _port_loss(family, model, batch):
    if family == "lm":
        return tlm.lm_loss(model, batch)[0]
    if family == "ssm":
        return tapi.ssm_lm_loss(model, batch)[0]
    variant = "dense" if family == "graph_dense" else "sparse"
    return model.loss_variants[variant](model, batch)[0]


def _jax_loss(family, jcfg):
    if family == "lm":
        return lambda p, b: jlm.lm_loss(p, jcfg, b)[0]
    if family == "ssm":
        return lambda p, b: japi.ssm_lm_loss(p, jcfg, b)[0]
    if family == "graph_dense":
        return lambda p, b: jgm.graph_loss_dense(p, jcfg, b)[0]
    return lambda p, b: jgm.graph_loss(p, jcfg, b, dense=False)[0]


def _loss_grads(family, model, batch):
    loss = _port_loss(family, model, batch)
    return loss.detach(), torch.autograd.grad(loss,
                                              list(model.parameters()))


# ------------------------------------------------------ against the JAX

@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_jax(family, remat):
    """The reference's loss under ``remat`` beside the port's under the
    same setting, on the same numpy batch and parameters."""
    cfg, jcfg = _cfgs(family, remat)
    tree = _jax_tree(FAMILIES[family])
    jb = {k: jnp.asarray(v) for k, v in _jax_batch(family, jcfg).items()}
    lval, jgrads = jax.jit(jax.value_and_grad(_jax_loss(family, jcfg)))(
        tree, jb)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    model = _model(family, cfg, tree)
    loss, grads = _loss_grads(family, model, _port_batch(family, cfg))
    np.testing.assert_allclose(loss.item(), float(lval), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-6), (name, err)


# ------------------------------------------------------ within the port

@pytest.mark.parametrize("remat", ["block", "dots"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_recomputation_is_bitwise_equal_to_none(family, remat):
    """The recomputed backward gives the loss and every gradient of the
    backward that kept its activations, bit for bit."""
    cfg, _ = _cfgs(family, "none")
    model = _model(family, cfg)
    batch = _port_batch(family, cfg)
    loss, grads = _loss_grads(family, model, batch)
    model.cfg = cfg.replace(remat=remat)
    loss_r, grads_r = _loss_grads(family, model, batch)
    assert torch.equal(loss, loss_r)
    for name, a, b in zip([n for n, _ in model.named_parameters()], grads,
                          grads_r):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("family", ["lm", "graph"])
def test_attention_forward_runs_twice_under_recomputation(family, remat,
                                                          monkeypatch):
    """On the CPU the op's forward and backward are the plain versions,
    so counting them counts what the kernels would launch on the card:
    the forward once a layer, and once more in the backward under
    ``"block"`` and ``"dots"`` (neither keeps the op's output); the
    backward once a layer."""
    calls = {"fwd": 0, "bwd": 0}

    def counted(kind, fn):
        def spy(*args, **kw):
            calls[kind] += 1
            return fn(*args, **kw)
        return spy
    monkeypatch.setattr(kref, "cluster_sparse_attention", counted(
        "fwd", kref.cluster_sparse_attention))
    monkeypatch.setattr(kref, "cluster_attention_bwd", counted(
        "bwd", kref.cluster_attention_bwd))
    cfg, _ = _cfgs(family, remat)
    model = _model(family, cfg)
    _loss_grads(family, model, _port_batch(family, cfg))
    n = cfg.n_layers
    assert calls == {"fwd": n if remat == "none" else 2 * n, "bwd": n}


class _Retained(TorchDispatchMode):
    """Weak references to the storage of every op's output: what is still
    alive after the forward is what the backward keeps."""

    def __init__(self):
        super().__init__()
        self.refs = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in tree_leaves(out):
            if isinstance(x, torch.Tensor):
                s = x.untyped_storage()
                self.refs[id(s)] = (weakref.ref(s), s.nbytes())
        return out

    def alive_bytes(self) -> int:
        return sum(n for ref, n in self.refs.values() if ref() is not None)


@pytest.mark.parametrize("family", ["lm", "graph", "ssm"])
def test_recomputation_keeps_fewer_bytes(family):
    """Bytes autograd saves (``saved_tensors_hooks``; inside a checkpoint
    its own hooks take the layer's tensors over, so this sees what lies
    outside the layers) and bytes of op outputs still alive after the
    forward (what the backward keeps, the checkpoints' inputs and the
    ``"dots"`` policy's saved products included): ``"block"`` keeps
    strictly less than ``"none"``; ``"dots"`` lies strictly between for
    the LMs, and is ``"block"`` for the graph model (the reference has no
    policy there)."""
    cfg, _ = _cfgs(family, "none")
    model = _model(family, cfg)
    batch = _port_batch(family, cfg)
    saved, alive = {}, {}
    for remat in REMATS:
        model.cfg = cfg.replace(remat=remat)
        sizes = []

        def pack(x):
            sizes.append(x.numel() * x.element_size())
            return x
        mode = _Retained()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            with mode:
                loss = _port_loss(family, model, batch)
        saved[remat], alive[remat] = sum(sizes), mode.alive_bytes()
        loss.backward()
    assert saved["block"] < saved["none"] and saved["dots"] < saved["none"]
    if family == "graph":
        assert alive["block"] == alive["dots"] < alive["none"], alive
    else:
        assert alive["block"] < alive["dots"] < alive["none"], alive


@pytest.mark.parametrize("family", ["lm", "graph", "ssm"])
def test_no_checkpoint_without_grad(family, monkeypatch):
    """Serving and evaluation (grad disabled) enter no layer checkpoint
    and raise no warning, whatever ``cfg.remat`` says."""
    def refuse(*args, **kw):
        raise AssertionError("a layer checkpoint was entered")
    monkeypatch.setattr(tL, "checkpoint", refuse)
    for remat in REMATS:
        cfg, _ = _cfgs(family, remat)
        model = _model(family, cfg)
        batch = _port_batch(family, cfg)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with torch.no_grad():
                if family == "lm":
                    h, _ = tlm.lm_forward(model, batch)
                elif family == "ssm":
                    h = tapi.ssm_lm_forward(model, batch)
                else:
                    h = tgm.graph_forward(model, batch)
        assert torch.isfinite(h).all()
    with pytest.raises(AssertionError, match="checkpoint was entered"):
        _port_loss(family, model, batch)   # with grad: the layers' one


# ------------------------------------------------------ the Mamba2 block

def _mamba_params(cfg, seed=0):
    """One layer's Mamba2 parameters of the reference's init, with a
    nonzero ``a_log``, ``dt_bias`` and ``conv_b`` (their init is zeros)."""
    tree = _jax_tree("mamba2_2_7b", seed)
    p = {k: v[0] for k, v in tree["layers"]["mamba"].items()}
    rng = np.random.default_rng(seed)
    for k in ("a_log", "dt_bias", "conv_b"):
        p[k] = (rng.standard_normal(p[k].shape) * 0.3).astype(np.float32)
    return p


def test_mamba_block_matches_jax():
    """``_causal_conv``, ``_split_proj`` and ``mamba_apply`` (output and
    final state) against the reference at the smoke config, and the
    block's input gradient."""
    cfg, jcfg = _cfgs("ssm", "none")
    p = _mamba_params(cfg)
    block = tssm.Mamba(cfg, device="cpu")
    block.load_state_dict({k: t(v) for k, v in p.items()}, strict=True)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 24)).astype(np.float32)
    np.testing.assert_allclose(
        tssm._causal_conv(t(x), t(p["conv_w"][:, :24]),
                          t(p["conv_b"][:24])).numpy(),
        np.asarray(jssm._causal_conv(jnp.asarray(x),
                                     jnp.asarray(p["conv_w"][:, :24]),
                                     jnp.asarray(p["conv_b"][:24]))),
        atol=1e-5, rtol=1e-5)
    d_inner, H, dh, N = tssm.ssm_dims(cfg)
    assert (d_inner, H, dh, N) == jssm.ssm_dims(jcfg)
    z = rng.standard_normal((2, 8, 2 * d_inner + 2 * N + H)).astype(
        np.float32)
    for a, b in zip(tssm._split_proj(cfg, t(z)),
                    jssm._split_proj(jp, jcfg, jnp.asarray(z))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    h = rng.standard_normal((2, SSM_SEQ, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal(h.shape).astype(np.float32)

    def jfn(hh):
        out, final = jssm.mamba_apply(jp, jcfg, hh)
        return (out * g).sum(), (out, final)
    jgh, (want, want_final) = jax.jit(jax.grad(jfn, has_aux=True))(
        jnp.asarray(h))
    th = t(h).requires_grad_()
    out, final = tssm.mamba_apply(block, cfg, th)
    (out * t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(final.detach().numpy(),
                               np.asarray(want_final), atol=1e-5, rtol=1e-5)
    jgh = np.asarray(jgh)
    assert np.abs(th.grad.numpy() - jgh).max() <= 1e-4 * np.abs(jgh).max()


def test_ssm_lm_defs_match_the_reference():
    """Names, per-layer shapes and init families of the reference's
    ``ssm_lm_defs`` (the stacked layer axis removed; ``conv_w``'s normal
    of scale 0.1 given as its scale), at Mamba2-2.7B's size."""
    want = {}
    for path, d in nnp._walk(japi.ssm_lm_defs(
            jcfgs.get_config("mamba2_2_7b"))):
        shape = d.shape[1:] if path[0] == "layers" else d.shape
        init = d.scale if d.init == "normal" and d.scale != 0.02 else d.init
        want[".".join(path)] = (tuple(shape), init)
    assert tapi.ssm_lm_defs(get_config("mamba2_2_7b")) == want


def test_ssm_model_loads_the_jax_tree_and_decode_waits_for_a9():
    cfg, _ = _cfgs("ssm", "block")
    tree = _jax_tree("mamba2_2_7b")
    model = _model("ssm", cfg, tree)
    np.testing.assert_array_equal(
        model.layers[1].mamba.in_proj.detach().numpy(),
        tree["layers"]["mamba"]["in_proj"][1])
    assert list(model.loss_variants) == ["sparse"]
    # decode is ported (tests/test_torch_serve.py holds it to the
    # reference); the paged serving entries stay None, as the reference's
    assert (model.prefill_chunk, model.paged_decode,
            model.paged_cache_defs) == (None, None, None)
    cache = model.cache_defs(2, 16)["layers"]
    assert (cache["conv"].dtype, cache["ssm"].dtype) == (torch.bfloat16,
                                                         torch.float32)
    with pytest.raises(ValueError, match="SSMLMModel"):
        tlm.LMModel(cfg, device="cpu")
    conv = tapi.SSMLMModel(get_smoke_config("mamba2_2_7b"), device="cpu",
                           seed=4).layers[0].mamba.conv_w
    assert abs(conv.std().item() - 0.1) < 0.02


# ------------------------------------------------------ the launcher

NEW_ARCHS = ["qwen3_1_7b", "qwen3_4b", "mamba2_2_7b"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cli_trains_the_new_archs_on_cpu(arch, capsys):
    train_cli.main(["--arch", arch, "--smoke", "--steps", "3", "--seq", "64",
                    "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={get_smoke_config(arch).name}" in out
    assert "remat=block" in out and "status=done" in out
    assert "step    3 loss" in out
    assert ("attn_backend=ssm" in out) == (arch == "mamba2_2_7b")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cli_defaults_to_cuda(arch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--arch", arch, "--smoke", "--steps", "1", "--seq",
                        "64", "--batch", "1"])
