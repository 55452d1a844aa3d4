"""The port's LM training slice against the JAX package, on the CPU: the
local+global layout and the token stream byte for byte, the layers the
LM adds (RoPE, qk-norm, the projections, causal chunked attention, the
chunked cross-entropy), ``lm_loss`` and its parameter gradients through
the sparse and the dense attention branch, a short trainer run, the
parameter conversion and the CLI. Inputs are seeded numpy arrays (and one
parameter tree from the JAX init) given to both.

Tolerances (fp32): layers within 1e-5 (2e-5 for attention, whose sums
run in another order); losses within 1e-5 relative and every parameter
gradient within 1e-4 of the largest entry of its JAX counterpart; the
4-step loss trajectory within 1e-4 relative (rounding differences
compound over the updates). Layouts and batches: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core.reformation import \
    lm_local_global_layout as jax_lm_layout
from repro.data.lm_pipeline import LMDataConfig as JLMDataConfig
from repro.data.lm_pipeline import lm_batch as jax_lm_batch
from repro.models import build
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs import LM_ARCHS as ARCHS
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.reformation import lm_local_global_layout
from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import lm as tlm
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.tasks import BatchFnTask

from _torch_cases import t



def _cfgs(arch, **kw):
    """The port's and the reference's smoke config, fp32, cluster-sparse
    attention (the published configs run dense)."""
    kw = {"dtype": "float32", "attn_backend": "cluster_sparse", **kw}
    return (get_smoke_config(arch).replace(**kw),
            jcfgs.get_smoke_config(arch).replace(**kw))


def _jax_tree(jcfg, seed=0):
    return jax.tree.map(lambda x: np.array(x, copy=True),
                        build(jcfg).init(jax.random.PRNGKey(seed)))


def _port_model(cfg, tree):
    model = tlm.LMModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# ------------------------------------------------------------ host side

@pytest.mark.parametrize("S,window,n_global,bq", [
    (256, 64, 8, 128), (1000, 256, 128, 128), (2048, 512, 200, 128),
    (16384, 4096, 128, 128), (512, 4096, 0, 128), (256, 64, 32, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_layout_is_byte_identical(S, window, n_global, bq, causal):
    kw = dict(bq=bq, bk=bq, window=window, n_global=n_global, causal=causal)
    a = lm_local_global_layout(S, **kw)
    b = jax_lm_layout(S, **kw)
    assert (a.seq_len, a.bq, a.bk, a.buckets, a.n_buckets) == \
        (b.seq_len, b.bq, b.bk, b.buckets, b.n_buckets)
    for name in ("block_idx", "block_idx_t"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name
    assert a.stats == b.stats


def test_qwen3_layout_at_16k_has_the_expected_shape():
    """The slice's main-path layout: 128 q-blocks of 33 slots, 3696
    visited blocks, k-block 0 (the global block) visited by every row."""
    lay = lm_local_global_layout(16384, window=4096, n_global=128)
    assert lay.block_idx.shape == (128, 33)
    assert int((lay.block_idx >= 0).sum()) == 3696
    assert lay.block_idx_t.shape == (128, 128, 2)
    assert int((lay.block_idx_t[0, :, 0] >= 0).sum()) == 128


@pytest.mark.parametrize("vocab,S,B,seed", [
    (512, 64, 2, 0), (151936, 33, 3, 5), (49152, 128, 1, 2)])
def test_lm_batch_is_byte_identical(vocab, S, B, seed):
    for step in (0, 1, 7):
        a = lm_batch(LMDataConfig(vocab, S, B, seed=seed), step)
        b = jax_lm_batch(JLMDataConfig(vocab, S, B, seed=seed), step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for key in a:
            assert a[key].dtype == b[key].dtype and \
                a[key].tobytes() == b[key].tobytes(), key
    a = lm_batch(LMDataConfig(vocab, S, 4, seed=seed), 3, host_id=1,
                 n_hosts=2)
    b = jax_lm_batch(JLMDataConfig(vocab, S, 4, seed=seed), 3, host_id=1,
                     n_hosts=2)
    assert a["tokens"].tobytes() == b["tokens"].tobytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    for get, jget in ((get_config, jcfgs.get_config),
                      (get_smoke_config, jcfgs.get_smoke_config)):
        c, jc = get(arch), jget(arch)
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
        assert c.vocab_padded == jc.vocab_padded
    assert get_config("qwen3_0_6b").vocab_padded == 152064


# ------------------------------------------------------------ layers

@pytest.mark.parametrize("theta", [1_000_000.0, 10_000.0, 0.0])
@pytest.mark.parametrize("pos_2d", [False, True])
def test_rope_matches_jax(theta, pos_2d):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, 3, 32)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32) + 1000
    if pos_2d:
        pos = np.stack([pos, pos[::-1].copy()])
    want = np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = L.rope(t(x), t(pos), theta).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if theta:   # the precomputed rotation gives the same
        cs = L.rope_cos_sin(t(pos), 32, theta)
        assert torch.equal(L.rope(t(x), cs, theta), L.rope(t(x), t(pos),
                                                           theta))


def test_headnorm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32) * 3
    scale = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(JL.headnorm(jnp.asarray(scale), jnp.asarray(x)))
    np.testing.assert_allclose(L.headnorm(t(scale), t(x)).numpy(), want,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_project_qkv_matches_jax(arch):
    """qk-norm (Qwen3) or not (SmolLM), RoPE at the config's theta."""
    cfg, jcfg = _cfgs(arch)
    tree = _jax_tree(jcfg)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["attn"])
    model = _port_model(cfg, tree)
    x = np.random.default_rng(2).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    pos = np.arange(24, dtype=np.int32)
    want = JL.project_qkv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = L.project_qkv(model.layers[0].attn, cfg, t(x), t(pos))
    assert hasattr(model.layers[0].attn, "q_norm") == cfg.qk_norm
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S,cq,ck", [(80, 32, 16), (64, 64, 64),
                                     (100, 16, 48)])
def test_causal_chunked_attention_matches_jax(S, cq, ck):
    """Ragged chunks, GQA 6 over 2 heads; output and gradients."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, S, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    g = rng.standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        o = JL.chunked_attention(q, k, v, causal=True, chunk_q=cq,
                                 chunk_k=ck)
        return (o * g).sum(), o
    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    o = L.chunked_attention(*leaves, causal=True, chunk_q=cq, chunk_k=ck)
    (o * t(g)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    for x, w in zip(leaves, jgrads):
        assert _rel(x.grad.numpy(), np.asarray(w)) <= 1e-4


@pytest.mark.parametrize("tied", [True, False])
def test_embed_and_logits_match_jax(tied):
    """The token embedding and the (tied or separate) unembedding."""
    cfg, jcfg = _cfgs("smollm_135m", tie_embeddings=tied)
    tree = _jax_tree(jcfg)
    model = _port_model(cfg, tree)
    jemb = jax.tree.map(jnp.asarray, tree["embed"])
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 9))
    want = JL.embed_tokens(jemb, jcfg, jnp.asarray(tokens), jnp.float32)
    got = L.embed_tokens(model.embed, t(tokens).long(), torch.float32)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    h = np.random.default_rng(6).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    want = JL.logits_fn(jemb, jcfg, jnp.asarray(h))
    got = L.logits_fn(model.embed, cfg, t(h))
    assert got.shape == (2, 9, cfg.vocab_padded)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("tied", [True, False])
def test_chunked_softmax_xent_matches_jax(tied):
    """A vocab padded from 500 to 512 (the padding masked), -1 labels
    ignored, chunks that do not divide S; the loss and its gradients in
    h and the embedding."""
    cfg, jcfg = _cfgs("smollm_135m", vocab_size=500, tie_embeddings=tied)
    assert cfg.vocab_padded == 512
    tree = _jax_tree(jcfg)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 50, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, 500, (2, 50)).astype(np.int32)
    labels[0, :7] = -1
    labels[1, 40:] = -1
    jemb = jax.tree.map(jnp.asarray, tree["embed"])
    jval, (jgh, jge) = jax.value_and_grad(
        lambda hh, e: JL.chunked_softmax_xent(e, jcfg, hh,
                                              jnp.asarray(labels),
                                              chunk=16),
        argnums=(0, 1))(jnp.asarray(h), jemb)
    model = _port_model(cfg, tree)
    th = t(h).requires_grad_()
    loss = L.chunked_softmax_xent(model.embed, cfg, th, t(labels).long(),
                                  chunk=16)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
    assert _rel(th.grad.numpy(), np.asarray(jgh)) <= 1e-4
    if tied:
        assert _rel(model.embed.tok.grad.numpy(),
                    np.asarray(jge["tok"])) <= 1e-4
    else:   # the loss reads only the unembedding
        assert model.embed.tok.grad is None and not jge["tok"].any()
        assert _rel(model.embed.unembed.grad.numpy(),
                    np.asarray(jge["unembed"])) <= 1e-4


# ------------------------------------------------------------ model

@pytest.mark.parametrize("S", [512, 128])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, S):
    """S=512 runs the cluster-sparse branch (causal local+global layout),
    S=128 the dense chunked branch."""
    cfg, jcfg = _cfgs(arch)
    tree = _jax_tree(jcfg)
    batch = lm_batch(LMDataConfig(cfg.vocab_size, S, 2, seed=1), 0)
    (lval, jmet), jgrads = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jcfg, {k: jnp.asarray(v)
                                        for k, v in batch.items()}),
        has_aux=True)(tree)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    model = _port_model(cfg, tree)
    loss, met = tlm.lm_loss(model, {k: t(v).long()
                                    for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(lval), rtol=1e-5)
    np.testing.assert_allclose(met["xent"].item(), float(jmet["xent"]),
                               rtol=1e-5)
    assert met["aux"].item() == float(jmet["aux"]) == 0.0
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-6), (name, err)


def test_sparse_branch_reaches_the_cluster_op(monkeypatch):
    """At S >= 256 the cluster-sparse config calls the op once per layer
    with the cached causal layout; at S < 256, or with the dense
    backend, it never does."""
    cfg, _ = _cfgs("smollm_135m")
    calls = []
    real = tlm.kops.cluster_attention

    def spy(*args, **kw):
        calls.append((args[3].shape, kw["causal"]))
        return real(*args, **kw)
    monkeypatch.setattr(tlm.kops, "cluster_attention", spy)
    model = tlm.LMModel(cfg, device="cpu")
    for S, backend, n in ((256, "cluster_sparse", cfg.n_layers),
                          (128, "cluster_sparse", 0), (256, "dense", 0)):
        calls.clear()
        model.cfg = cfg.replace(attn_backend=backend)
        tok = torch.zeros((1, S), dtype=torch.long)
        tlm.lm_forward(model, {"tokens": tok})
        assert len(calls) == n
        assert all(c == ((S // 128, 2), True) for c in calls)
    with pytest.raises(ValueError, match="multiple"):
        model.cfg = cfg
        tlm.lm_forward(model, {"tokens": torch.zeros((1, 300),
                                                     dtype=torch.long)})


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_loads_the_lm_tree(arch):
    """Every leaf of the JAX tree lands on a port parameter of the same
    shape (the stacked layer axis unstacked), strictly."""
    cfg, jcfg = _cfgs(arch)
    tree = _jax_tree(jcfg)
    state = params_from_jax(tree)
    model = tlm.LMModel(cfg, device="cpu")
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        {n: tuple(x.shape) for n, x in state.items()}
    model.load_state_dict(state, strict=True)
    np.testing.assert_array_equal(
        model.layers[1].attn.wq.detach().numpy(),
        tree["layers"]["attn"]["wq"][1])


def test_unported_families_raise_naming_roadmap():
    """A VLM config builds (with its frontend projection); an enc-dec or a
    hybrid config given to LMModel points to its own model; serving under
    a mesh names A8."""
    cfg, _ = _cfgs("qwen3_0_6b")
    vlm = tlm.LMModel(cfg.replace(family="vlm", frontend="vision",
                                  frontend_tokens=4), device="cpu")
    assert vlm.frontend_proj.w.shape == (cfg.d_model, cfg.d_model)
    with pytest.raises(ValueError, match="EncDecModel"):
        tlm.LMModel(cfg.replace(family="encdec", enc_layers=1), device="cpu")
    jamba = get_smoke_config("jamba_v0_1_52b")
    with pytest.raises(ValueError, match="HybridLMModel"):
        tlm.LMModel(jamba, device="cpu")
    from repro_torch.serve import ServeEngine
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        ServeEngine(tlm.LMModel(cfg, device="cpu"), mesh_model=2)


# ------------------------------------------------------------ training

def test_trainer_trajectory_matches_jax(tmp_path):
    """Four steps from the same init on the cluster-sparse branch
    (S=256), through each framework's BatchFnTask and Trainer."""
    cfg, jcfg = _cfgs("qwen3_0_6b")
    dc = LMDataConfig(cfg.vocab_size, 256, 2, seed=3)
    jdc = JLMDataConfig(cfg.vocab_size, 256, 2, seed=3)
    kw = dict(steps=4, lr=1e-3, warmup=2)
    jtr = JTrainer(build(jcfg), JTrainerConfig(
        ckpt_dir=str(tmp_path), attn_impl="ref", **kw),
        lambda s: jax_lm_batch(jdc, s))
    jtr.run()
    model = _port_model(cfg, _jax_tree(jcfg))
    tr = Trainer(model, TrainerConfig(**kw),
                 task=BatchFnTask(lambda s: lm_batch(dc, s)))
    assert tr.run() == "done"
    assert [h["variant"] for h in tr.history] == ["sparse"] * 4
    losses = [h["loss"] for h in tr.history]
    np.testing.assert_allclose(losses, [h["loss"] for h in jtr.history],
                               rtol=1e-4)
    assert losses[-1] < losses[0]


def test_batch_fn_task_uploads_int64():
    cfg, _ = _cfgs("smollm_135m")
    model = tlm.LMModel(cfg, device="cpu")
    task = BatchFnTask(lambda s: lm_batch(
        LMDataConfig(cfg.vocab_size, 16, 2, seed=s), 0)).prepare(model)
    b = task.batches(4)
    assert b["tokens"].dtype == torch.long and b["tokens"].shape == (2, 16)
    want = lm_batch(LMDataConfig(cfg.vocab_size, 16, 2, seed=4), 0)
    np.testing.assert_array_equal(b["labels"].numpy(), want["labels"])
    assert list(task.loss_variants) == ["sparse"]


def test_lm_cli_runs_on_cpu(capsys):
    train_cli.main(["--arch", "smollm_135m", "--smoke", "--steps", "3",
                    "--seq", "64", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=smollm-135m-smoke" in out and "attn_backend=dense" in out
    assert "status=done" in out and "step    3 loss" in out


def test_lm_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--arch", "qwen3_0_6b", "--smoke", "--steps", "1",
                        "--seq", "64", "--batch", "1"])
