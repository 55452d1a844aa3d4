"""The paper's scale run (``repro_torch.launch.graph_dryrun``) and the
unbiased cluster op on its path, on the CPU, against the JAX package on
the same numpy inputs:

* the mask-free per-graph ``graph_loss`` and every gradient, a 2-layer
  Graphormer-Large-shaped model (no bias table) at Dh 8 (Slim's) and 24
  (Large's), S = 1024, a per-graph (1, 8, 4) layout, fp32, against the
  reference's ``graph_loss`` with ``graph_bias=None``;
* the plain unbiased op's out, dq, dk and dv on that layout against the
  reference's op in interpret mode (``cluster_attention_vjp``, its Pallas
  kernels interpreted), and its lse against a float64 oracle;
* ``graph_batch``'s layout invariants, ``run`` on the CPU and its
  record, the kernels' legality at the new shapes.

The mesh on this path is ``test_torch_graph_dryrun_mesh.py``'s.

Tolerances (fp32, sums in other orders): the loss within 1e-5 relative,
every gradient within 1e-4 of the largest entry of its reference
counterpart; the op's out within 2e-5, lse within 1e-5, dq, dk and dv
within 1e-4 of their largest entry.
"""

import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_jax
from repro_torch.core import graph_model as tgm
from repro_torch.core.reformation import transpose_block_idx
from repro_torch.kernels import cluster_attention as tca
from repro_torch.kernels import ref as tref
from repro_torch.launch import graph_dryrun as gd
from repro_torch.launch.roofline import PEAK_FLOPS


S_SMALL, MB_SMALL = 1024, 4
RECORD_KEYS = {"arch", "seq", "mesh", "peak_gb", "roofline", "device",
               "fits", "step_ms", "model_flops", "mfu", "losses"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
                 "step_lower_bound_s", "roofline_frac"}


def _cfg(d_head):
    """A 2-layer Graphormer-Large-shaped model at head dim ``d_head``, in
    fp32, in the scale run's mode (no bias table)."""
    return gd.scale_config("graphormer_large", smoke=True).replace(
        dtype="float32", d_head=d_head)


def _jax_cfg(cfg):
    import repro.configs as jcfgs
    return jcfgs.get_smoke_config("graphormer_large").replace(
        **{k: getattr(cfg, k) for k in ("graph_bias", "remat", "dtype",
                                        "d_head")})


def _np_batch(batch):
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in batch.items()}


# ------------------------------------------------- the loss, the grads

@pytest.mark.parametrize("d_head", [8, 24])
def test_mask_free_graph_loss_and_grads_match_reference(d_head):
    import jax
    import jax.numpy as jnp
    from repro.core import graph_model as jgm
    from repro.models import build

    cfg = _cfg(d_head)
    jcfg = _jax_cfg(cfg)
    assert jcfg.graph_bias is None and jcfg.head_dim == d_head
    batch = gd.graph_batch(cfg, S_SMALL, mb=MB_SMALL, seed=3)
    assert tuple(batch["block_idx"].shape) == (1, 8, MB_SMALL)
    tree = jax.tree.map(lambda x: np.array(x, copy=True),
                        build(jcfg).init(jax.random.PRNGKey(0)))
    assert "bias_table" not in tree
    jb = {k: jnp.asarray(v) for k, v in _np_batch(batch).items()}
    (lval, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jgm.graph_loss(p, jcfg, jb), has_aux=True))(tree)

    model = tgm.GraphModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    loss, _, grads = gd.loss_and_grads(model, batch)
    np.testing.assert_allclose(loss.item(), float(lval), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-6), (name, err)


def _lse_oracle(q, k, bi):
    """The natural logsumexp of each (b, h, row) over the k-blocks its
    q-block row lists, in float64 numpy: ``(B*H, S)``."""
    B, S, H, Dh = q.shape
    nq = bi.shape[-2]
    bq = S // nq
    out = np.empty((B, H, S))
    for b in range(B):
        for i in range(nq):
            cols = np.concatenate([np.arange(j * bq, (j + 1) * bq)
                                   for j in bi[b, i] if j >= 0])
            s = np.einsum("qhd,khd->hqk", q[b, i * bq:(i + 1) * bq],
                          k[b, cols]).astype(np.float64) * Dh ** -0.5
            m = s.max(-1, keepdims=True)
            out[b, :, i * bq:(i + 1) * bq] = (
                m[..., 0] + np.log(np.exp(s - m).sum(-1)))
    return out.reshape(B * H, S)


@pytest.mark.parametrize("d_head", [8, 24])
def test_plain_unbiased_op_matches_reference_vjp(d_head):
    """The plain forward (out, lse) and backward (dq, dk, dv) on the
    per-graph layout against the reference's op in interpret mode (its
    dispatcher routes it to ``cluster_attention_vjp``, the Pallas forward,
    dQ and dK/dV kernels interpreted, no fallback), and lse against a
    float64 numpy oracle."""
    import warnings

    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    cfg = _cfg(d_head)
    batch = gd.graph_batch(cfg, S_SMALL, mb=MB_SMALL, seed=4)
    bi, bit = batch["block_idx"].numpy(), batch["block_idx_t"].numpy()
    rng = np.random.default_rng(d_head)
    q, k, v, g = (rng.standard_normal((1, S_SMALL, 2, d_head))
                  .astype(np.float32) for _ in range(4))
    jops.set_mode("interpret", "cluster_attention")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            o_want, vjp = jax.vjp(lambda a, b, c: jops.cluster_attention(
                a, b, c, jnp.asarray(bi), None, None, jnp.asarray(bit)),
                *(jnp.asarray(x) for x in (q, k, v)))
            want = vjp(jnp.asarray(g))
    finally:
        jops.set_mode("auto", "cluster_attention")
    fell_back = [w for w in rec if "falling back" in str(w.message)]
    assert not fell_back, fell_back[0].message

    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = tref.cluster_sparse_attention(tq, tk, tv, batch["block_idx"],
                                           return_lse=True)
    got = tref.cluster_attention_bwd(tq, tk, tv, torch.from_numpy(g), o,
                                     lse, batch["block_idx"], None, None,
                                     batch["block_idx_t"])
    np.testing.assert_allclose(o.numpy(), np.asarray(o_want), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), _lse_oracle(q, k, bi),
                               atol=1e-5, rtol=1e-5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b)
        rel = np.abs(a.numpy() - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel <= 1e-4, (name, rel)


# ------------------------------------------------------------ the batch

def test_graph_batch_layout_invariants():
    cfg = gd.scale_config("graphormer_slim")
    b = gd.graph_batch(cfg, 4096, seed=5)
    nq = 4096 // 128
    assert b["feat"].dtype == torch.bfloat16
    assert tuple(b["feat"].shape) == (1, 4096, cfg.feat_dim)
    for key, hi in (("in_deg", cfg.max_degree), ("out_deg", cfg.max_degree),
                    ("labels", cfg.n_classes)):
        assert b[key].min() >= 0 and b[key].max() < hi, key
    bi = b["block_idx"][0].numpy()
    assert bi.shape == (nq, 16) and (bi >= 0).all()
    for i, row in enumerate(bi):   # the diagonal, mb distinct, sorted
        assert i in row and len(set(row)) == 16
        assert (np.diff(row) > 0).all()
    bit = b["block_idx_t"][0].numpy()
    assert bit.shape[0] == nq and bit.shape[1] < nq
    assert bit.shape[1] == max(4, -(-int(np.bincount(bi.ravel()).max())
                                    // 4) * 4)
    # the derived dense-bound layout holds the same pairs, column order
    # aside
    derived = tref.derive_block_idx_t(torch.from_numpy(bi), nq).numpy()
    for j in range(nq):
        mine = {tuple(p) for p in bit[j] if p[0] >= 0}
        theirs = {tuple(p) for p in derived[j] if p[0] >= 0}
        assert mine == theirs and len(mine) == (bi == j).sum()
    np.testing.assert_array_equal(bit, transpose_block_idx(bi, nq))
    again = gd.graph_batch(cfg, 4096, seed=5)
    for key in b:
        assert torch.equal(b[key], again[key]), key
    with pytest.raises(ValueError, match="mb=16"):
        gd.graph_batch(cfg, 1024)


def test_run_on_the_cpu_returns_the_record():
    cfg = gd.scale_config("graphormer_slim", smoke=True)
    rec = gd.run("graphormer_slim", 1024, steps=2, device="cpu", smoke=True,
                 batch=gd.graph_batch(cfg, 1024, mb=MB_SMALL))
    assert RECORD_KEYS <= set(rec)
    assert ROOFLINE_KEYS <= set(rec["roofline"])
    assert rec["arch"] == "graphormer_slim" and rec["seq"] == 1024
    assert rec["device"] == {"name": "cpu", "power_limit": None}
    # no device metric from a CPU run
    assert rec["peak_gb"] is None and rec["fits"] is None \
        and rec["mfu"] is None
    assert len(rec["losses"]) == 2 and np.isfinite(rec["losses"]).all()
    assert rec["remat"] == "block" and rec["d_head"] == 8
    cluster = 8 * MB_SMALL * 128 * 128 * 8 * 4 * 18 * 2
    assert rec["flops"]["cluster"] == cluster
    assert rec["flops"]["counted"] > 0
    flops = rec["flops"]["counted"] + cluster
    assert rec["roofline"]["compute_s"] == pytest.approx(flops / PEAK_FLOPS)
    if not torch.cuda.is_available():   # no fallback to the CPU
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            gd.run("graphormer_slim", 2048, steps=1, smoke=True)


# ------------------------------------------------------ kernel legality

@pytest.mark.parametrize("dtype,d_head,bq,ok", [
    (torch.bfloat16, 8, 128, True),
    (torch.bfloat16, 24, 128, True),
    (torch.float32, 8, 128, True),
    (torch.float32, 24, 64, True),
    (torch.bfloat16, 12, 128, False),
    (torch.float32, 12, 128, False),
    (torch.bfloat16, 8, 64, False),
])
def test_legality_at_the_scale_runs_shapes(dtype, d_head, bq, ok):
    """The per-graph layout and Dh 8 and 24 pass; Dh 12 and bf16 bq 64
    still raise, with the shapes."""
    S = 8 * bq
    q = torch.zeros(1, S, 2, d_head, dtype=dtype)
    bi = torch.zeros(1, 8, 4, dtype=torch.int32)
    bit = torch.zeros(1, 8, 4, 2, dtype=torch.int32)
    if ok:
        tca.check_unbiased_kernel(q, bi, bit, backward=True)
        tca.check_unbiased_kernel(q, bi)
        return
    with pytest.raises(NotImplementedError,
                       match=rf"q \(1, {S}, 2, {d_head}\), block_idx "
                             rf"\(1, 8, 4\), block_idx_t \(1, 8, 4, 2\)"):
        tca.check_unbiased_kernel(q, bi, bit, backward=True)


def test_layout_strides():
    assert tca.layout_stride(torch.zeros(8, 4), 2) == 0
    assert tca.layout_stride(torch.zeros(2, 8, 4), 2) == 32
    assert tca.layout_stride(torch.zeros(8, 5, 2), 3) == 0
    assert tca.layout_stride(torch.zeros(2, 8, 5, 2), 3) == 80
