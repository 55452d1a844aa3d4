"""The port's compressed all-reduce (``optim/compress.py``) and pipeline
schedule (``parallel/pipeline.py``) against the JAX package's, on the
CPU: ranks spawned with ``torch.multiprocessing`` over gloo (a world of
2 for the compression, of 4 for the pipeline), each on its share of
this worker's threads, on seeded numpy inputs.

* int8: each rank's encode of its gradient plus residual equals the
  reference's ``_int8_encode`` bit for bit (codes, scales, dequantised
  values); the reduced mean equals the mean of the ranks' dequantised
  values within 1e-6, the new residual is what the encode lost, and the
  fp32 payload each rank hands the all-reduce is counted in
  ``collectives.BYTES``. top-k: each rank's kept entries are the
  reference's ``lax.top_k`` ones and the mean and residual follow, within
  1e-6.
* ``make_compressed_grad_fn`` on the reference's own case (a linear
  model, the batch split over the ranks): int8 within 2% of the exact
  gradient (the reference's bound); for both codecs the residuals are
  non-zero and the reduced gradient plus the ranks' mean residual is
  the exact gradient (what error feedback keeps), within 1e-6.
* ``pipeline_apply``: 4 stages of ``tanh(x @ w)`` over 6 microbatches
  equal the sequential apply within 1e-5 (the bound of
  ``tests/test_pipeline.py``), forward, and the gradients of every
  stage's parameters and of the microbatches.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_threads import worker_share

TOL = 1e-6           # reduced means and residuals
TOL_PIPE = 1e-5      # the reference's pipeline bound
REL_GRAD = 0.02      # compressed vs exact gradient (the reference's)
SHAPE = (37, 29)     # not a whole number of 256-blocks
FRAC = 0.05
N_STAGES, N_MICRO, MB, D = 4, 6, 8, 16


# ------------------------------------------------------------ spawning

def _child(rank, fn, world, tmp, threads, args):
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = fn(rank, world, *args)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, world, tmp, *args) -> list:
    import torch.multiprocessing as mp

    threads = max(1, (worker_share() or world) // world)
    mp.spawn(_child, args=(fn, world, str(tmp), threads, args),
             nprocs=world, join=True)
    return [torch.load(f"{tmp}/rank{r}.pt") for r in range(world)]


# ------------------------------------------------------------ the cases

def _grads(world):
    rng = np.random.default_rng(0)
    return [(rng.standard_normal(SHAPE).astype(np.float32),
             (rng.standard_normal(SHAPE) * 0.01).astype(np.float32))
            for _ in range(world)]


def _linear_case():
    rng = np.random.default_rng(1)
    return {"w": (rng.standard_normal((32, 16))).astype(np.float32),
            "x": rng.standard_normal((64, 32)).astype(np.float32),
            "y": rng.standard_normal((64, 16)).astype(np.float32)}


def _pipe_case():
    rng = np.random.default_rng(2)
    ws = (rng.standard_normal((N_STAGES, D, D)) / np.sqrt(D)).astype(
        np.float32)
    xs = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    g = rng.standard_normal(xs.shape).astype(np.float32)
    return ws, xs, g


# ------------------------------------------------------------ rank bodies

def _compress(rank, world, grads, lin):
    from repro_torch.optim import compress as tc
    from repro_torch.parallel import collectives as C

    x, r = (torch.from_numpy(a) for a in grads[rank])
    out = {"encode": tc.int8_encode(x + r)}
    C.reset_bytes()
    out["int8"] = tc.compressed_psum_int8(x, None, r)
    out["bytes"] = dict(C.BYTES)
    out["topk"] = tc.compressed_psum_topk(x, None, r, frac=FRAC)

    def loss_fn(p, b):
        return ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), {}

    n = lin["x"].shape[0] // world
    batch = {k: torch.from_numpy(lin[k][rank * n:(rank + 1) * n])
             for k in ("x", "y")}
    params = {"w": torch.from_numpy(lin["w"]).requires_grad_()}
    for codec in ("int8", "topk"):
        fn = tc.make_compressed_grad_fn(loss_fn, None, codec=codec,
                                        frac=0.25)
        out[f"fn_{codec}"] = fn(params, batch, tc.init_residuals(params))
    return out


def _pipeline(rank, world, ws, xs, g):
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.pipeline import pipeline_apply

    w = torch.from_numpy(ws[rank]).requires_grad_()
    x = torch.from_numpy(xs).requires_grad_()
    C.reset_bytes()
    out = pipeline_apply(lambda p, a: torch.tanh(a @ p[0]), (w,), x, None)
    (out * torch.from_numpy(g)).sum().backward()
    return {"out": out.detach(), "gw": w.grad, "gx": x.grad,
            "bytes": C.BYTES["pipeline"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {"compress": spawn(_compress, 2, tmp_path_factory.mktemp("c"),
                              _grads(2), _linear_case()),
            "pipeline": spawn(_pipeline, N_STAGES,
                              tmp_path_factory.mktemp("p"), *_pipe_case())}


# ------------------------------------------------------------ tests

def test_int8_encode_equals_reference_bit_for_bit(runs):
    import jax.numpy as jnp

    from repro.optim.compress import _int8_encode

    for (x, r), got in zip(_grads(2), runs["compress"]):
        q, s, deq = (np.asarray(a) for a in _int8_encode(jnp.asarray(x + r)))
        gq, gs, gdeq = (a.numpy() for a in got["encode"])
        assert gq.dtype == q.dtype == np.int8
        for a, b in ((gq, q), (gs, s), (gdeq, deq)):
            assert a.shape == b.shape and a.tobytes() == b.tobytes()


def test_int8_mean_is_the_ranks_dequantised_mean(runs):
    import jax.numpy as jnp

    from repro.optim.compress import _int8_encode

    deqs = [np.asarray(_int8_encode(jnp.asarray(x + r))[2])
            for x, r in _grads(2)]
    want = np.mean(deqs, axis=0)
    for (x, r), d, got in zip(_grads(2), deqs, runs["compress"]):
        mean, res = (a.numpy() for a in got["int8"])
        np.testing.assert_allclose(mean, want, rtol=0, atol=TOL)
        np.testing.assert_allclose(res, (x + r) - d, rtol=0, atol=TOL)
        # the fp32 wire: every 256-block's dequantised values
        blocks = -(-x.size // 256)
        assert got["bytes"]["all_reduce"] == blocks * 256 * 4


def test_topk_matches_reference(runs):
    import jax
    import jax.numpy as jnp

    kept = []
    for x, r in _grads(2):
        flat = jnp.asarray((x + r).reshape(-1))
        k = max(1, int(flat.shape[0] * FRAC))
        _, idx = jax.lax.top_k(jnp.abs(flat), k)
        kept.append(np.asarray(jnp.zeros_like(flat).at[idx].set(flat[idx])))
    want = np.mean(kept, axis=0).reshape(SHAPE)
    for (x, r), kp, got in zip(_grads(2), kept, runs["compress"]):
        mean, res = (a.numpy() for a in got["topk"])
        np.testing.assert_allclose(mean, want, rtol=0, atol=TOL)
        np.testing.assert_allclose(res, (x + r) - kp.reshape(SHAPE), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_compressed_grad_fn_against_exact(runs, codec):
    import jax
    import jax.numpy as jnp

    lin = _linear_case()
    exact = np.asarray(jax.grad(lambda w: jnp.mean(
        (jnp.asarray(lin["x"]) @ w - jnp.asarray(lin["y"])) ** 2))(
            jnp.asarray(lin["w"])))
    losses = []
    res_mean = np.mean([got[f"fn_{codec}"][2]["w"].numpy()
                        for got in runs["compress"]], axis=0)
    for got in runs["compress"]:
        loss, grads, res = got[f"fn_{codec}"]
        g = grads["w"].numpy()
        if codec == "int8":
            rel = np.linalg.norm(g - exact) / np.linalg.norm(exact)
            assert rel < REL_GRAD, rel
        assert np.abs(res["w"].numpy()).max() > 0
        np.testing.assert_allclose(g + res_mean, exact, rtol=0, atol=TOL)
        losses.append(float(loss))
    want = float(np.mean((lin["x"] @ lin["w"] - lin["y"]) ** 2))
    np.testing.assert_allclose(losses, [want] * 2, rtol=1e-5)


def test_pipeline_matches_sequential_forward_and_grads(runs):
    import jax
    import jax.numpy as jnp

    ws, xs, g = _pipe_case()

    def seq(w, x):
        for s in range(N_STAGES):
            x = jnp.tanh(x @ w[s])
        return x

    out, vjp = jax.vjp(seq, jnp.asarray(ws), jnp.asarray(xs))
    gw, gx = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    out = np.asarray(out)
    for rank, got in enumerate(runs["pipeline"]):
        np.testing.assert_allclose(got["out"].numpy(), out, rtol=0,
                                   atol=TOL_PIPE)
        np.testing.assert_allclose(got["gw"].numpy(), gw[rank], rtol=0,
                                   atol=TOL_PIPE)
        np.testing.assert_allclose(got["gx"].numpy(), gx, rtol=0,
                                   atol=TOL_PIPE)
        # the schedule moved activations and gradients between stages
        assert got["bytes"] > 0
