"""The fit-and-roofline sweep (``repro_torch.launch.dryrun``) on the CPU:
the traced FLOPs of a step against the reference's compiled count, the
cluster kernels' fake launches against their plain versions, a full-width
cell on the 16 x 16 fake group and the CLI.

A CPU-only build of torch runs no autograd on fake CUDA tensors, so the
traced steps here take ``device="cpu"`` (the plain path),
and the CUDA fake implementations are called directly. Every test that
joins the fake process group leaves it in the fixture's teardown, so the
worker's later tests see no group.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import fake
from repro_torch.configs import get_smoke_config
from repro_torch.core.reformation import lm_local_global_layout
from repro_torch.kernels import cluster_attention as tca
from repro_torch.kernels import cluster_attention_bwd as tcab
from repro_torch.kernels import ref as tref
from repro_torch.launch import dryrun as tdr

# the traced FLOPs against the reference's compiled count
FLOPS_RTOL = 0.05


@pytest.fixture
def fake_group():
    yield
    tdr.leave_fake_group()
    assert not dist.is_initialized()


def _smoke_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def skipped_chunk_flops(cfg, shape, passes: int) -> float:
    """The products of the q/k chunk pairs the port's causal chunked
    attention skips (``layers._attend_q_chunk`` breaks at the first
    k-chunk wholly above the diagonal) and the reference's ``lax.scan``
    computes under its mask: QK^T and PV, 2 B cq ck H Dh each, a pair,
    ``passes`` times a layer (to train: the forward, the layer's
    recomputation, the chunk's recomputation in the backward and the
    backward's four products, 5 forwards' worth; to prefill 1)."""
    B, S = shape.global_batch, shape.seq_len
    cq, ck = min(cfg.attn_chunk_q, S), min(cfg.attn_chunk_k, S)
    skipped = sum(1 for i in range(-(-S // cq)) for j in range(-(-S // ck))
                  if j * ck > i * cq + cq - 1)
    pair = 2 * 2 * B * cq * ck * cfg.n_heads * cfg.head_dim
    return float(skipped * pair * passes * cfg.n_layers)


@pytest.mark.parametrize("shape,passes", [("prefill_32k", 1)])
def test_traced_flops_match_the_reference_compiled_count(shape, passes):
    """Qwen3-0.6B's smoke config at the cell's full shape (32 x 32768 to
    prefill) on a 1 x 1 mesh: the port's ``flops_per_dev``
    (``FlopCounterMode`` on the traced plain step) against the
    reference's ``hlo_analysis.analyze`` of its compiled ``build_cell``
    within ``FLOPS_RTOL``, once the chunk pairs that only the reference
    computes are added to the port's count.

    Term by term: the projections, the MLP and the tied unembedding are
    the same products in both (2 layers, d 128); the attention scores
    and the PV product are the same products for every chunk pair the
    port visits; the port's causal loop skips the pairs wholly above the
    diagonal (240 of 512 a layer at 32768 in chunks of 2048 x 1024),
    which the reference computes and masks: 1.649e13 of its 3.601e13
    (:func:`skipped_chunk_flops`). With them added the counts are equal
    (the train_4k cell: ``test_torch_steps.py``)."""
    _compare_flops(shape, passes)


def _compare_flops(shape, passes):
    import jax
    from repro import compat
    from repro.configs import get_smoke_config as jsmoke
    from repro.launch.hlo_analysis import analyze
    from repro.launch.steps import build_cell, lower_cell

    from repro_torch.configs import SHAPES

    smoke = get_smoke_config("qwen3_0_6b")
    rec = tdr.run_cell("qwen3_0_6b", shape, device="cpu", mesh_shape=(1, 1),
                       overrides=_smoke_fields(smoke), verbose=False)
    assert rec["mesh"] == "1x1" and rec["flops_cluster"] == 0.0
    got = rec["flops_per_dev"]
    mesh = compat.make_mesh((1, 1), ("data", "model"),
                            devices=jax.devices()[:1])
    cell = build_cell("qwen3_0_6b", shape, mesh,
                      overrides=_smoke_fields(jsmoke("qwen3_0_6b")))
    want = analyze(lower_cell(cell, mesh).compile().as_text())["flops"]
    skipped = skipped_chunk_flops(smoke, SHAPES[shape], passes)
    assert skipped > 0
    assert abs(got + skipped - want) <= FLOPS_RTOL * want, \
        (got, skipped, want)
    return got, skipped, want


def _lm_layout(S, causal=True):
    lay = lm_local_global_layout(S, bq=128, bk=128, window=256,
                                 n_global=128, causal=causal)
    return lay.block_idx, lay.block_idx_t


def test_fake_launches_give_the_plain_versions_shapes_and_dtypes():
    """Rows 2, 5 and 6 (the unbiased forward, dQ and dK/dV): the custom
    ops' fake implementations on fake CUDA tensors, and the wrappers
    around them, give the shapes and dtypes the plain versions give on
    real CPU tensors of the same shapes (bf16, GQA, a shared and a
    per-sequence layout)."""
    B, S, H, KV, Dh = 2, 1024, 4, 2, 128
    bi, bit = _lm_layout(S)
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, S, h, Dh), dtype=np.float32)).to(torch.bfloat16)
        for h in (H, KV, KV, H))
    for per_seq in (False, True):
        lay = (np.stack([bi, bi]), np.stack([bit, bit])) if per_seq \
            else (bi, bit)
        cbi, cbit = (torch.from_numpy(np.ascontiguousarray(a))
                     for a in lay)
        o, lse = tref.cluster_sparse_attention(q, k, v, cbi, None, None,
                                               causal=True, return_lse=True)
        dq, dk, dv, _ = tref.cluster_attention_bwd(
            q, k, v, do, o, lse, cbi, None, None, cbit, causal=True)
        want = [(tuple(t.shape), t.dtype) for t in (o, lse, dq, dk, dv)]
        with fake.mode():
            fq, fk, fv, fdo = (torch.empty(t.shape, dtype=t.dtype,
                                           device="cuda")
                               for t in (q, k, v, do))
            fbi, fbit = (torch.empty(t.shape, dtype=torch.int32,
                                     device="cuda") for t in (cbi, cbit))
            fo, flse = tca.launch_fwd_unbiased(fq, fk, fv, fbi, True, True,
                                               False)
            (fdq,) = tcab.launch_dq_unbiased(fq, fk, fv, fdo, flse, flse,
                                             fbi, True, False)
            fdkh, fdvh = tcab.launch_dkv_unbiased(fq, fk, fv, fdo, flse,
                                                  flse, fbi, fbit, True,
                                                  False)
            got = [(tuple(t.shape), t.dtype)
                   for t in (fo, flse, fdq, fdkh, fdvh)]
            # the kernels' dK/dV is per q head; the wrapper sums the groups
            assert got[3] == got[4] == ((B, S, H, Dh), torch.bfloat16)
            wo, wlse = tca.cluster_attention_fwd(fq, fk, fv, fbi, None, None,
                                                 causal=True, return_lse=True)
            g = tcab.cluster_attention_bwd(fq, fk, fv, fdo, wo, wlse, fbi,
                                           None, None, fbit, causal=True)
            wrapped = [(tuple(t.shape), t.dtype)
                       for t in (wo, wlse, *g[:3])]
            assert all(fake.is_fake(t) and t.device.type == "cuda"
                       for t in (wo, wlse, *g[:3]))
        assert got[:3] == want[:3]
        assert wrapped == want
        assert g[3] is None


def test_fake_launches_launch_nothing():
    """A fake trace counts no launch: the counters move only where a
    kernel runs."""
    tca.reset_count()
    tcab.reset_count()
    bi, bit = _lm_layout(512)
    with fake.mode():
        q = torch.empty((1, 512, 2, 128), dtype=torch.bfloat16,
                        device="cuda")
        fbi = torch.empty(bi.shape, dtype=torch.int32, device="cuda")
        tca.launch_fwd_unbiased(q, q, q, fbi, True, True, False)
    assert tca.unbiased_sm90_launches == tca.unbiased_launches == 0


def test_a_launch_reaches_the_dispatcher_only_under_a_mode():
    """``fake.launch_op``: a real call outside any dispatch mode runs the
    launch function itself (the profiler records no custom op); under a
    mode (here ``FlopCounterMode``) it goes through the custom op, and on
    a fake tensor the op's fake implementation gives the output."""
    from torch.utils.flop_counter import FlopCounterMode

    @fake.launch_op("repro_torch_test::double")
    def double(x: torch.Tensor) -> list[torch.Tensor]:
        return [x * 2]

    @double.register_fake
    def _(x):
        return [torch.empty_like(x)]

    def ops_seen(fn):
        with torch.autograd.profiler.profile() as prof:
            out = fn()
        return out, {e.name for e in prof.function_events}

    x = torch.arange(3.0)
    got, seen = ops_seen(lambda: double(x)[0])
    assert got.tolist() == [0.0, 2.0, 4.0]
    assert "aten::mul" in seen and "repro_torch_test::double" not in seen
    with FlopCounterMode(display=False):
        got, seen = ops_seen(lambda: double(x)[0])
    assert got.tolist() == [0.0, 2.0, 4.0]
    assert "repro_torch_test::double" in seen
    with fake.mode():
        out = double(torch.empty(3))[0]
    assert fake.is_fake(out) and out.shape == (3,)


def test_split_plan_of_a_fake_layout_comes_from_its_host_copy():
    """The bf16 forward's split plan on a fake layout equals the plan of
    the real layout it was made from (one row of 128 visits among rows
    of one, cut in two pieces), and a fake layout without its host array
    refuses."""
    nq = 128
    bi = np.full((nq, nq), -1, np.int32)
    bi[0] = np.arange(nq)
    bi[1:, 0] = np.arange(1, nq)
    real = tca.fwd_plan(torch.from_numpy(bi), 1)
    with fake.mode():
        with pytest.raises(NotImplementedError, match="host array"):
            tca.fwd_plan(torch.empty(bi.shape, dtype=torch.int32), 1)
        g = tca.keep_host_copy(torch.empty(bi.shape, dtype=torch.int32), bi)
        plan = tca.fwd_plan(g, 1)
    assert real is not None and real[2] == 2
    assert [(tuple(t.shape), t.dtype) for t in plan[:2]] == \
        [(tuple(t.shape), t.dtype) for t in real[:2]]
    assert plan[2] == real[2]


def test_run_cell_records_a_full_width_cell_on_the_production_mesh(
        fake_group):
    """SmolLM-135M's decode_32k at full width as rank 0 of the 16 x 16
    fake group: every key of the record, the rank's arguments (bf16
    weights and the caches of its 8 rows, whole: 6.04e9 bytes) and the
    recipe's far smaller state."""
    rec = tdr.run_cell("smollm_135m", "decode_32k", device="cpu",
                       verbose=False)
    assert dist.get_world_size() == 256
    keys = {"arch", "shape", "mesh", "devices", "note", "recipe",
            "compile_s", "memory", "state_bytes_recipe",
            "cache_bytes_recipe", "fits", "device", "flops_per_dev",
            "bytes_per_dev", "collectives", "roofline",
            "model_flops_total", "model_flops_per_dev",
            "useful_compute_ratio", "n_params", "n_active_params"}
    assert keys <= set(rec)
    assert (rec["mesh"], rec["devices"], rec["recipe"]) == \
        ("16x16", 256, "decode")
    m = rec["memory"]
    cache = 2 * 30 * 8 * 32768 * 3 * 64 * 2
    assert m["alias_bytes"] == cache
    assert m["argument_bytes"] >= cache + 2 * 134_515_008
    assert m["peak_est_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    assert m["temp_bytes"] > 0 and m["output_bytes"] > 0
    assert rec["state_bytes_recipe"] < m["argument_bytes"] / 100
    assert rec["cache_bytes_recipe"] == cache * 8 // 16 // 8
    assert rec["fits"] is True and rec["device"] is None
    assert rec["n_params"] == rec["n_active_params"] == 134_515_008
    assert rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0
    assert rec["roofline"]["dominant"] == "memory_s"
    assert set(rec["collectives"]) == {"all-reduce", "all-gather",
                                       "reduce-scatter", "all-to-all",
                                       "collective-permute"}
    json.dumps(rec)


def test_cli_writes_records_skips_cached_cells_and_lists_failures(
        tmp_path, capsys, fake_group):
    """``main``: a record per cell in ``dryrun_16x16.jsonl``, a cached
    cell skipped on the next run, an unknown arch under ``FAILURES:``
    with exit 1."""
    argv = ["--arch", "smollm_135m", "--shape", "long_500k", "--device",
            "cpu", "--out", str(tmp_path)]
    assert tdr.main(argv) == 0
    path = tmp_path / "dryrun_16x16.jsonl"
    (rec,) = [json.loads(line) for line in path.read_text().splitlines()]
    assert (rec["arch"], rec["shape"], rec["note"]) == \
        ("smollm_135m", "long_500k", "attn=cluster_sparse")
    assert tdr.main(argv) == 0
    assert "skip (cached) smollm_135m x long_500k" in capsys.readouterr().out
    assert tdr.main(["--arch", "no_such_arch", "--shape", "long_500k",
                     "--device", "cpu", "--out", str(tmp_path)]) == 1
    assert "FAILURES:" in capsys.readouterr().out
    assert len(path.read_text().splitlines()) == 1
