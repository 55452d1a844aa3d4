#!/usr/bin/env python3
"""The MoE's routing under recomputation and against the plain attention,
on one CUDA card, at ``chip_smoke.py`` phase 13's shapes: (a)
Qwen3-235B-A22B at full width with one layer, S=4096, and (c) Jamba-v0.1
at a quarter width (one period), S=2048 x 2, both on the cluster-sparse
backend under ``remat="block"``.

  python3 tools/moe_routing.py [--out chiprun_out/moe_routing.json]
                               [--parts probe,ab,flips]
  python3 tools/moe_routing.py --smoke    # the smoke configs on the CPU

Three parts, each on both models:

- ``probe``: where a recomputed layer stops repeating its forward, on
  the kernel path and on ``impl="plain"``. Every
  aten op of the forward and of its recomputation in the backward is
  recorded with a digest of its inputs and outputs (the sum of each
  tensor's bits), without the routing replay, and the two lists are
  compared op by op: the first op whose inputs agree and whose outputs
  do not is where the rounding changed; an op whose inputs differ after
  equal outputs was fed by a kernel outside aten (the attention). As
  controls, the whole forward runs twice on the main thread and once on
  another thread, without grad, and is compared the same way.
- ``ab``: one forward and backward (no optimizer), host clock to a
  device sync, in interleaved rounds, under ``"none"``; ``"block"`` with
  the routing replay (``moe.routing_contexts``, the shipped path);
  ``"block"`` with a selective checkpoint that keeps every ``aten.sort``
  output instead; and ``"block"`` with neither, which may fail (the
  recomputation routing elsewhere): its failures are counted.
- ``flips``: the share of (token, slot) routing choices that differ
  between the kernel path and ``impl="plain"`` in a forward, over
  several batches; then the same against attentions made wrong on
  purpose (its output halved; each head group given its first head's
  output), to show what the share is when the kernel is wrong.

Exits 2 without a CUDA device, unless ``--smoke``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import pathlib
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent

FLIP_SEEDS = 8          # batches a model for the kernel-vs-plain share
WRONG_SEEDS = 2         # batches a model for each wrong attention
AB_ROUNDS = 12
PROBE_REPS = 3          # forward + backward recorded, each a new batch

_INT_OF = {}


def digest(x):
    """The sum of a tensor's bits (int64, on its device), or None."""
    import torch

    if not _INT_OF:
        _INT_OF.update({torch.float32: torch.int32,
                        torch.bfloat16: torch.int16,
                        torch.float16: torch.int16,
                        torch.float64: torch.int64})
    if x.numel() == 0 or x.is_complex():
        return None
    if x.dtype in _INT_OF:
        x = x.view(_INT_OF[x.dtype])
    elif x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.sum(dtype=torch.int64)


def recorder(log: list):
    """A dispatch mode appending ``(op, input digests, output digests,
    input shapes)`` to ``log`` for every aten op under it."""
    import torch
    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        def __enter__(self):
            log.append(("thread", threading.get_ident()))
            return super().__enter__()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ins = [x for x in pytree.tree_leaves((args, kwargs))
                   if isinstance(x, torch.Tensor)]
            seen = [digest(x) for x in ins]     # before an in-place op
            if func._schema.name.endswith("_"):  # its target: overwritten
                seen[0] = None
            out = func(*args, **(kwargs or {}))
            outs = [x for x in pytree.tree_leaves(out)
                    if isinstance(x, torch.Tensor)]
            fresh = "empty" in str(func)    # uninitialised memory
            log.append((str(func), seen,
                        [None if fresh else digest(x) for x in outs],
                        [(tuple(x.shape), str(x.dtype), tuple(x.stride()))
                         for x in ins]))
            return out
    return Recorder()


def settle(log: list) -> list:
    """The log with every digest read to the host (one sync for those on
    the card)."""
    import torch

    on_card = [d for e in log if e[0] != "thread" for d in e[1] + e[2]
               if d is not None and d.is_cuda]
    vals = iter(torch.stack(on_card).tolist() if on_card else [])

    def read(d):
        return None if d is None else next(vals) if d.is_cuda else d.item()
    return [e if e[0] == "thread" else
            (e[0], [read(d) for d in e[1]], [read(d) for d in e[2]], e[3])
            for e in log]


def first_divergence(a: list, b: list) -> dict:
    """Where two settled op logs part: the first op whose outputs differ
    (and whether its inputs agreed), or None if they agree as far as the
    shorter goes."""
    skip = ("thread", "aten.detach.default")  # a checkpoint's own detaches
    ops_a = [e for e in a if e[0] not in skip]
    ops_b = [e for e in b if e[0] not in skip]
    for i, (x, y) in enumerate(zip(ops_a, ops_b)):
        if x[0] != y[0]:
            return {"at": i, "kind": "another op", "op": x[0],
                    "other": y[0]}
        if x[1] != y[1]:
            return {"at": i, "kind": "inputs differ after equal outputs "
                    "(fed by a kernel outside aten)", "op": x[0],
                    "inputs": x[3]}
        if x[2] != y[2]:
            return {"at": i, "kind": "same inputs, other outputs",
                    "op": x[0], "inputs": x[3]}
    return {"at": None, "ops": [len(ops_a), len(ops_b)]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/moe_routing.json")
    ap.add_argument("--parts", default="probe,ab,flips",
                    help="comma-separated: probe, ab, flips")
    ap.add_argument("--smoke", action="store_true",
                    help="the configs' smoke sizes at S=256 on the CPU")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not args.smoke and not torch.cuda.is_available():
        print("moe_routing: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                        create_selective_checkpoint_contexts)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import cluster_attention as tca
    from repro_torch.kernels import cluster_attention_bwd as tcab
    from repro_torch.kernels import ops as kops
    from repro_torch.models import layers as L
    from repro_torch.models import moe as tmoe
    from repro_torch.models.hybrid import HybridLMModel, hybrid_loss
    from repro_torch.models.lm import LMModel, lm_loss

    dev = torch.device("cpu" if args.smoke else "cuda")
    if args.smoke:
        def sync():
            pass
        release = sync
    else:
        kbuild.build_all((tca.LIBRARY_UNBIASED_SM90,
                          tcab.LIBRARY_UNBIASED_SM90))
        sync, release = torch.cuda.synchronize, cs.release
    real_remat, real_route, real_attn = L.maybe_remat, tmoe._route, \
        kops.cluster_attention
    out = {"card": "cpu" if args.smoke else os.popen(
        "nvidia-smi --query-gpu=name,power.limit "
        "--format=csv,noheader").read().strip()}
    print(f"[routing] {out['card']}", flush=True)

    def batch_of(cfg, S, B, seed):
        dc = LMDataConfig(cfg.vocab_size, S, B, seed=seed)
        return {k: torch.as_tensor(v, device=dev)
                for k, v in lm_batch(dc, 0).items()}

    def plain_ckpt(fn, cfg, contexts=None, **kw):
        if cfg.remat == "none" or not torch.is_grad_enabled():
            return fn
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False, **kw)

    def save_sorts(ctx, op, *a, **k):
        return (CheckpointPolicy.MUST_SAVE if op in (
            torch.ops.aten.sort.default, torch.ops.aten.sort.stable)
            else CheckpointPolicy.PREFER_RECOMPUTE)

    remats = {
        "none": None,
        "block+replay": real_remat,
        "block+sorts": lambda fn, cfg, contexts=None: plain_ckpt(
            fn, cfg, context_fn=functools.partial(
                create_selective_checkpoint_contexts, save_sorts)),
        "block alone": plain_ckpt,
    }

    def probe(tag, model, loss_fn, S, B):
        """The forward against its recomputation, op by op, on the kernel
        path and on ``impl="plain"``."""
        res = {}
        for impl in (None, "plain"):
            run = functools.partial(loss_fn, model, impl=impl)
            r = res["plain" if impl else "kernel"] = {"controls": [],
                                                      "recompute": []}
            batch = batch_of(model.cfg, S, B, 100)
            runs = []
            with torch.no_grad():       # fills the model's layout cache
                run(batch)
            for where in ("main", "main", "thread"):
                log = []

                def fwd(log=log):
                    with torch.no_grad(), recorder(log):
                        run(batch)
                    sync()
                if where == "thread":
                    th = threading.Thread(target=fwd)
                    th.start()
                    th.join()
                else:
                    fwd()
                runs.append(settle(log))
            for i in (1, 2):
                r["controls"].append(
                    {"against": ["main", "main", "thread"][i],
                     **first_divergence(runs[0], runs[i])})
            del runs
            for rep in range(PROBE_REPS):
                logs = ([], [])
                batch = batch_of(model.cfg, S, B, 200 + rep)
                L.maybe_remat = lambda fn, cfg, contexts=None: plain_ckpt(
                    fn, cfg, context_fn=lambda: (recorder(logs[0]),
                                                 recorder(logs[1])),
                    determinism_check="none")
                err = None
                try:
                    loss, _ = run(batch)
                    torch.autograd.grad(loss, list(model.parameters()))
                except Exception as e:  # the recomputation routed elsewhere
                    err = (f"{type(e).__name__}: "
                           f"{str(e).splitlines()[0][:200]}")
                finally:
                    L.maybe_remat = real_remat
                sync()
                fwd_log, rec_log = settle(logs[0]), settle(logs[1])
                threads = [e[1] for e in fwd_log + rec_log
                           if e[0] == "thread"]
                r["recompute"].append({
                    "error": err, "threads": len(set(threads)),
                    **first_divergence(fwd_log, rec_log)})
                del logs, fwd_log, rec_log
                release()
        print(f"[routing] {tag} probe: {json.dumps(res)}", flush=True)
        return res

    def ab(tag, model, loss_fn, S, B):
        """Forward + backward ms under each recomputation, interleaved."""
        base = model.cfg
        params = list(model.parameters())
        batch = batch_of(base, S, B, 300)
        times = {k: [] for k in remats}
        fails = {k: 0 for k in remats}
        for r in range(AB_ROUNDS + 1):
            for name, remat in remats.items():
                model.cfg = base.replace(remat="none" if remat is None
                                         else "block")
                L.maybe_remat = remat or real_remat
                try:
                    sync()
                    t0 = time.perf_counter()
                    loss, _ = loss_fn(model, batch)
                    grads = torch.autograd.grad(loss, params)
                    sync()
                    if r:           # round 0 warms each variant up
                        times[name].append(
                            (time.perf_counter() - t0) * 1e3)
                    del grads, loss
                except Exception:
                    fails[name] += 1
                finally:
                    L.maybe_remat = real_remat
                    model.cfg = base
                release()
        res = {name: {"ms": ts, "median_ms": float(np.median(ts)) if ts
                      else None, "failed": fails[name]}
               for name, ts in times.items()}
        print(f"[routing] {tag} forward+backward A/B: " + "; ".join(
            f"{n} median {v['median_ms']} ms ({v['failed']} failed)"
            for n, v in res.items()), flush=True)
        return res

    def routes_of(model, loss_fn, batch, impl, wrong=None):
        seen = []

        def spy(w, xt, k, **kw):
            r = real_route(w, xt, k, **kw)
            seen.append(r[1])
            return r

        def attn(*a, **kw):
            o = real_attn(*a, **kw)
            return wrong(o)
        tmoe._route = spy
        if wrong is not None:
            kops.cluster_attention = attn
        try:
            with torch.no_grad():
                loss, _ = loss_fn(model, batch, impl=impl)
        finally:
            tmoe._route, kops.cluster_attention = real_route, real_attn
        return loss.item(), seen

    def flips(tag, model, loss_fn, S, B):
        """Routing choices differing from the plain path's, by batch."""
        cfg = model.cfg
        group = cfg.n_heads // cfg.kv_heads

        def halved(o):
            return o * 0.5

        def first_of_group(o):      # (B, S, H, Dh): each group its head 0
            b, s, h, d = o.shape
            g = o.view(b, s, h // group, group, d)[:, :, :, :1]
            return g.expand(b, s, h // group, group, d).reshape(o.shape)
        res = {"kernel": [], "halved": [], "first_of_group": []}
        for seed in range(FLIP_SEEDS):
            batch = batch_of(cfg, S, B, seed)
            pl, pr = routes_of(model, loss_fn, batch, "plain")
            for name, wrong in (("kernel", None), ("halved", halved),
                                ("first_of_group", first_of_group)):
                if wrong is not None and seed >= WRONG_SEEDS:
                    continue
                kl, kr = routes_of(model, loss_fn, batch, None, wrong)
                n = sum(int((a != b).sum()) for a, b in zip(kr, pr))
                c = sum(a.numel() for a in kr)
                res[name].append({"seed": seed, "flips": n, "choices": c,
                                  "share": n / c,
                                  "loss_rel": abs(kl - pl) / abs(pl)})
        print(f"[routing] {tag} flips against plain: " + "; ".join(
            f"{n}: " + ", ".join(f"{x['share']:.4%}" for x in v)
            + " (loss rel " + ", ".join(f"{x['loss_rel']:.3g}" for x in v)
            + ")" for n, v in res.items()), flush=True)
        return res

    t_start = time.perf_counter()
    if args.smoke:
        cfg = get_smoke_config(cs.MOE_ARCH).replace(
            n_layers=cs.MOE_LAYERS, attn_backend="cluster_sparse")
        jcfg = get_smoke_config(cs.JAMBA_ARCH).replace(
            attn_backend="cluster_sparse", remat="block")
        S, jS = 256, 256
    else:
        cfg = get_config(cs.MOE_ARCH).replace(
            n_layers=cs.MOE_LAYERS, attn_backend="cluster_sparse")
        jcfg = get_config(cs.JAMBA_ARCH).replace(
            attn_backend="cluster_sparse", **cs.JAMBA_CUT)
        S, jS = cs.MOE_SEQS[0], cs.JAMBA_SEQ
    parts = {"probe": probe, "ab": ab, "flips": flips}
    parts = {k: parts[k] for k in args.parts.split(",")}
    model = LMModel(cfg.replace(remat="block"), device=dev, seed=0)
    out["a"] = {k: f("(a)", model, lm_loss, S, 1) for k, f in parts.items()}
    del model
    release()
    model = HybridLMModel(jcfg, device=dev, seed=0)
    out["c"] = {k: f("(c)", model, hybrid_loss, jS, cs.JAMBA_BATCH)
                for k, f in parts.items()}
    out["seconds"] = time.perf_counter() - t_start
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh)
    print(f"[routing] {out['seconds']:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
