"""Training CLI on the port: the graph archs' node, graph-level and link
tasks, the dense and MoE LMs, the SSM LM and the hybrid (the port of
``repro.launch.train``), with checkpoints, restart, the seeded fault
plan and sequence and data parallelism on a host mesh.

Graph archs (``graphormer_slim``, ``graphormer_large``, ``gt``) train one
task through the :class:`Trainer`, on the reference's synthetic data:

* ``--task node`` (default): node classification on one SBM graph
  (``--graph-nodes``, ``p_in=0.04``, ``p_out=0.002``, seed 0);
* ``--task graph``: graph-level classification of ``--graphs`` packed
  mini-graphs (``synthetic_graph_level_dataset``, seed 1) in mini-batches
  of ``--batch-graphs``, held out on half as many (seed 2), 16 x 16
  blocks;
* ``--task link``: link prediction on the same SBM graph as the node
  task.

Every task runs the dense interleave step every ``--interleave-period``
steps and an AutoTuner epoch every ``--elastic-every`` steps, and prints
every step's variant, loss, accuracy and ``beta_thre``, the ladder moves
and the held-out evaluation.

Every arch takes ``--ckpt-dir`` (checkpoints every ``--ckpt-every``
steps and at the end, in the reference's format; a second run with the
same directory resumes from its last step), ``--fault-plan`` (the seeded
``FaultPlan`` spec, e.g. ``nonfinite@2,preempt@5``; ``REPRO_FAULTS``
wins when set), ``--max-bad-steps`` (consecutive non-finite steps
before a rollback; 0 = skip only) and ``--retune-every`` (reload the
kernel winner table, ``--tune-table``, every k steps), and prints the
step it resumed at, the skipped steps, the rollbacks and the run's
status. Without ``--ckpt-dir`` nothing is saved or restored.
``--state-dtype`` (``float32``, the default, ``bfloat16`` or ``int8``)
sets AdamW's moments, as the reference's flag does.

LM archs (the dense ``qwen3_0_6b``, ``smollm_135m``, ``qwen3_1_7b``,
``qwen3_4b``, the MoE ``qwen3_moe_235b_a22b``, ``kimi_k2_1t_a32b``, the
SSM LM ``mamba2_2_7b`` and the hybrid ``jamba_v0_1_52b``, each on the
model class of its family, ``models/api.lm_model_class``): trains the
config as published on the synthetic token stream of
``data/lm_pipeline.py`` (``--seq`` tokens, ``--batch`` sequences a step)
through :class:`BatchFnTask`, and prints the loss every tenth of the
run, with the cross-entropy and the MoE balance term (``aux``) where the
family has one. The published LM configs run dense attention; the
cluster-sparse backend is ``cfg.replace(attn_backend="cluster_sparse")``,
as in the reference. The VLM (``internvl2_76b``) and enc-dec
(``seamless_m4t_medium``) archs are refused with a ``ValueError``: their
losses need image patches or speech frames, which the token stream does
not carry (the reference's CLI cannot train them either).
Every family recomputes its layers in the backward as ``cfg.remat``
says (the configs' default is ``"block"``).

``--mesh-model P`` and ``--mesh-data D`` train on a (D, P) mesh of
P·D ranks, one process each, over ``--backend`` (``gloo`` or ``nccl``,
never chosen for the caller): the sequence sharded P ways (the graph
node, graph-level and link tasks through ``sharded_cluster_attention``,
the token LMs of every family through Ulysses or sequence-parallel
attention and the Mamba2 blocks over their SSM heads, the MoE's and the
hybrid's experts P ways, each rank holding its E/P), the batch D ways
where it divides (graph-level: the mini-graphs). Under torchrun (RANK
and WORLD_SIZE set) each process is one rank; otherwise the CLI spawns
the ranks itself and rank 0 prints. It prints the ``mesh=... recipe=...
sharded_cluster_attention=...`` line of the reference; a graph shape
that cannot shard prints ``sharded_cluster_attention=OFF (shape cannot
shard; GSPMD fallback)`` and trains on through the unsharded op
(``core/graph_model.py``; a sequence that does not split P ways stays
whole on every rank). NCCL needs a card a rank; several ranks share one
card over gloo (through the host).

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch graphormer_slim --smoke --steps 20 --graph-nodes 96 \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch graphormer_large --steps 16 --graph-nodes 8192
  PYTHONPATH=src python -m repro_torch.launch.train --arch gt --smoke \\
      --task graph --graphs 8 --batch-graphs 4 --steps 6 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gt --smoke \\
      --task link --graph-nodes 128 --steps 6 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \\
      --smoke --steps 20 --seq 128 --batch 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \\
      --smoke --steps 6 --seq 64 --batch 2 --state-dtype int8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_2_7b \\
      --smoke --steps 6 --seq 64 --batch 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen3_moe_235b_a22b --smoke --steps 6 --seq 64 --batch 2 \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch jamba_v0_1_52b \\
      --smoke --steps 6 --seq 64 --batch 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gt --smoke \\
      --task graph --graphs 8 --batch-graphs 4 --steps 6 --device cpu \\
      --ckpt-dir _local/ck --ckpt-every 2 --fault-plan nonfinite@2
  PYTHONPATH=src python -m repro_torch.launch.train --arch gt --smoke \\
      --steps 4 --graph-nodes 192 --mesh-model 2 --backend gloo \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \\
      --smoke --steps 4 --seq 256 --batch 2 --mesh-model 2 --mesh-data 2 \\
      --backend gloo --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_2_7b \\
      --smoke --steps 4 --seq 96 --batch 2 --mesh-model 2 --backend gloo \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gt --smoke \\
      --task graph --graphs 8 --batch-graphs 4 --steps 4 --mesh-model 3 \\
      --backend gloo --device cpu
"""

from __future__ import annotations

import argparse
import sys

import torch.distributed as dist

from repro_torch.configs import (ARCHS, ShapeConfig, get_config,
                                 get_smoke_config)
from repro_torch.core.graph import sbm_graph
from repro_torch.core.graph_model import GraphModel
from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch
from repro_torch.launch import mesh as lmesh
from repro_torch.models.api import lm_model_class
from repro_torch.models.ssm import ssm_dims
from repro_torch.parallel.cluster_parallel import can_shard_cluster
from repro_torch.parallel.sharding import recipe_for
from repro_torch.parallel.ulysses import can_ulysses
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.tasks import (BatchFnTask, GraphLevelTask, LinkTask,
                               NodeTask, synthetic_graph_level_dataset)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="graphormer_slim", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128,
                    help="[LM archs] tokens per sequence")
    ap.add_argument("--batch", type=int, default=8,
                    help="[LM archs] sequences per step")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--state-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"],
                    help="AdamW's moments (int8: blockwise, per "
                         "reference leaf)")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="override the config's activation dtype")
    ap.add_argument("--task", default="node",
                    choices=["node", "graph", "link"],
                    help="[graph archs] workload: node classification, "
                         "graph-level classification, link prediction")
    ap.add_argument("--graph-nodes", type=int, default=512,
                    help="synthetic SBM graph size")
    ap.add_argument("--graph-clusters", type=int, default=4)
    ap.add_argument("--graphs", type=int, default=16,
                    help="[--task graph] number of mini-graphs")
    ap.add_argument("--batch-graphs", type=int, default=0,
                    help="[--task graph] graphs per mini-batch (must "
                         "divide --graphs; 0 = one full batch, no "
                         "cycling)")
    ap.add_argument("--interleave-period", type=int, default=-1,
                    help="dense step every k steps (-1 = config default, "
                         "0 = never)")
    ap.add_argument("--elastic-every", type=int, default=-1,
                    help="steps per AutoTuner epoch / re-layout boundary "
                         "(-1 = config default, 0 = frozen layout)")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory; a run resumes from its "
                         "newest verified step ('' = no checkpoints)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fault-plan", default="",
                    help="deterministic fault injection spec "
                         "(repro_torch.resilience), e.g. "
                         "'nonfinite@5,preempt@7,ckpt_corrupt@10'; "
                         "REPRO_FAULTS wins when set")
    ap.add_argument("--max-bad-steps", type=int, default=3,
                    help="consecutive non-finite steps before rollback "
                         "to the last verified checkpoint (0 = "
                         "skip-only, never roll back)")
    ap.add_argument("--retune-every", type=int, default=0,
                    help="reload the kernel winner table every k steps "
                         "(repro_torch.tune; 0 = never)")
    ap.add_argument("--tune-table", default="",
                    help="winner-table path for --retune-every "
                         "('' = TUNE_winners_torch.json)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="ranks the sequence is sharded over")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="ranks the batch is sharded over")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="torch.distributed backend of a mesh (required "
                         "with one)")
    ap.add_argument("--device", default="cuda")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    world = args.mesh_model * args.mesh_data
    if world > 1:
        if args.backend is None:
            raise ValueError("--mesh-model/--mesh-data need --backend "
                             "(gloo or nccl)")
        if not dist.is_initialized():
            if not lmesh.torchrun_env():
                lmesh.spawn(main, world, backend=args.backend,
                            args=(argv,))
                return None
            lmesh.from_torchrun(args.backend)
        args.device = lmesh.rank_device(args.device)
    if cfg.family != "graph":
        return _lm_main(args, cfg)

    model = GraphModel(cfg, device=args.device)
    n_params = sum(p.numel() for p in model.parameters())
    say = _printer()
    say(f"arch={cfg.name} params={n_params:,} device={model.device}")

    interleave = cfg.interleave_period if args.interleave_period < 0 \
        else args.interleave_period
    elastic_every = cfg.elastic_every if args.elastic_every < 0 \
        else args.elastic_every
    task = _make_graph_task(args, cfg, model.device)
    lay = task.layout
    say(f"task={task.name} seq={lay.seq_len} bq={lay.bq} "
        f"mini_batches={task.n_batches} "
        f"ladder={[round(b, 4) for b in task.tuner.ladder]} "
        f"mb_cap={task.mb_cap} prep={task.prep_seconds:.2f}s")

    mesh = recipe = None
    if world > 1:
        mesh = lmesh.make_host_mesh(model=args.mesh_model,
                                    data=args.mesh_data)
        recipe = recipe_for(ShapeConfig("graph", "train", lay.seq_len, 1),
                            mesh)
        ok = args.mesh_model == 1 or can_shard_cluster(
            cfg.n_heads, cfg.kv_heads, lay.seq_len, args.mesh_model,
            lay.bq, lay.bk)
        sca = "on" if ok else "OFF (shape cannot shard; GSPMD fallback)"
        say(f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
            f"recipe={recipe.name} sharded_cluster_attention={sca}")

    tc = TrainerConfig(steps=args.steps, lr=args.lr,
                       warmup=max(2, args.steps // 10),
                       interleave_period=interleave,
                       elastic_every=elastic_every, **_recovery(args))
    trainer = Trainer(model, tc, task=task, mesh=mesh, recipe=recipe)
    status = trainer.run()
    if not trainer.history:  # restored a finished run: nothing to do
        say(f"status={status} (already at step {trainer.steps_done})")
        return trainer
    _print_recovery(trainer, say)
    for h in trainer.history:
        say(f"step {h['step']:4d} [{h['variant']:6s}] "
            f"loss {h['loss']:.4f} acc {h['acc']:.3f} "
            f"beta_thre {h['beta_thre']:.4f} {h['seconds'] * 1e3:.0f}ms")
    for m in task.moves:
        say(f"ladder move @ step {m.step}: pos={m.pos} "
            f"beta_thre={m.beta_thre:.4f} (LDR {m.ldr:+.2e})")
    ev = task.eval(model)
    say("eval: " + " ".join(f"{k}={v:.4f}" for k, v in ev.items()))
    say(f"status={status} final_loss={trainer.history[-1]['loss']:.4f} "
        f"moves={len(task.moves)} "
        f"dense_steps={sum(1 for h in trainer.history if h['dense'])}")
    return trainer


def _printer():
    """``print`` on rank 0 (and without a process group), else a no-op."""
    if dist.is_initialized() and dist.get_rank() != 0:
        return lambda *a, **kw: None
    return print


def _make_graph_task(args, cfg, device):
    """The requested task (node / graph-level / link) on the reference's
    synthetic data, its batches on ``device``."""
    if args.task == "graph":
        graphs = synthetic_graph_level_dataset(args.graphs, cfg, seed=1)
        eval_graphs = synthetic_graph_level_dataset(
            max(2, args.graphs // 2), cfg, seed=2)
        return GraphLevelTask(graphs, cfg, eval_graphs=eval_graphs,
                              batch_graphs=args.batch_graphs or None,
                              device=device)
    g = sbm_graph(args.graph_nodes, args.graph_clusters, p_in=0.04,
                  p_out=0.002, feat_dim=cfg.feat_dim,
                  n_classes=cfg.n_classes, seed=0)
    if args.task == "link":
        return LinkTask(g, cfg, device=device)
    return NodeTask(g, cfg, device=device)


def _lm_main(args, cfg):
    if cfg.family in ("vlm", "encdec"):
        # their losses read image patches or speech frames, which the
        # token stream does not carry (nor does the reference's CLI)
        raise ValueError(
            f"--arch {args.arch}: the {cfg.family} family needs "
            f"{'patches' if cfg.family == 'vlm' else 'frames'} beside the "
            f"tokens, and the synthetic token stream has none; train it "
            f"through Trainer with a task that supplies them")
    world = args.mesh_model * args.mesh_data
    mesh = recipe = None
    kw = {}
    if world > 1:
        mesh = lmesh.make_host_mesh(model=args.mesh_model,
                                    data=args.mesh_data)
        recipe = recipe_for(
            ShapeConfig("train", "train", args.seq, args.batch), mesh)
        if cfg.moe_experts and args.mesh_model > 1:
            # each rank holds its own experts
            kw["experts"] = (mesh.get_local_rank("model"), args.mesh_model)
    model = lm_model_class(cfg)(cfg, device=args.device, **kw)
    mixer = "ssm" if cfg.family == "ssm" else cfg.attn_backend
    n_params = sum(p.numel() for p in model.parameters())
    say = _printer()
    say(f"arch={cfg.name} params={n_params:,} device={model.device} "
        f"attn_backend={mixer} remat={cfg.remat} seq={args.seq} "
        f"batch={args.batch}")
    if mesh is not None:
        parts = []
        if cfg.n_heads:
            parts.append("attention=" + ("ulysses" if recipe.ulysses and
                                         can_ulysses(cfg.n_heads,
                                                     cfg.kv_heads, args.seq,
                                                     args.mesh_model)
                                         else "seqpar"))
        if cfg.family in ("ssm", "hybrid") and args.mesh_model > 1:
            H = ssm_dims(cfg)[1]
            parts.append(f"ssm_heads_per_rank={H // args.mesh_model}"
                         if H % args.mesh_model == 0 else
                         "ssm=whole (heads cannot split)")
        if "experts" in kw:
            parts.append(f"experts_per_rank="
                         f"{cfg.moe_experts // args.mesh_model}")
        say(f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
            f"recipe={recipe.name} {' '.join(parts)}")
    dc = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    tc = TrainerConfig(steps=args.steps, lr=args.lr,
                       warmup=max(2, args.steps // 10), **_recovery(args))
    trainer = Trainer(model, tc, task=BatchFnTask(lambda s: lm_batch(dc, s)),
                      mesh=mesh, recipe=recipe)
    status = trainer.run()
    hist = trainer.history
    if not hist:  # restored a finished run: nothing to do
        say(f"status={status} (already at step {trainer.steps_done})")
        return trainer
    _print_recovery(trainer, say)
    for h in hist[:: max(1, len(hist) // 10)]:
        extra = "".join(f" {k} {h[k]:.4f}" for k in ("xent", "aux")
                        if k in h and "aux" in h)
        say(f"step {h['step']:4d} loss {h['loss']:.4f}{extra} "
            f"{h['seconds'] * 1e3:.0f}ms")
    say(f"status={status} final_loss={hist[-1]['loss']:.4f}")
    return trainer


def _recovery(args) -> dict:
    """The TrainerConfig fields of the moments' dtype and of the
    checkpoint, fault and retune flags."""
    return dict(state_dtype=args.state_dtype,
                ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every,
                fault_plan=args.fault_plan, max_bad_steps=args.max_bad_steps,
                retune_every=args.retune_every, tune_table=args.tune_table)


def _print_recovery(trainer, say=print) -> None:
    """Where the run started, the steps the guard skipped, the rollbacks
    and the injected faults."""
    hist = trainer.history
    say(f"resumed_at={hist[0]['step'] - 1} "
        f"skipped_steps={[h['step'] for h in hist if h['skipped']]} "
        f"rollbacks={[(r.at_step, r.to_step) for r in trainer.rollbacks]} "
        f"stragglers={len(trainer.stragglers)} faults={trainer.fault_log}")


if __name__ == "__main__":
    main()
