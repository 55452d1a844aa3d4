#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each failing loudly (an uncaught exception, non-zero exit):

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile every kernel of the paths from the checkout, one nvcc
   per source, all started together;
3. kernels vs their plain PyTorch versions on the card: the cluster
   attention forward at the serve shape (32768-node SBM, Graphormer-Large
   heads) in bf16 and fp32, and small cases (GQA, Dh 8, a shared 2-D
   layout, per-graph 3-D layouts, dead rows, a full layout); bf16 runs
   the tensor-core forward (at the serve shape the global token's row
   cut into pieces that a combine kernel merges), fp32 the CUDA-core one
   (each launch checked on its own counter); O and lse
   are compared, kernel and plain timed with CUDA events; one
   ``scaled_dot_product_attention`` with the dense additive mask is timed
   beside the kernel at the 8192-node graph and at the serve shape, its
   forward and its backward;
3b. the dQ and dK/dV backward kernels vs the plain backward, on the same
   cases (and without a transposed layout: the derived one); both run on
   the tensor cores in bf16 and on CUDA cores in fp32 (each launch
   checked on its own counter); dq, dk, dv and the bias gradient are
   compared, each kernel and each plain half timed, with its bound and
   its exp floor (one exp2 per score and head at 16 a clock per SM); the
   bf16 dQ also with its heavy row cut to one visit and with every row
   whole (unsplit); then the three kernels under every pair of the
   cluster op's schedule flags (``hoist_scale``, ``fuse_bias``) against
   the plain versions under the same flags (``[schedule]`` lines), at
   the serve shape in bf16 and fp32 (fp32 timed under each pair) and at
   16 x 16 in phase 3e;
3c. the unbiased kernels of the LM path (the forward, dQ and dK/dV, with
   the positional causal mask) vs their plain versions: at the Qwen3-0.6B
   training shape (S=16384, 16 q heads over 8 KV heads, Dh=128, the
   causal local+global layout) in bf16 and fp32, and on small cases
   (non-causal, Dh 64 with 9 heads over 3, a short window, B=2 on the
   shared layout, the derived transposed layout); bf16 runs the
   tensor-core forward, dQ and dK/dV, fp32 the CUDA-core ones (each
   launch checked on its own counter); each kernel and each plain half
   timed, and under each value of ``hoist_scale`` held to the plain
   versions under the same flag at the training shape (fp32 timed); one
   ``scaled_dot_product_attention`` with the layout as a dense boolean
   mask, and one with ``is_causal``, timed beside them, forward and
   backward;
3d. the dense flash forward, dQ and dK/dV kernels and the Mamba2 SSD
   scan vs their plain versions: at full width (Qwen3-0.6B's attention,
   S=16384, 16 q heads over 8, Dh 128, causal; Mamba2-2.7B's 80 heads of
   dh 64, N 128, chunk 256, S=16384) in bf16 and fp32, and on small cases
   (non-causal, ragged S, Dh 32 and 64, B=2, hoist_scale, the SSD
   default case); bf16 flash runs the tensor-core forward, dQ and dK/dV
   (each dQ launch checked on its dtype's counter); each kernel timed,
   each plain half timed by its checking call (2-4 s a call at
   S=16384), one
   ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
   timed beside the flash kernels, forward and backward;
3e. the biased forward, dQ and dK/dV at the graph-level task's 16 x 16
   blocks vs their plain versions, on the packed layout of 128 mini-graphs
   (S=128, per-graph 3-D layouts with dead rows): GT heads (H=8, Dh=16,
   a 1-wide table) and Graphormer-Slim heads (Dh=8, 3 buckets, a random
   table), bf16 and fp32, each launch on its own counter (the 16-block
   instantiations count apart); each kernel timed beside its plain
   version, bound and exp floor, and one SDPA call with the dense
   (B, H, S, S) additive mask, forward and backward;
4. serve (the first main path): GraphServe on Graphormer-Large at full
   width, seeded random weights, on the 32768-node SBM — 64 node and 2x64
   link queries, answered twice (the second time from the layout cache).
   The same forward with the plain attention must give the same logits.
   Then Graphormer-Slim (Dh=8) on the same graph;
5. train (the second main path): Graphormer-Large at full width, its
   depth cut to 4 of 12 layers (phase 11 trains it at full depth), bf16
   compute, fp32 parameters and moments, on the 8192-node SBM through
   ``NodeTask`` and ``Trainer``: 16 steps, dense at 0 and 8, an AutoTuner
   epoch every step. Losses must be finite and fall. On every ladder rung
   a sparse step ran on, with the trainer's own device batch, the op's
   kernels (forward, dQ, dK/dV) must agree with its plain versions on
   random inputs, and the kernel path and the plain path must give the
   same loss and gradients on one sparse step; on the nearly dense rung
   the forward, dQ and dK/dV kernels are timed with the trainer's device
   batch beside their plain versions, bounds, exp floor and one SDPA call
   with the rung's layout as a dense additive mask (forward and
   backward), and on the sparse rung the dQ kernel with its heavy row cut
   to one visit and unsplit; one sparse and one dense step are profiled.
   Before those checks the 16-step state is copied once as a rescue
   copy, its parameters copied to the host once (the re-init copy), and
   it is checkpointed (the save's blocking snapshot; its background write
   runs on through the rest of phase 5 and phase 6, as an async save
   runs beside training), then restored into a fresh Trainer on a model
   of its own (bit for bit), with the write's seconds and bytes on disk;
6. LM train (slice 3's main path): Qwen3-0.6B at full width and depth
   with the cluster-sparse attention backend, bf16 compute, fp32
   parameters and moments, seeded init, on the synthetic token stream
   (S=16384, batch 1) through ``BatchFnTask`` and ``Trainer``: 4 steps,
   finite and falling losses, 56 launches of the unbiased forward and 28
   of its dQ and dK/dV a step under the config's ``remat="block"``
   (bf16: the tensor-core kernels, none of the CUDA-core ones).
   One step by the kernel path and one by the plain path on the same
   batch must agree; one step is profiled; the parameters' host copy
   (the re-init copy ``Trainer.run`` takes) is timed;
7. tune (slice 4's main path): the autotuner on the card as
   ``python -m repro_torch.tune`` runs it (wall-clock search of every op
   on its default case; the cluster op's over the four launches of
   ``fuse_bias`` x ``hoist_scale`` on the fp32 kernels of rows 1, 3, 4,
   the candidates that differ only in ``row_chunk``, which the kernels
   do not read, timed once), then the full-width flash and SSD cases, then
   ``check_regression`` (the cluster entry, its ratio printed, the
   full-width flash and SSD winners); every winner gated
   kernel-vs-plain, the table read back by CUDA dispatch, each flash and
   SSD kernel launched;
8. graph-level train (slice 10's main path, as ``--task graph`` runs it):
   GT at full width on 256 graphs of ``synthetic_graph_level_dataset``
   (seed 1) in mini-batches of 128 at 16 x 16 blocks, 64 held out (seed
   2), 16 steps, dense at 0 and 8, an AutoTuner epoch every step; each
   sparse step must launch the bf16 16-block dQ and dK/dV once a layer
   and the forward twice (``remat="block"``), and nothing else, each
   dense step nothing; step 0's sparse
   loss and gradients held against ``impl="plain"``; step ms (sparse and
   dense apart), host prep, loss, held-out accuracy, peak memory. Then
   Graphormer-Slim at full width, 8 steps on the same data (a random
   nonzero bias table and its gradient through the 16-block kernels);
9. link train (``--task link``): GT at full width on the launcher's
   2048-node SBM at 32 x 32 blocks, 256 pairs a step, 16 steps, dense at
   0 and 8, checked and reported as phase 8;
9b. the paper's three systems (slice 20's main path, as ``python -m
   repro_torch.launch.node_classification`` runs it): the harness's
   ``GraphTrainBench`` with Graphormer-Slim as published (4 layers, d
   64, 8 heads of 8, bf16) on its SBM of 8192 nodes at 32 x 32 blocks,
   trained from the seeded init in each mode: GP-RAW (``raw``, dense
   with the structural bias) and GP-FLASH (``flash``, dense without it)
   6 epochs each, pure ``sparse`` and TorchGT (``torchgt``, dense at 0,
   8 and 16) 18 each; each dense epoch must launch no kernel, each
   sparse one rows 1, 3 and 4 as ``step_launches`` says, the held-out
   evaluation the forward once a layer; losses finite and falling; one
   sparse step at TorchGT's trained parameters held to ``impl="plain"``
   (the 32 x 32 backward at Dh 8); epoch ms (median without epochs 0-1,
   each to a synchronisation), held-out accuracy and peak memory of each
   mode, beta_G, the layout's density and the prep seconds; the paper's
   accuracy ordering printed, not gated;
9c. the paper's scale (slice 21's main path, Fig. 9a's "up to 1M", as
   ``python -m repro_torch.launch.graph_dryrun`` runs it): Graphormer in
   mask-free cluster-sparse mode (no bias table, a layout per graph,
   bq 128, 16 live k-blocks a q-block row: the diagonal and 15 others),
   bf16, ``remat="block"``, the batches drawn on a thread during phase
   3. (a) Rows 2, 5 and 6 at Dh 8 (Slim's 8 heads) and Dh 24
   (Large's 32) on two sequences of S=16384, a layout each, bf16 and
   fp32, against their plain versions at phase 3c's tolerances, each
   kernel and plain half timed with its bound, and one SDPA call with
   the layouts as a dense boolean mask, forward and backward; (b) one
   step of Slim and of Large (4 of its 12 layers) at S=16384 held to
   ``impl="plain"`` (the loss, every gradient, the fp32 plain path as
   referee, as phase 14); (c) Graphormer-Slim at S=1,048,576 and
   Graphormer-Large at S=262,144, 3 steps each through
   ``graph_dryrun.run`` on the kernel path: rows 2, 5 and 6 launched
   exactly, every loss finite, each record (peak memory, step ms, the
   roofline terms, MFU) printed with the card's name and power limit,
   then one more step at each shape profiled (device time by kind);
9d. the fit-and-roofline sweep held to the card (slice 22, as ``python
   -m repro_torch.launch.dryrun`` traces a cell): Qwen3-0.6B train_4k on
   the cluster-sparse backend at batch 2 and SmolLM-135M long_500k at
   batch 1, published widths and depths on a (1, 1) mesh, each traced
   on fake CUDA tensors (``dryrun.run_cell``) and then run once for
   real from the same ``steps.build_cell``: the trace's
   ``peak_est_bytes`` within 10% of ``max_memory_allocated`` over the
   step, its ``FlopCounterMode`` count equal to the real step's, each
   cluster-op launch's outputs (shapes, dtypes) equal to the real
   launches', rows 2, 5 and 6 counted, the loss or logits finite;
10. recovery (slice 11's main path), in a child process with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and deterministic algorithms, so
   that a replay is bitwise comparable: GT graph-level at phase 8's shape,
   16 steps, checkpoints every 4, the layout frozen — an unfaulted
   baseline, ``nonfinite@6`` skipped, ``nonfinite@5-7`` rolled back to 4
   past the generation saved at 8 inside the streak, ``preempt@10`` inside
   the update resumed at 10 from the rescue copy and at 8 without one,
   the checkpoint at 16 corrupted and a fresh run falling back to 12;
   every recovery bitwise equal to the baseline, each case's launches of
   the 16 x 16 kernels counted; GT link at phase 9's shape preempted at 10
   and resumed, bitwise; a graph-level run with an AutoTuner epoch every
   step failed at 10 and resumed with the task state of the manifest; the
   GT state's checkpoint costs and the step time with async saves. The
   parent fails on the child's non-zero exit or any unrecovered case.
   Each child of phases 10-15 is started while the phase before it runs
   (``ChildPhase``, ``--warm``): its interpreter, torch and port imports
   and CUDA initialisation overlap that phase, as does its host-only
   set-up (phase 10's first task, phase 11's Graphormer-Large graph and
   task, phase 14's SeamlessM4T init, phase 15's ranks' start-up), and
   it waits on its standard input for its turn, then leaves with
   ``os._exit`` once its record is written;
11. recomputation (slice 12's main path, ``cfg.remat``), in a child
   process with deterministic cuBLAS, so Qwen3-4B meets an empty card:
   Qwen3-0.6B at S=16384, 3 steps under "none" and 3 under "block" from
   the same parameters and batches and one under "dots", step 0's loss
   and gradients of each held to "none" (the loss bitwise); Qwen3-0.6B
   at S=65536, 2 steps; Qwen3-1.7B at S=16384, 3 steps; Qwen3-4B at
   S=8192 (S=4096 if it does not fit, the cut recorded), 2 steps;
   Mamba2-2.7B with 8 of its 64 layers at S=4096, 2 steps (the plain
   SSD scan, as the reference's model: no kernel); Graphormer-Large node
   training on the serve phase's 32768-node graph, sparse steps only,
   the layout frozen (so its task prepares the AutoTuner's start rung
   alone, ``start_rung_task``), 3 steps under "none" and 3 under
   "block", held as
   the Qwen3 A/B. All at full width, and but for Mamba2 at full depth,
   the LMs on the cluster-sparse backend, batch 1, every seeded init
   drawn on the card (``layers.draw_on_device``); each run's peak
   memory, step times, losses (finite, falling);
12. token serving (slice 13's main path), in a child process: Qwen3-0.6B
   as published (bf16, dense attention, seeded weights drawn on the
   card, as Mamba2-2.7B's in (e)) through
   ``ServeEngine`` (8 slots, page 16, chunk 256): (a) 8 requests,
   prompts 128-3840, 128 new tokens each, max_len 4096, then 2 more on
   the warm engine at half the measured request rate; (b) the
   cluster-sparse decode mask at max_len 8192, 4 requests, prompts
   4500-8000, 64 tokens; each with tokens and requests a second, latency
   and TTFT percentiles, ms a prefill chunk and a decode step, exactly
   two programs, the pool's bytes, peak memory, every block free at
   drain, no kernel launched; (c) two requests of (a) and one of (b)
   teacher-forced against oracles over the engine's own tokens (the full
   causal forward; contiguous sparse ``lm_decode_step``), each token the
   oracle's argmax where its top-2 margin exceeds a stated tolerance,
   and an fp32 engine's streams equal to the contiguous greedy decode's;
   (d) the cluster-sparse backend's ``lm_prefill`` at S=16384 held to
   ``impl="plain"`` (logits and every layer's k/v) and at S=65536, row 2
   launched once a layer a prefill, then 16 tokens of sparse decode; (e)
   Mamba2-2.7B's prefill logits at S=256 against 256 decode steps (the
   reference's tolerance), then 16 tokens;
13. the MoE family and the hybrid (slice 14's main path), in a child
   process: (a) Qwen3-235B-A22B at full width (d_model 4096, 64 heads
   over 4, 128 experts top-8 of width 1536, vocab 151936), its depth cut
   to one layer, on the cluster-sparse backend under "block", seeded
   init drawn on the card and timed: the MoE op on 1024 tokens on the card against the CPU in
   fp32; layer 0's attention op on its own q, k, v (64 query heads over
   4), rows 2, 5 and 6 against their plain versions at phase 11's
   tolerances; step 0 against ``impl="plain"`` (loss, every gradient's
   cosine, the share of routing choices that differ); 3 steps through
   ``BatchFnTask`` and ``Trainer`` at S=4096 (S=2048 if it does not fit),
   rows 2, 5 and 6 launched 2, 1 and 1 times a step; a step profiled,
   AdamW and the MoE op (and its expert loop) timed on the step's
   shapes; (b) the same weights served as published (dense attention)
   through ``ServeEngine`` (8 slots, page 16, chunk 256, max_len 2048):
   16 requests, prompts 128-1536, 32 new tokens, two requests held to
   the contiguous oracle (``lm_prefill``, then ``lm_decode_step``) under
   phase 12's token-margin rule; (c) Jamba-v0.1 at a quarter of its
   width (d_model 1024, 8 heads over 2 of 128, 16 experts top-2 of width
   3584 every other layer, Mamba2 expand 2, state 16, head 64, vocab
   65536), one period of 8 layers: its attention op held as in (a),
   step 0 against plain, 3 steps at
   S=2048 x 2, then its prefill at S=256 against 256 decode steps, fp32
   held to the reference's tolerance, bf16 reported;
14. the enc-dec and VLM families and AdamW's reduced-precision moments
   (slice 15's main path), in a child process (``--a10 OUT``) with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and deterministic algorithms
   (``warn_only``), so that the plain path step 0 is held to repeats: (a)
   SeamlessM4T-medium as published (12 + 12 layers, d_model 1024, 16
   heads of 64, d_ff 4096, vocab 256206; 978,384,896 parameters, the
   seeded init drawn on the CPU and timed) on the cluster-sparse
   backend under "block", bf16 compute, fp32 parameters and moments: 8
   utterances of 1024 seeded N(0, 1) frames (the stub frontend's
   embeddings) and 512 target tokens; layer 0's attention op of the
   encoder (non-causal, S=1024, a full 8 x 8 layout) and of the decoder
   (causal, S=512), rows 2, 5 and 6 against their plain versions as in
   phase 11; step 0 against ``impl="plain"`` (the loss, every
   gradient's cosine and its norm ratio); 2 steps through
   ``BatchFnTask`` and ``Trainer``, rows 2, 5 and 6 launched exactly 48,
   24 and 24 times a step and nothing else; step ms, frames and target
   tokens a second, peak memory, a profiled step; then the encoder run
   once into the cross caches and 64 ``encdec_decode_step``s over the
   batch, the last logits against ``encdec_forward``'s: fp32 (fp32
   caches) gated at the reference test's atol 0.15 / rtol 0.05 and
   argmax, bf16 reported; ms a decode step. (b) InternVL2-76B at full
   width (d_model 8192, 64 heads over 8 of 128, d_ff 28672, vocab
   128256, 256 patches), its depth cut to 1 of 80 layers (3,028,312,064
   parameters, the seeded init drawn on the card and timed): batch 1,
   S = 256 patches + 3840 tokens; its attention
   op and step 0 held as in (a); from the same init (kept on the card)
   and batches, 3 steps at a peak learning rate of 3e-4 under each of
   AdamW's moment dtypes (float32, bfloat16, int8): the losses side by
   side, peak memory, the update's ms by CUDA events, rows 2, 5 and 6
   launched 2, 1 and 1 times a step; the bf16 and int8 updates of step 1
   held to the port's AdamW on the CPU from the same parameters and
   gradients, on the first 2^20 elements of every reference leaf. Step
   0's gradients are held to the plain path directly, or, for a
   gradient whose bf16 plain version is itself that far from the fp32
   plain one (SeamlessM4T's last encoder layers' wq and wk), by their
   distance from the fp32 gradient (``FP32_DISTANCE_FACTOR``). The
   training runs take ``max_bad_steps=0``: no re-init rung, so no host
   copy of the parameters.
15. graph parallelism (slice 16's main path), in a child process
   (``--graph-parallel OUT``) that spawns two ranks sharing this card
   (started, with (j)'s three, ahead of the phase's turn, each waiting
   for it on a gate file once its start-up is done)
   over gloo (``torch.distributed``; gloo moves the collectives' CUDA
   tensors through the host, so their times are host staging, not
   NVLink): (a) ``sharded_cluster_attention`` at Graphormer-Large's
   width (32 heads of 24) on phase 5's 8192-node graph, bf16, a random
   nonzero bias table sharded by head: each rank's O, dq, dk, dv and the
   table's gradient (summed over the ranks) held to the unsharded kernel
   call (O element by element at TOL_O_ELEM, the gradients at TOL_GRAD)
   and to the unsharded ``impl="plain"`` call (TOL_O, TOL_GRAD); the
   all-to-all bytes of a forward against ``cluster_a2a_budget``; the
   sharded forward timed, and the all-to-alls' share of it by CUDA
   events; (b) Graphormer-Large (GP_TRAIN_LAYERS layers, full width, bf16)
   node training through ``NodeTask`` and the Trainer on a (1, 2) mesh,
   4 steps, dense at 0, the layout frozen: first the P = 1 run on rank 0
   (the other rank waiting), the sparse and the dense step's loss and
   gradients at the init held to it (TOL_STEP_LOSS_REL, MIN_GRAD_COSINE),
   every rank's losses held to it (TOL_STEP_LOSS_REL); (c) Qwen3-0.6B at
   full width, 4 of its 28 layers (GP_LM_LAYERS), on the cluster-sparse
   backend under Ulysses, S=16384, 2 steps, held to its P = 1 run
   (TOL_LM_STEP_LOSS_REL), the inits drawn on the card. Then the rest of
   the mesh (slice 17's paths, ``mesh_runs``) on the same two ranks: (d)
   GT graph-level at full width (128 graphs of S=128 at 16 x 16 blocks)
   on a (2, 1) data mesh and on the (1, 2) model mesh and (e) GT link
   on the 2048-node SBM at 32 x 32 on the model mesh, 4 steps each with
   the dense step at 0 and 2, held to the P = 1 run (the init step's
   loss and gradients at a cosine of MESH_MIN_GRAD_COSINE, the losses at
   TOL_STEP_LOSS_REL), the model mesh's attention op held to
   ``impl="plain"`` (``op_check``); (f) the expert-parallel MoE op at
   Qwen3-235B-A22B's width, bf16, 4096 tokens: at capacity factor 16
   (= E/k, nothing drops) y and every gradient held to the single-rank
   dropless op, at 1.25 the dropped pairs held to a host recount, each
   rank's peak and forward + backward ms; (g) Qwen3-235B-A22B, one
   layer, each rank holding 64 of the 128 experts, 2 steps at S=2048
   under Ulysses and expert parallelism with int8 moments (fp32 ones do
   not fit two ranks on one card), its attention op held to plain, the
   losses finite and falling; (h) ``ServeEngine(mesh_model=2)``:
   Qwen3-0.6B in fp32, 4 requests, 32 new tokens, against the P = 1
   engine (a token may flip only at a top-2 margin below
   MESH_TOKEN_MARGIN), then (g)'s weights served (4 requests of
   128-1024 tokens), tokens a second and each rank's pool bytes; (i) the
   int8 and top-k all-reduces of GT's gradients against the exact mean
   and a 2-stage pipeline of GT's fp32 layers against the sequential
   apply. Then slice 18's paths (``family_runs``), each held to its P = 1
   run on rank 0 (the init step's loss, every gradient's cosine after
   the Trainer's all-reduce, the losses), its attention op to
   ``impl="plain"``: (k) Mamba2-2.7B at full width, 4 of 64 layers,
   S=8192, its 80 SSM heads split over the ranks; (l) SeamlessM4T-medium
   at full width, 4 + 4 of 12 + 12 layers, phase 14 (a)'s batch on the
   cluster-sparse backend (the encoder non-causal, the decoder causal);
   (m) InternVL2-76B at full width, one layer, 256 patches + 3840
   tokens, int8 moments; (n) Jamba-v0.1 at phase 13 (c)'s quarter width,
   one period, its MoE slots expert parallel at capacity E/k; each one
   step on one batch; (o) an expert-parallel MoE (the
   Qwen3-235B-A22B smoke config with 4 experts, all routed) checkpointed
   at P = 2 and
   resumed at P = 2 (bitwise) and P = 1 (within FAM_CKPT_TOL), under
   deterministic algorithms. Beside them, in three ranks of their own
   started with the two, (j) GT graph-level at (d)'s shape on a (1, 3)
   model mesh, whose 8 heads and 128 tokens do not split 3 ways: every
   rank runs the unsharded op on the whole sequence (the reference's
   GSPMD fallback), held as (d).
   Each rank's launches of rows 1, 3, 4 in (b), (d), (e) and (j) and 2,
   5, 6 in (c), (g), (l), (m) and (n) are counted exactly; step ms, the
   collectives' ms by CUDA events and peak memory per rank.

Each main path runs with every kernel's launch count set to 0 just
before it and read just after. Every training path's counts are exact:
each sparse step launches dQ and dK/dV once a layer and the forward
once, or twice when ``cfg.remat`` is not "none" (the backward recomputes
the layer); serving runs without grad and recomputes nothing.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, dense bf16
# tensor-core rate, fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# exp2 results a clock on one SM (the special-function units): the floor
# under kernels that take one exponential per score
EX2_PER_CLOCK_PER_SM = 16

# tolerances, kernel vs plain on identical inputs. O: one bf16 rounding
# of values near 1 (2e-2), fp32 sums in another order (2e-5). lse: fp32.
TOL_O = {"bfloat16": 2e-2, "float32": 2e-5}
TOL_LSE = 1e-4
# the unbiased (LM) forward's O, beside TOL_O, element by element:
# |kernel - plain| <= atol + rtol |plain|. Most of its rows average
# thousands of keys, so most |O| lie far below TOL_O's 2e-2. bf16: both
# sides round an fp32 O once, and two roundings of nearly equal values
# differ by at most one bf16 ulp, at most 2^-7 of the value, plus the
# fp32 difference of the sums (atol); fp32: TOL_O
TOL_O_ELEM = {"bfloat16": (1e-5, 2 ** -7), "float32": (2e-5, 2e-5)}
# gradients, backward kernels vs plain backward on identical inputs: max
# |kernel - plain| over max |plain|, per gradient. bf16: one rounding of
# each output (and of each per-q-head dk/dv before the GQA sum); fp32:
# sums in another order
TOL_GRAD = {"bfloat16": 1e-2, "float32": 1e-4}
# one sparse training step at full width, kernel path vs plain path
# through 12 (Graphormer) or 28 (Qwen3) bf16 layers: Graphormer's loss
# within 1e-2 relative, every parameter's gradient at a cosine of at
# least 0.99 with the plain one
TOL_STEP_LOSS_REL = 1e-2
MIN_GRAD_COSINE = 0.99
# the Qwen3 step's loss is a mean over 16384 tokens, so the per-token
# differences of one bf16 rounding average out: within 1e-4 relative
TOL_LM_STEP_LOSS_REL = 1e-4
# served logits, kernel path vs plain path through 12 bf16 layers: max
# difference relative to the largest logit, and argmax agreement
TOL_LOGITS_REL = 5e-2
MIN_ARGMAX_AGREE = 0.98

# kinds of device kernel in a profile, by a substring of the name: the
# port's attention kernels, cuBLAS's matrix products, PyTorch's
# elementwise passes and copies, its reductions (softmax, norms, sums)
KERNEL_KINDS = (
    ("attention kernels", ("cluster", "flash_sm90::", "flash::", "ssd::")),
    ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
    ("elementwise and copies", ("elementwise", "copy", "Functor", "fill")),
    ("reductions", ("reduce", "softmax", "SoftMax", "norm", "scan")))

SERVE_NODES = 32768
YARDSTICK_NODES = 8192
TRAIN_NODES = 8192      # the dense step's fp32 (1, H, S, S) bias must fit
TRAIN_STEPS = 16
TRAIN_LAYERS = 4        # of Large's 12: room for phases 13, 15 (PERF.md 4)
CLUSTERS = 32
QUERIES = 64
LM_SEQ = 16384          # Qwen3-0.6B training sequence (window 4096)
LM_STEPS = 4
# the graph-level task: synthetic_graph_level_dataset (60-119 nodes a
# graph, so S=128 at 16 x 16 blocks) in mini-batches of 128 graphs
GRAPH_TRAIN = 256       # training graphs (seed 1)
GRAPH_EVAL = 64         # held-out graphs (seed 2)
GRAPH_BATCH = 128       # graphs a mini-batch
GRAPH_STEPS = 16        # GT
SLIM_GRAPH_STEPS = 8    # Graphormer-Slim
# the link task: the launcher's SBM (4 clusters, p_in 0.04, p_out 0.002)
# phases 8 and 9 also time the trainer's sparse step under "none" and
# "block" in the same run: rounds of each, steps of each a round, and
# the steps of a short Trainer loop of each a round
STEP_AB_ROUNDS = 2      # cut from 4: room for phase 15
STEP_AB_REPS = 4
STEP_AB_LOOP_STEPS = 5
LINK_NODES = 2048
LINK_PAIRS = 256
LINK_STEPS = 16


def log(msg: str) -> None:
    print(msg, flush=True)


# a child phase is started ahead of its turn (``--warm``): it imports
# torch and the port and initialises CUDA while the phase before it runs,
# then waits for the parent's line on its standard input
WARM_FLAG = "--warm"


def await_turn(torch) -> None:
    """In a child started with ``--warm``: initialise CUDA, then wait for
    the parent to give this phase its turn (a line on standard input);
    the parent ending without one ends the child. Without the flag (a
    phase run alone) it returns at once."""
    if WARM_FLAG not in sys.argv[3:]:
        return
    torch.cuda.init()
    if not sys.stdin.readline():
        sys.exit(3)


class ChildPhase:
    """One child phase, ``chip_smoke.py FLAG OUT --warm``, started ahead
    of its turn so that its interpreter, torch and port imports and CUDA
    initialisation overlap the phase before it. ``run`` gives it its turn,
    waits for its exit and returns its JSON record and the seconds from
    its turn to its exit."""

    def __init__(self, flag: str, env: dict, name: str):
        import tempfile

        self.name = name
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_")
        self.path = os.path.join(self.dir, "out.json")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, self.path,
             WARM_FLAG], stdin=subprocess.PIPE, text=True,
            env=dict(os.environ, **env))

    def run(self, timeout: float):
        import shutil

        t0 = time.perf_counter()
        try:
            try:
                self.proc.stdin.write("go\n")
                self.proc.stdin.close()
            except BrokenPipeError:      # it ended early: its code says why
                pass
            try:
                rc = self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
                raise
            wall = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"{self.name} exited {rc}")
            with open(self.path) as fh:
                return json.load(fh), wall
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)


def timed_call(fn):
    """``(fn(), ms)``: one call of ``fn`` between two CUDA events, no
    warm-up: a plain version whose checking call is its timing too."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def cuda_ms(fn, reps, warm=True):
    """Median of ``reps`` CUDA-event timings of ``fn`` (after one warm-up
    call unless ``warm`` is false), in ms."""
    import numpy as np
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_breakdown(fn, wall_ms, tag="serve", what="one forward",
                     focus=None):
    """Device time of one ``fn()`` by kernel name (torch.profiler),
    and the busy share of ``wall_ms``; the time by kind of kernel
    (``KERNEL_KINDS``: the first kind whose substring the name
    holds); with ``focus`` (a substring of kernel names) also the
    time and share of the kernels it names. None when the profiler
    shows no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []   # device-side events only: CPU ops would count twice
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and \
                e.self_device_time_total > 0:
            rows.append((e.self_device_time_total / 1e3, e.key))
    if not rows:
        log(f"[{tag}] profiler: no device time (not measured)")
        return None
    rows.sort(reverse=True)
    total = sum(ms for ms, _ in rows)
    log(f"[{tag}] profiler: device time {total:.3f} ms in {what} "
        f"of {wall_ms:.3f} ms wall ({total / wall_ms:.1%} busy)")
    for ms, name in rows[:8]:
        log(f"[{tag}]   {ms:9.3f} ms {ms / total:6.1%}  {name[:90]}")
    kinds = {}
    for ms, name in rows:
        kind = next((k for k, subs in KERNEL_KINDS
                     if any(x in name for x in subs)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    log(f"[{tag}] by kind: " + ", ".join(
        f"{k} {ms:.3f} ms ({ms / total:.1%})" for k, ms in sorted(
            kinds.items(), key=lambda kv: -kv[1])))
    rec = {"device_ms": total, "busy_share": total / wall_ms,
           "top": [[name[:90], ms] for ms, name in rows[:8]],
           "by_kind_ms": kinds}
    if focus:
        rec["focus_ms"] = {name[:90]: ms for ms, name in rows
                           if focus in name}
        fms = sum(rec["focus_ms"].values())
        rec["focus_share"] = fms / total
        log(f"[{tag}] kernels named *{focus}*: {fms:.3f} ms, "
            f"{fms / total:.1%} of device time")
    return rec


# ---------------------------------- the flash and SSD kernels (rows 7-10)

FLASH_SEQ = 16384     # Qwen3-0.6B's training shape, dense causal
SSD_SEQ = 16384       # Mamba2-2.7B's shape at the same length
# SSD, kernel vs plain: y as max|diff| over max|plain| (bf16: one rounding
# of the output; fp32: sums in another order), the fp32 state likewise
TOL_SSD_Y = {"bfloat16": 2e-2, "float32": 1e-4}
TOL_SSD_STATE = 1e-4


def _dtype_name(t) -> str:
    return str(t.dtype).split(".")[1]


def _rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def flash_entries(Sq: int, Sk: int, causal: bool) -> int:
    """Score entries one head needs: every (q, k) pair, or with the causal
    mask the pairs with qpos >= kpos."""
    if not causal:
        return Sq * Sk
    n = min(Sq, Sk)
    return n * (n + 1) // 2 + max(Sq - Sk, 0) * Sk


def flash_bound(kind, q, k, causal):
    """Least time of one flash kernel: each input read once, each output
    written once, and the arithmetic of the score entries the function
    needs at the peak rate of q's dtype. Forward: q, k, v in, O and lse
    out, 4 flop per entry per Dh (scores, PV). dQ: q, k, v, dO, lse,
    delta in, dq out, 6 (scores, dp, dq). dK/dV: the same inputs,
    per-q-head dk and dv out, 8 (scores, dp, dv, dk). Returns (ms,
    "bytes" | "operations")."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    elt = q.element_size()
    rows = B * H * Sq * 4
    qkv_b = (q.numel() + 2 * k.numel()) * elt
    if kind == "fwd":
        n_bytes, per = qkv_b + q.numel() * elt + rows, 4.0
    elif kind == "dq":
        n_bytes, per = qkv_b + 2 * q.numel() * elt + 2 * rows, 6.0
    else:
        n_bytes = qkv_b + q.numel() * elt + 2 * rows + 2 * B * Sk * H * Dh \
            * elt
        per = 8.0
    flops = per * B * H * flash_entries(Sq, Sk, causal) * Dh
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[_dtype_name(q)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_bound(x, b, chunk):
    """Least time of the SSD scan: x, dt, a, b, c read once, y and the
    final state written once, and the arithmetic the function needs at
    the peak rate of x's dtype: C B^T over each chunk's lower triangle
    once per (batch, chunk) (the heads share b and c), and per head the
    intra-chunk product over the lower triangle, C S^T and the state
    update (2 flop per multiply-add). Returns (ms, "bytes" |
    "operations")."""
    B, S, H, dh = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    tri = Q * (Q + 1) // 2
    elt = x.element_size()
    n_bytes = (2 * x.numel() + 2 * b.numel()) * elt + B * S * H * 4 + H * 4 \
        + B * H * dh * N * 4
    flops = 2.0 * (B * nc * tri * N + B * H * nc * tri * dh
                   + 2 * B * H * S * N * dh)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[_dtype_name(x)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _flash_inputs(dev, dtype, B, Sq, Sk, H, KV, Dh, seed):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((B, Sq, H, Dh), (B, Sk, KV, Dh), (B, Sk, KV, Dh),
                          (B, Sq, H, Dh))]


def _ssd_inputs(dev, dtype, B, S, H, dh, N, seed):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, S, H, dh, generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=gen, device=dev) - 2)
    a = -torch.exp(torch.randn(H, generator=gen, device=dev) * 0.3)
    b = torch.randn(B, S, N, generator=gen, device=dev).to(dtype)
    c = torch.randn(B, S, N, generator=gen, device=dev).to(dtype)
    return x, dt, a, b, c


def compare_flash(tag, q, k, v, dout, kw):
    """The flash forward kernel against the plain forward (O, lse), then
    the dQ and dK/dV kernels against the plain dQ and dK/dV on the
    forward kernel's O and lse and ``dout``: O held to TOL_O and, element
    by element, to TOL_O_ELEM; dq and the per-q-head dk and dv as
    max|diff| over max|plain| to TOL_GRAD. Each plain half's one call is
    timed (``timed_call``: 2-4 s a call at S=16384, so it is not called
    again to be timed). Returns the max abs errors {"fwd", "dq", "dkv"},
    the backward's operands and the plain halves' ms {"fwd", "dq",
    "dkv"}."""
    import torch
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref

    dt = _dtype_name(q)
    o, lse = tfa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    (po, plse), fwd_ms = timed_call(
        lambda: ref.flash_fwd(q, k, v, return_lse=True, **kw))
    diff = (o.float() - po.float()).abs()
    atol, rtol = TOL_O_ELEM[dt]
    share = (diff / (atol + rtol * po.float().abs())).max().item()
    err, lerr = diff.max().item(), (lse - plse).abs().max().item()
    del diff
    ok = torch.allclose(o.float(), po.float(), atol=TOL_O[dt],
                        rtol=TOL_O[dt]) and share <= 1.0 and torch.allclose(
        lse, plse, atol=TOL_LSE, rtol=1e-5) and bool(torch.isfinite(o).all())
    del po, plse
    delta = ref.row_delta(dout, o)
    ops_ = [tfa.aligned(x) for x in (q, k, v, dout)]
    flags = (kw["causal"], kw["hoist_scale"])
    before = (tfa.dq_launches, tfa.dq_sm90_launches)
    got = (tfa.dq_kernel(*ops_, lse, delta, *flags),)
    bf16 = q.dtype == torch.bfloat16
    if (tfa.dq_launches, tfa.dq_sm90_launches) != (before[0] + (not bf16),
                                                   before[1] + bf16):
        raise AssertionError(f"the {dt} dQ launch went to the other dtype's "
                             f"kernel: {tag}")
    got += tfa.dkv_kernel(*ops_, lse, delta, *flags)
    want_dq, dq_ms = timed_call(
        lambda: ref.flash_bwd_dq(q, k, v, dout, lse, delta, **kw))
    want_dkv, dkv_ms = timed_call(
        lambda: ref.flash_bwd_dkv(q, k, v, dout, lse, delta, **kw))
    want = (want_dq,) + want_dkv
    rels = [_rel(x, y) for x, y in zip(got, want)]
    errs = [(x.float() - y.float()).abs().max().item()
            for x, y in zip(got, want)]
    ok = ok and all(r <= TOL_GRAD[dt] for r in rels) and all(
        bool(torch.isfinite(x).all()) for x in got)
    log(f"[flash-kernel] {tag} {dt} ({kw['block_q']}x{kw['block_k']}"
        f"{', hoist_scale' if kw['hoist_scale'] else ''}): max|dO|={err:.3g}"
        f", worst element at {share:.3g} of {atol:g} + {rtol:g}|O|, "
        f"max|dlse|={lerr:.3g}; rel dq {rels[0]:.3g} dk {rels[1]:.3g} dv "
        f"{rels[2]:.3g} (tol {TOL_GRAD[dt]}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions: {tag} {dt}")
    del got, want, want_dq, want_dkv
    return ({"fwd": err, "dq": errs[0], "dkv": max(errs[1], errs[2])},
            (o, lse, delta, ops_), {"fwd": fwd_ms, "dq": dq_ms,
                                    "dkv": dkv_ms})


def compare_ssd(tag, x, dt, a, b, c, chunk):
    """The SSD kernel against ``ssd_chunked``: y and the final state as
    max|diff| over max|plain| within TOL_SSD_Y and TOL_SSD_STATE. Returns
    the max abs error of y."""
    import torch
    from repro_torch.kernels import ssd as tks
    from repro_torch.models.ssm import ssd_chunked

    name = _dtype_name(x)
    y, state = tks.ssd_fwd(x, dt, a, b, c, chunk=chunk)
    py, pstate = ssd_chunked(x, dt, a, b, c, chunk)
    torch.cuda.synchronize()
    ry, rs = _rel(y, py), _rel(state, pstate)
    ok = ry <= TOL_SSD_Y[name] and rs <= TOL_SSD_STATE and bool(
        torch.isfinite(y).all())
    log(f"[ssd-kernel] {tag} {name} (chunk {chunk}): rel y {ry:.3g} (tol "
        f"{TOL_SSD_Y[name]}), rel state {rs:.3g} (tol {TOL_SSD_STATE}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"SSD kernel disagrees with ssd_chunked: {tag} "
                             f"{name}")
    return (y.float() - py.float()).abs().max().item()


def flash_yardstick(dev, dtype):
    """One ``scaled_dot_product_attention(is_causal=True,
    enable_gqa=True)`` at the flash kernels' full-width shape on the same
    inputs (the same function), on PyTorch's own pick of backend: its
    forward, and its backward (dq, dk and dv together: no library call
    computes one alone). Returns {library_ms, library_bwd_ms,
    library_max_abs_diff_vs_plain} or the error it hit."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref

    q, k, v, dout = _flash_inputs(dev, dtype, 1, FLASH_SEQ, FLASH_SEQ, 16, 8,
                                  128, seed=51)
    rec = {}
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    gout = dout.transpose(1, 2)
    try:
        with torch.no_grad():
            so = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                enable_gqa=True)
        po = ref.flash_fwd(q, k, v, causal=True, block_q=128, block_k=128)
        rec["library_max_abs_diff_vs_plain"] = (
            so.transpose(1, 2).float() - po.float()).abs().max().item()
        del so, po
        rec["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(
                *(x.detach() for x in leaves), is_causal=True,
                enable_gqa=True), 5)
        og = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                            enable_gqa=True)
        rec["library_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
            og, leaves, gout, retain_graph=True), 5)
        del og
    except RuntimeError as e:   # out of memory included: recorded
        rec["library_error"] = \
            f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
    log(f"[flash-yardstick] SDPA is_causal enable_gqa S={FLASH_SEQ} "
        f"{_dtype_name(q)}: "
        + (f"fwd {rec['library_ms']:.4f} ms, bwd {rec['library_bwd_ms']:.4f} "
           f"ms, max|O - plain O| {rec['library_max_abs_diff_vs_plain']:.3g}"
           if "library_bwd_ms" in rec
           else rec.get("library_error", "not measured")))
    del q, k, v, dout, leaves, gout
    torch.cuda.empty_cache()
    return rec


def flash_ssd_kernels(dev):
    """Phase 3d: the flash forward, dQ and dK/dV kernels and the SSD scan
    against their plain versions, at full width in bf16 and fp32 (flash:
    Qwen3-0.6B's attention at S=16384, 16 q heads over 8, Dh 128, causal,
    B=1, the default 128 x 128 schedule; SSD: Mamba2-2.7B's 80 heads of
    dh 64, N 128, chunk 256, S=16384, B=1, x/b/c in the dtype, dt and a
    fp32), each kernel and each plain half timed, the SDPA yardstick
    (``flash_yardstick``, bf16) beside the flash kernels; then small
    cases. Returns {dtype: {half: record}}."""
    import torch
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as tks
    from repro_torch.models.ssm import ssd_chunked

    rec = {}
    kw = {"causal": True, "block_q": 128, "block_k": 128,
          "hoist_scale": False}
    tfa.reset_count()
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[1]
        q, k, v, dout = _flash_inputs(dev, dtype, 1, FLASH_SEQ, FLASH_SEQ,
                                      16, 8, 128, seed=51)
        errs, (o, lse, delta, (qa, ka, va, da)), plain_ms = compare_flash(
            "Qwen3-0.6B attention, S=16384, causal", q, k, v, dout, kw)
        runs = {
            "fwd": lambda: tfa.flash_attention_fwd(q, k, v, return_lse=True,
                                                   **kw),
            "dq": lambda: tfa.dq_kernel(qa, ka, va, da, lse, delta, True,
                                        False),
            "dkv": lambda: tfa.dkv_kernel(qa, ka, va, da, lse, delta, True,
                                          False)}
        rec[dt] = {}
        for half, kern in runs.items():
            r = rec[dt][half] = {"max_abs_err": errs[half]}
            r["ms"] = cuda_ms(kern, 5)
            # the check's own call, unwarmed (2-4 s a call)
            r["plain_ms"] = plain_ms[half]
            r["bound_ms"], r["bound_by"] = flash_bound(half, q, k, True)
            log(f"[flash-kernel] S={FLASH_SEQ} {dt} {half}: kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"{r['bound_ms'] / r['ms']:.2%} of bound")
        del q, k, v, dout, o, lse, delta, qa, ka, va, da
        torch.cuda.empty_cache()
        if dtype == torch.bfloat16:
            rec[dt].update(flash_yardstick(dev, dtype))
        x, dtv, a, b, c = _ssd_inputs(dev, dtype, 1, SSD_SEQ, 80, 64, 128,
                                      seed=52)
        r = rec[dt]["ssd"] = {"max_abs_err": compare_ssd(
            "Mamba2-2.7B, S=16384", x, dtv, a, b, c, 256)}
        r["ms"] = cuda_ms(lambda: tks.ssd_fwd(x, dtv, a, b, c, chunk=256), 5)
        r["plain_ms"] = cuda_ms(lambda: ssd_chunked(x, dtv, a, b, c, 256), 2)
        r["bound_ms"], r["bound_by"] = ssd_bound(x, b, 256)
        # device time of each of the scan's four kernels, a mean over the
        # launches the profiler caught in three calls (it may miss the
        # first kernels of a session)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                tks.ssd_fwd(x, dtv, a, b, c, chunk=256)
            torch.cuda.synchronize()
        r["ms_by_kernel"] = {}
        for name in ("ssd_cb", "ssd_states", "ssd_scan", "ssd_y"):
            evs = [e for e in prof.key_averages()
                   if f"{name}<" in e.key or f"{name}(" in e.key]
            r["ms_by_kernel"][name] = sum(
                e.device_time_total for e in evs) / max(
                1, sum(e.count for e in evs)) / 1e3
        parts = ", ".join(f"{k} {v:.4f}" for k, v in
                          r["ms_by_kernel"].items())
        log(f"[ssd-kernel] S={SSD_SEQ} {dt}: kernel {r['ms']:.4f} ms "
            f"({parts}), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.2%} of bound")
        del x, dtv, a, b, c
        torch.cuda.empty_cache()

    for i, dtype in enumerate((torch.bfloat16, torch.float32)):
        for j, (tag, B, Sq, Sk, H, KV, Dh, causal, bq, bk, hoist) in \
                enumerate((
                    ("non-causal S=2048, H=16 KV=8 Dh=128", 1, 2048, 2048,
                     16, 8, 128, False, 128, 128, False),
                    ("ragged S=1000, H=4 KV=2 Dh=64", 1, 1000, 1000, 4, 2,
                     64, True, 128, 128, False),
                    ("Dh 32, B=2, S=512, H=4 KV=4", 2, 512, 512, 4, 4, 32,
                     True, 128, 128, True),
                    ("Dh 64, B=2, Sq=300 Sk=500, H=8 KV=2", 2, 300, 500, 8,
                     2, 64, True, 64, 256, True),
                    ("the tuner's default case, S=256 H=4 Dh=32", 1, 256,
                     256, 4, 4, 32, True, 128, 128, False),
                    ("cancellation, S=4096, H=16 KV=8 Dh=128", 1, 4096,
                     4096, 16, 8, 128, True, 128, 128, False))):
            q, k, v, dout = _flash_inputs(dev, dtype, B, Sq, Sk, H, KV, Dh,
                                          seed=60 + 10 * i + j)
            compare_flash(tag, q, k, v, dout,
                          {"causal": causal, "block_q": bq, "block_k": bk,
                           "hoist_scale": hoist})
        for j, (tag, B, S, H, dh, N, chunk) in enumerate((
                ("the tuner's default case, 2 heads dh 8 N 4", 1, 256, 2, 8,
                 4, 256),
                ("B=2, 3 heads dh 64 N 128", 2, 512, 3, 64, 128, 128),
                ("chunk 48, dh 16 N 20", 1, 96, 2, 16, 20, 48),
                ("B=2, 4 heads dh 40 N 100, chunk 512", 2, 2048, 4, 40, 100,
                 512),
                ("B=2, 2 heads dh 24 N 16, chunk 64", 2, 1024, 2, 24, 16,
                 64))):
            compare_ssd(tag, *_ssd_inputs(dev, dtype, B, S, H, dh, N,
                                          seed=80 + 10 * i + j), chunk)
    torch.cuda.empty_cache()
    # every bf16 forward, dQ and dK/dV launch above ran the tensor-core
    # kernels
    rec["launches"] = {"fwd": tfa.launches, "fwd_sm90": tfa.sm90_launches,
                       "dq": tfa.dq_launches,
                       "dq_sm90": tfa.dq_sm90_launches,
                       "dkv": tfa.dkv_launches,
                       "dkv_sm90": tfa.dkv_sm90_launches}
    log(f"[flash-kernel] phase 3d launches {rec['launches']}")
    if not (tfa.sm90_launches > 0 and tfa.dq_sm90_launches > 0
            and tfa.dkv_sm90_launches > 0):
        raise AssertionError("phase 3d did not launch the bf16 tensor-core "
                             "flash kernels")
    return rec


def tune_phase(dev, reset_counts, read_counts):
    """Phase 7, the slice's main path: the autotuner on the card, as
    ``python -m repro_torch.tune`` runs it (wall-clock search of every op
    on its default case, the cluster op's over its rewrites on the fp32
    kernels of rows 1, 3, 4), then the full-width
    cases (flash: S=16384, 16 heads, Dh 128, self-attention; SSD:
    S=16384, 80 heads, dh 64, N 128), then ``check_regression`` of the
    cluster entry (the reference's check) and of the full-width flash
    and SSD winners. Every winner is gated
    kernel-vs-plain; the table and BENCH file go to a temporary
    directory, and dispatch of CUDA tensors must read the card's winners
    back from the table. The kernels' launch counts are set to 0 just
    before and read just after; rows 7-10 must each have launched."""
    import tempfile

    import torch
    from repro_torch.tune import cases, runtime, search
    from repro_torch.tune.schedule import Schedule

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    table, records = search.tune_all(device=dev, log=log)
    full = [cases.flash_case(FLASH_SEQ, heads=16, d_head=128, device=dev),
            cases.ssd_case(SSD_SEQ, heads=80, d_head=64, n_state=128,
                           device=dev)]
    for case in full:
        winner, rec = search.tune_op(case["op"], case=case, log=log)
        table.put(rec["bucket"], winner, source=rec["source"],
                  mode=rec["mode"], fwd_us=rec["fwd_us"],
                  bwd_us=rec["bwd_us"], default_fwd_us=rec["default_fwd_us"],
                  default_bwd_us=rec["default_bwd_us"])
        records.append(rec)
    # the reference's check (the cluster op's default case: its winner
    # among the four launches of hoist_scale x fuse_bias against the
    # default, 5 rounds of 20 calls a side), and the same
    # check of the full-width flash and SSD winners (3 rounds of 3 calls
    # a side)
    checks = [search.check_regression(table, device=dev, iters=20, rounds=5,
                                      log=log)]
    checks += [search.check_regression(table, op=case["op"], case=case,
                                       device=dev, iters=3, rounds=3,
                                       log=log) for case in full]
    del full, case
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, runtime.DEFAULT_TABLE_PATH)
        table.save(path)
        with open(os.path.join(tmp, "BENCH_autotune_torch.json"), "w") as fh:
            json.dump({"schema": list(search.AUTOTUNE_SCHEMA),
                       "backend": table.backend, "records": records,
                       "checks": checks}, fh)
        if not runtime.refresh(path):
            raise AssertionError("the winner table did not load back")
        for rec in records:
            got = runtime.lookup(rec["op"], rec["bucket"], device_type="cuda")
            if got != Schedule.from_json(rec["schedule"]):
                raise AssertionError(f"CUDA dispatch resolved {got} for "
                                     f"{rec['bucket']}, not the winner")
        runtime.reset()
    for rec in records:
        log(f"[tune] {rec['bucket']}: "
            f"{Schedule.from_json(rec['schedule']).describe()} ({rec['mode']}"
            f"), fwd {rec['fwd_us']} us, fwd+grads {rec['bwd_us']} us; "
            f"default {rec['default_fwd_us']} / {rec['default_bwd_us']} us; "
            f"speedup {rec['speedup']}x")
    rows = ("flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv", "ssd_fwd")
    log(f"[tune] {seconds:.1f}s, peak {peak / 2**30:.2f} GiB, table gated "
        f"on {table.backend}, launches "
        f"{ {n: c for n, c in counts.items() if c} }")
    if not all(counts[n] > 0 for n in rows):
        raise AssertionError(f"the tune phase did not launch every kernel of "
                             f"rows 7-10: {counts}")
    if not all(c["ok"] for c in checks):
        raise AssertionError(f"a tuned schedule regressed: {checks}")
    return {"launches": counts, "records": records, "checks": checks,
            "seconds": seconds, "peak_bytes": peak,
            "backend": table.backend}


def kernel_counters():
    """``(reset, read)`` over every kernel wrapper's launch counter."""
    from repro_torch.kernels import cluster_attention as tca
    from repro_torch.kernels import cluster_attention_bwd as tcab
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ssd as tks

    def reset():
        for mod in (tca, tcab, tfa, tks):
            mod.reset_count()

    def read():
        return {"cluster_attention_fwd": tca.launches,
                "cluster_attention_fwd_sm90": tca.sm90_launches,
                "cluster_attention_fwd_sm90_b16": tca.sm90_b16_launches,
                "cluster_attention_bwd_dq": tcab.dq_launches,
                "cluster_attention_bwd_dq_sm90": tcab.dq_sm90_launches,
                "cluster_attention_bwd_dq_sm90_b16":
                    tcab.dq_sm90_b16_launches,
                "cluster_attention_bwd_dkv": tcab.dkv_launches,
                "cluster_attention_bwd_dkv_sm90": tcab.dkv_sm90_launches,
                "cluster_attention_bwd_dkv_sm90_b16":
                    tcab.dkv_sm90_b16_launches,
                "cluster_attention_fwd_unbiased": tca.unbiased_launches,
                "cluster_attention_fwd_unbiased_sm90":
                    tca.unbiased_sm90_launches,
                "cluster_attention_bwd_dq_unbiased":
                    tcab.dq_unbiased_launches,
                "cluster_attention_bwd_dkv_unbiased":
                    tcab.dkv_unbiased_launches,
                "cluster_attention_bwd_dq_unbiased_sm90":
                    tcab.dq_unbiased_sm90_launches,
                "cluster_attention_bwd_dkv_unbiased_sm90":
                    tcab.dkv_unbiased_sm90_launches,
                "flash_attention_fwd": tfa.launches,
                "flash_attention_bwd_dq": tfa.dq_launches,
                "flash_attention_bwd_dkv": tfa.dkv_launches,
                "flash_attention_fwd_sm90": tfa.sm90_launches,
                "flash_attention_bwd_dq_sm90": tfa.dq_sm90_launches,
                "flash_attention_bwd_dkv_sm90": tfa.dkv_sm90_launches,
                "ssd_fwd": tks.launches}

    return reset, read


B16_NAMES = ("cluster_attention_fwd_sm90_b16",
             "cluster_attention_bwd_dq_sm90_b16",
             "cluster_attention_bwd_dkv_sm90_b16")
B32_NAMES = ("cluster_attention_fwd_sm90", "cluster_attention_bwd_dq_sm90",
             "cluster_attention_bwd_dkv_sm90")
UNBIASED_NAMES = ("cluster_attention_fwd_unbiased_sm90",
                  "cluster_attention_bwd_dq_unbiased_sm90",
                  "cluster_attention_bwd_dkv_unbiased_sm90")
# the same rows' fp32 CUDA-core kernels
UNBIASED_F32_NAMES = ("cluster_attention_fwd_unbiased",
                      "cluster_attention_bwd_dq_unbiased",
                      "cluster_attention_bwd_dkv_unbiased")


def step_launches(cfg, names, steps: int = 1, layers: int = 0) -> dict:
    """Exact launches of ``steps`` training steps' attention kernels
    ``names`` (forward, dQ, dK/dV): each once an attention layer (every
    layer unless ``layers`` says how many), and the forward once more
    when the layers are recomputed in the backward (``cfg.remat`` other
    than "none", in every family)."""
    fwd, dq, dkv = names
    n = steps * (layers or cfg.n_layers)
    return {fwd: n if cfg.remat == "none" else 2 * n, dq: n, dkv: n}


def checkpoint_start(tr, tag):
    """The first half of ``checkpoint_costs``: one rescue refresh and one
    host copy of the parameters (what ``run()`` takes for the re-init
    rung), then one async save of ``tr``'s state (the snapshot, the part
    that blocks the loop), whose background compress-and-write goes on
    while the caller works; a watcher thread stamps the write's end.
    Returns the handle ``checkpoint_finish`` takes."""
    import tempfile
    import threading

    import torch
    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.resilience.chaos import state_of
    from repro_torch.runtime.trainer import host_copy

    t0 = time.perf_counter()
    tr.rescue_copy()
    t1 = time.perf_counter()
    host_copy(tr.params)
    t2 = time.perf_counter()
    want = state_of(tr)
    d = tempfile.mkdtemp(prefix="ckpt-")
    ck = Checkpointer(d)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    sd = tr.task.state_dict()
    ck.save(tr.steps_done, tr.state_tree(),
            extra={"task": sd} if sd else None)
    t4 = time.perf_counter()
    done = {}

    def watch():
        try:
            ck.wait()
        except BaseException as err:   # re-raised by checkpoint_finish
            done["error"] = err
        done["t"] = time.perf_counter()
    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    return {"tag": tag, "dir": d, "ck": ck, "want": want,
            "step": tr.steps_done, "watcher": watcher, "done": done,
            "saved_at": t4, "rec": {"codec": ck.codec, "snapshot_s": t4 - t3,
                                    "rescue_s": t1 - t0,
                                    "init_copy_s": t2 - t1}}


def checkpoint_finish(handle, fresh):
    """The second half of ``checkpoint_costs``: the write's seconds (from
    the save to the watcher's stamp), raw bytes and bytes on disk; one
    ``restore_or_init`` of the checkpoint into the Trainer ``fresh(dir)``
    builds (newest verified generation, checksums, the copy onto the
    card), whose parameters and moments must then equal the saved state
    bit for bit; ``fresh`` builds its own model, whose parameters must
    differ from the saved ones before the restore, so the check covers
    them. The directory is deleted afterwards."""
    import shutil

    import torch
    from repro_torch.resilience.chaos import bitwise, state_of

    tag, d, want, done = (handle["tag"], handle["dir"], handle["want"],
                          handle["done"])
    rec = handle["rec"]
    try:
        t0 = time.perf_counter()
        handle["watcher"].join()
        rec["waited_s"] = time.perf_counter() - t0
        if "error" in done:
            raise done["error"]
        rec["write_s"] = done["t"] - handle["saved_at"]
        gen = os.path.join(d, f"step_{handle['step']:08d}")
        rec["disk_bytes"] = sum(os.path.getsize(os.path.join(gen, f))
                                for f in os.listdir(gen))
        rec["raw_bytes"] = sum(t.numel() * t.element_size() for t in want)
        other = fresh(d)
        n = len(other.params)
        if bitwise(want[:n], state_of(other)[:n]):
            raise AssertionError(f"{tag}: the fresh Trainer holds the saved "
                                 f"parameters already; the restore check "
                                 f"would not cover them")
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        rec["restored_step"] = other.restore_or_init()
        torch.cuda.synchronize()
        rec["restore_s"] = time.perf_counter() - t3
        rec["bitwise_equal"] = bitwise(want, state_of(other))
        del other
    finally:
        shutil.rmtree(d)
    log(f"[{tag}] checkpoint ({rec['codec']}): save blocks "
        f"{rec['snapshot_s']:.4f} s (snapshot), background write "
        f"{rec['write_s']:.4f} s ({rec['waited_s']:.4f} s of it waited "
        f"for); {rec['raw_bytes']:,} raw bytes of params and moments, "
        f"{rec['disk_bytes']:,} on disk; restore into a fresh Trainer "
        f"{rec['restore_s']:.4f} s (step {rec['restored_step']}, bitwise "
        f"equal {rec['bitwise_equal']}); rescue refresh "
        f"{rec['rescue_s']:.4f} s; host copy of the parameters "
        f"{rec['init_copy_s']:.4f} s")
    if not rec["bitwise_equal"] or rec["restored_step"] != handle["step"]:
        raise AssertionError(f"{tag}: the checkpoint did not restore the "
                             f"state bit for bit (step "
                             f"{rec['restored_step']})")
    return rec


def checkpoint_costs(tr, fresh, tag):
    """What checkpoints cost for ``tr``'s state, waited for at once:
    ``checkpoint_start`` then ``checkpoint_finish``."""
    return checkpoint_finish(checkpoint_start(tr, tag), fresh)


def step_check(model, loss_fn, batch, tag, what="step 0 sparse"):
    """One sparse step's loss and gradients, kernel path vs
    ``impl="plain"`` on the same parameters and batch (outside any run's
    launch counts): loss within TOL_STEP_LOSS_REL, every reached
    parameter's gradient at a cosine of at least MIN_GRAD_COSINE."""
    import torch
    import torch.nn.functional as F

    named = list(model.named_parameters())

    def loss_grads(impl):
        loss, _ = loss_fn(model, batch, impl=impl)
        return loss.detach().float(), torch.autograd.grad(
            loss, [p for _, p in named], allow_unused=True)
    kl, kg = loss_grads(None)
    pl_, pg = loss_grads("plain")
    loss_rel = (abs(kl - pl_) / abs(pl_)).item()
    cos = {n: F.cosine_similarity(a.flatten().float(),
                                  c.flatten().float(), dim=0,
                                  eps=1e-30).item()
           for (n, _), a, c in zip(named, kg, pg) if a is not None}
    worst = min(cos, key=cos.get)
    log(f"[{tag}] {what}, kernel vs plain path: loss "
        f"{kl.item():.6f} vs {pl_.item():.6f} (rel {loss_rel:.3g}, tol "
        f"{TOL_STEP_LOSS_REL}); gradient cosine min {cos[worst]:.6f} "
        f"({worst}; min {MIN_GRAD_COSINE})")
    if not (loss_rel <= TOL_STEP_LOSS_REL
            and cos[worst] >= MIN_GRAD_COSINE):
        raise AssertionError(f"{tag}: kernel and plain paths disagree")
    return {"loss_rel": loss_rel, "min_grad_cosine": [worst, cos[worst]]}


def start_rung_task(*args, **kw):
    """A ``NodeTask`` that prepares only the AutoTuner's start rung, for
    runs whose layout stays frozen (``elastic_every=0``): a run that never
    moves on the ladder trains on that rung alone. The start rung is the
    ladder's densest, so its own ``mb`` and ``mt`` are the capacities the
    whole ladder would pad it to."""
    from repro_torch.tasks import NodeTask

    class StartRungTask(NodeTask):
        def _init_ladder(self, beta_g, delta, device):
            super()._init_ladder(beta_g, delta, device)
            return [self.tuner.beta_thre]
    return StartRungTask(*args, **kw)


# phase 9b: the paper's three systems (and pure sparse) through the port's
# node-classification harness, Graphormer-Slim as published on an SBM of
# NC_NODES nodes; torchgt dense at 0, 8 and 16
NC_NODES = 8192
NC_EPOCHS = {"raw": 6, "flash": 6, "sparse": 18, "torchgt": 18}
NC_PERIOD = 8
# the paper's ordering (Fig 10/11), reported: the reference gates it at
# n=384 on the CPU only
NC_ORDER = {"sparse": 0.02, "raw": 0.10}


def node_classification_runs(dev, reset_counts, read_counts) -> dict:
    """Phase 9b: ``launch.node_classification.GraphTrainBench`` with
    Graphormer-Slim's published config (4 layers, d 64, 8 heads of 8,
    bf16) on its SBM of NC_NODES nodes, each mode trained from the seeded
    init for NC_EPOCHS epochs: every ``raw`` and ``flash`` epoch (and each
    dense ``torchgt`` epoch) must launch no kernel, every sparse epoch
    rows 1, 3 and 4 at 32 x 32 as ``step_launches`` says, the held-out
    evaluation the forward once a layer; each mode's losses finite and
    falling. Then one sparse step at ``torchgt``'s trained parameters,
    kernel path vs ``impl="plain"`` (``step_check``). Returns the phase's
    record, each mode's launches under ``launches``."""
    import numpy as np
    import torch

    from repro_torch.core.dual_attention import use_dense_step
    from repro_torch.core.graph_model import graph_loss
    from repro_torch.launch.node_classification import (MODES,
                                                        GraphTrainBench)

    t0 = time.perf_counter()
    bench = GraphTrainBench(arch="graphormer_slim", n=NC_NODES, device=dev,
                            config="full")
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    cfg, lay = bench.cfg, bench.prep.layout
    rec = {"config": cfg.name, "nodes": NC_NODES, "S": lay.seq_len,
           "beta_G": bench.g.sparsity, "density": lay.density(),
           "active_blocks": int((lay.block_idx >= 0).sum()),
           "conditions_ok": bool(bench.prep.report.ok), "prep_s": prep_s,
           "epochs": NC_EPOCHS, "interleave_period": NC_PERIOD,
           "modes": {}, "launches": {}}
    log(f"[node-cls] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads} of {cfg.head_dim}, {cfg.dtype};"
        f" SBM(n={NC_NODES}) beta_G={rec['beta_G']:.6f}, S={lay.seq_len}, "
        f"layout density {rec['density']:.4f} ({rec['active_blocks']} "
        f"blocks), conditions ok {rec['conditions_ok']}; two preps and the "
        f"uploads {prep_s:.2f}s")
    per_step = step_launches(cfg, B32_NAMES)
    run_step = bench._step

    def checked_step(opt, *, dense, bias):
        before = read_counts()
        out = run_step(opt, dense=dense, bias=bias)
        now = read_counts()
        got = {n: now[n] - before[n] for n in now if now[n] != before[n]}
        want = {} if dense else per_step
        if got != want:
            raise AssertionError(f"node-cls: a {'dense' if dense else 'sparse'}"
                                 f" epoch launched {got}, want {want}")
        return out
    bench._step = checked_step
    for mode in MODES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        hist, t_epoch, acc = bench.train(mode, epochs=NC_EPOCHS[mode],
                                         interleave_period=NC_PERIOD)
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in hist]
        n_sparse = sum(1 for ep in range(NC_EPOCHS[mode])
                       if mode == "sparse" or (
                           mode == "torchgt" and not use_dense_step(
                               ep, NC_PERIOD, bench.prep.report.ok)))
        want = step_launches(cfg, B32_NAMES, n_sparse)
        # the held-out accuracy: one forward a layer, without grad
        want[B32_NAMES[0]] += cfg.n_layers
        want = {n: want.get(n, 0) for n in counts}
        m = rec["modes"][mode] = {
            "epoch_ms": t_epoch * 1e3, "test_acc": acc, "peak_bytes": peak,
            "wall_s": wall, "sparse_epochs": n_sparse, "losses": losses,
            "train_acc": [h["train_acc"] for h in hist]}
        rec["launches"][mode] = counts
        log(f"[node-cls] {mode:7s}: {NC_EPOCHS[mode]} epochs in {wall:.2f}s,"
            f" epoch median {m['epoch_ms']:.2f} ms, loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, test acc {acc:.4f}, peak "
            f"{peak / 2**30:.2f} GiB, launches "
            f"{ {n: c for n, c in counts.items() if c} }")
        if counts != want or not np.isfinite(losses).all() or not \
                losses[-1] < losses[0]:
            raise AssertionError(f"node-cls {mode}: launches {counts} (want "
                                 f"{want}), losses {losses}")
    bench._step = run_step
    # the 32 x 32 backward at Dh 8 on a trained model
    rec["torchgt_step_check"] = step_check(
        bench.model, graph_loss, bench.batch, "node-cls",
        "one sparse step at torchgt's trained parameters")
    acc = {mode: m["test_acc"] for mode, m in rec["modes"].items()}
    rec["paper_order"] = {
        other: acc["torchgt"] >= acc[other] - slack
        for other, slack in NC_ORDER.items()}
    ms = {mode: m["epoch_ms"] for mode, m in rec["modes"].items()}
    rec["flash_over_torchgt"] = ms["flash"] / ms["torchgt"]
    log(f"[node-cls] {'system':10s} {'t_epoch':>11s} {'test_acc':>9s} "
        f"{'peak GiB':>9s}")
    for mode, label in (("raw", "GP-RAW"), ("flash", "GP-FLASH"),
                        ("sparse", "sparse"), ("torchgt", "TorchGT")):
        m = rec["modes"][mode]
        log(f"[node-cls] {label:10s} {m['epoch_ms']:9.2f}ms "
            f"{m['test_acc']:9.4f} {m['peak_bytes'] / 2**30:9.2f}")
    log(f"[node-cls] TorchGT speedup vs GP-FLASH: "
        f"{rec['flash_over_torchgt']:.2f}x (median epoch wall); the paper's "
        f"ordering, reported not gated: torchgt >= sparse - "
        f"{NC_ORDER['sparse']} {rec['paper_order']['sparse']}, >= raw - "
        f"{NC_ORDER['raw']} {rec['paper_order']['raw']}")
    del bench
    torch.cuda.empty_cache()
    return rec


# phase 9c: the paper's scale (Fig. 9a, "graph sequence lengths of up to
# 1M"), slice 21's main path, as ``python -m
# repro_torch.launch.graph_dryrun`` runs it: Graphormer in mask-free
# cluster-sparse mode (no bias table, one layout a graph), bf16,
# remat="block"
SCALE_RUNS = (("graphormer_slim", 1 << 20), ("graphormer_large", 262_144))
SCALE_STEPS = 3
SCALE_CHECK_SEQ = 16384     # (a), (b): where a dense boolean mask fits
SCALE_KERNEL_B = 2          # (a): two sequences, a layout each
SCALE_MB = 16               # live k-blocks a q-block row (graph_batch's)
# (b): the step held to plain at 4 layers (Slim's depth, 4 of Large's
# 12): its plain passes at S=16384 take ~0.4 s a Large layer; (c) runs
# the full depth on the kernels
SCALE_CHECK_LAYERS = 4
# (a): the heads of each arch (H, Dh): rows 2, 5, 6 at Dh 8 and 24
SCALE_HEADS = {"graphormer_slim": (8, 8), "graphormer_large": (32, 24)}


def scale_draws() -> dict:
    """Phase 9c's host draws, made on a thread during phase 3:
    ``graph_dryrun.graph_batch`` at each run's size (seed 0) and at
    SCALE_CHECK_SEQ for each arch (seed 1), and (a)'s SCALE_KERNEL_B
    layouts, one a sequence, with their tight transposed layouts padded
    to one ``mt``."""
    import numpy as np

    from repro_torch.core.reformation import transpose_block_idx
    from repro_torch.launch import graph_dryrun as gd

    t0 = time.perf_counter()
    rng = np.random.default_rng(9)
    nq = SCALE_CHECK_SEQ // 128
    bis = [gd.block_layout(nq, SCALE_MB, rng) for _ in range(SCALE_KERNEL_B)]
    bits = [transpose_block_idx(b, nq) for b in bis]
    mt = max(b.shape[1] for b in bits)
    out = {"kernel_layout": (np.stack(bis), np.stack([
        np.pad(b, ((0, 0), (0, mt - b.shape[1]), (0, 0)),
               constant_values=-1) for b in bits]))}
    for arch, S in SCALE_RUNS:
        cfg = gd.scale_config(arch)
        out[(arch, S)] = gd.graph_batch(cfg, S, mb=SCALE_MB, seed=0)
        out[(arch, SCALE_CHECK_SEQ)] = gd.graph_batch(
            cfg, SCALE_CHECK_SEQ, mb=SCALE_MB, seed=1)
    out["seconds"] = time.perf_counter() - t0
    return out


def scale_step_check(tag, model, batch, read_counts, want):
    """One step of the scale run's loss (``graph_dryrun.loss_and_grads``),
    kernel path against ``impl="plain"`` on the same parameters and
    batch, with the plain path in fp32 as referee (phase 14's rule): the
    loss within TOL_STEP_LOSS_REL; every gradient at a cosine of at least
    MIN_GRAD_COSINE with the plain one and its norm within
    MAX_GRAD_NORM_REL, or no further from the fp32 gradient than
    FP32_DISTANCE_FACTOR times the bf16 plain one (in 1 - cosine and in
    the norm ratio's distance from 1). The kernel path launches ``want``
    exactly, the plain paths nothing."""
    import torch
    import torch.nn.functional as F

    from repro_torch.launch import graph_dryrun as gd

    cfg = model.cfg
    names = [n for n, _ in model.named_parameters()]
    out = {}
    for key, impl, dtype in (("kernel", None, cfg.dtype),
                             ("plain", "plain", cfg.dtype),
                             ("fp32", "plain", "float32")):
        model.cfg = cfg.replace(dtype=dtype)
        before = read_counts()
        try:
            loss, _, grads = gd.loss_and_grads(model, batch, impl=impl)
        finally:
            model.cfg = cfg
        torch.cuda.synchronize()
        out[key] = (loss.detach().float(), grads,
                    {n: c - before[n] for n, c in read_counts().items()
                     if c != before[n]})
        del loss, grads

    def compare(xs, ys):
        return [(F.cosine_similarity(a.flatten().float(), c.flatten().float(),
                                     dim=0, eps=1e-30).item(),
                 (a.float().norm() / c.float().norm().clamp_min(1e-30))
                 .item()) for a, c in zip(xs, ys)]
    (kl, kg, kn), (pl_, pg, pn), (fl, fg, fn) = (out["kernel"], out["plain"],
                                                 out["fp32"])
    kp, kf, pf = compare(kg, pg), compare(kg, fg), compare(pg, fg)
    refereed, failed = {}, {}
    for i, n in enumerate(names):
        if kp[i][0] >= MIN_GRAD_COSINE and abs(kp[i][1] - 1) \
                <= MAX_GRAD_NORM_REL:
            continue
        row = {"cos_kernel_plain": kp[i][0], "norm_ratio": kp[i][1],
               "cos_kernel_fp32": kf[i][0], "cos_plain_fp32": pf[i][0]}
        ok = 1 - kf[i][0] <= FP32_DISTANCE_FACTOR * (1 - pf[i][0]) \
            and abs(kf[i][1] - 1) <= max(
                FP32_DISTANCE_FACTOR * abs(pf[i][1] - 1), MAX_GRAD_NORM_REL)
        (refereed if ok else failed)[n] = row
    worst = min(range(len(names)), key=lambda i: kp[i][0])
    res = {"loss": kl.item(), "plain_loss": pl_.item(),
           "fp32_loss": fl.item(),
           "loss_rel": (abs(kl - pl_) / abs(pl_)).item(),
           "min_grad_cosine": [names[worst], kp[worst][0]],
           "min_cos_kernel_fp32": min(c for c, _ in kf),
           "min_cos_plain_fp32": min(c for c, _ in pf),
           "refereed_by_fp32": refereed, "failed": failed, "launched": kn}
    log(f"[scale] {tag}: one step, kernel vs plain path: loss "
        f"{res['loss']:.6f} vs {res['plain_loss']:.6f} (rel "
        f"{res['loss_rel']:.3g}, tol {TOL_STEP_LOSS_REL}; fp32 "
        f"{res['fp32_loss']:.6f}); gradient cosine min {kp[worst][0]:.6f} "
        f"({names[worst]}; min {MIN_GRAD_COSINE}); against fp32 plain: min "
        f"cosine kernel {res['min_cos_kernel_fp32']:.6f}, bf16 plain "
        f"{res['min_cos_plain_fp32']:.6f}; {len(refereed)} of {len(names)} "
        f"gradients held by the fp32 referee {json.dumps(refereed)}; "
        f"kernels launched {kn}")
    if not (res["loss_rel"] <= TOL_STEP_LOSS_REL and not failed
            and kn == want and not pn and not fn):
        raise AssertionError(f"{tag}: kernel and plain paths disagree: "
                             f"{res}, plain launched {pn}, fp32 {fn}")
    return res


def scale_phase(dev, reset_counts, read_counts, draws, compare_unbiased,
                bound_unbiased, smi) -> dict:
    """Phase 9c. (a) Rows 2, 5 and 6 at the scale run's shapes against
    their plain versions (``compare_unbiased``: phase 3c's tolerances):
    SCALE_KERNEL_B sequences of SCALE_CHECK_SEQ, a layout each, bq 128,
    each arch's heads (Slim Dh 8, Large Dh 24), bf16 and fp32; each
    kernel and plain half timed, its bound, and for bf16 one SDPA call
    with the layouts as a dense boolean mask, forward and backward. (b)
    One step of each arch (SCALE_CHECK_LAYERS layers) at SCALE_CHECK_SEQ
    held to ``impl="plain"`` (``scale_step_check``). (c) The main path: Graphormer-Slim at S =
    1,048,576 and Graphormer-Large at S = 262,144, SCALE_STEPS steps each
    through ``graph_dryrun.run`` on the kernel path, the counts set to 0
    before each and read after: rows 2, 5 and 6 launched exactly as
    ``step_launches`` says, every loss finite; each record printed with
    the card's name and power limit; then one more step at each run's
    shape profiled (``scale_profile``)."""
    import torch

    from repro_torch.core.graph_model import GraphModel
    from repro_torch.kernels import cluster_attention as tca
    from repro_torch.kernels import cluster_attention_bwd as tcab
    from repro_torch.kernels import ref
    from repro_torch.launch import graph_dryrun as gd

    t0 = time.perf_counter()
    rec = {"draw_s": draws["seconds"], "kernels": {}, "steps": {},
           "runs": {}}
    zero = {n: 0 for n in read_counts()}
    S, B = SCALE_CHECK_SEQ, SCALE_KERNEL_B
    bi, bit = (torch.from_numpy(x).to(dev) for x in draws["kernel_layout"])
    rec["kernel_layout"] = {"B": B, "S": S, "nq": bi.shape[1],
                            "mb": bi.shape[2], "mt": bit.shape[2],
                            "live": int((bi >= 0).sum())}

    # ------------------------------------------------------------ (a)
    for arch, (H, Dh) in SCALE_HEADS.items():
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).split(".")[1]
            gen = torch.Generator(device=dev).manual_seed(70 + Dh)
            q, k, v = (torch.randn(B, S, H, Dh, generator=gen, device=dev)
                       .to(dtype) for _ in range(3))
            errs, (o, lse, dout) = compare_unbiased(
                f"{arch} heads (H={H}, Dh={Dh}), per-graph B={B}, S={S}",
                q, k, v, bi, bit, False, seed=71 + Dh)
            delta = ref.row_delta(dout, o)
            qa, ka, va, da = (tca.aligned(x) for x in (q, k, v, dout))
            runs = {
                "fwd": (lambda: tca.cluster_attention_fwd(
                            q, k, v, bi, None, None, return_lse=True),
                        lambda: ref.cluster_sparse_attention(
                            q, k, v, bi, return_lse=True)),
                "dq": (lambda: tcab.dq_unbiased_kernel(
                           qa, ka, va, da, lse, delta, bi, False),
                       lambda: ref.bwd_dq(q, k, v, dout, lse, delta, bi,
                                          None, None)),
                "dkv": (lambda: tcab.dkv_unbiased_kernel(
                            qa, ka, va, da, lse, delta, bi, bit, False),
                        lambda: ref.bwd_dkv(q, k, v, dout, lse, delta, bi,
                                            bit, None, None))}
            r = {}
            for (half, (kern, plain)), err in zip(runs.items(), errs):
                r[half] = {"max_abs_err": err, "ms": cuda_ms(kern, 5),
                           "plain_ms": cuda_ms(plain, 1)}
                r[half]["bound_ms"], r[half]["bound_by"] = bound_unbiased(
                    half, q, k, bi, bit, False)
                log(f"[scale] {arch} heads {dt} {half}: kernel "
                    f"{r[half]['ms']:.4f} ms, plain "
                    f"{r[half]['plain_ms']:.4f} ms, bound "
                    f"{r[half]['bound_ms']:.4f} ms ({r[half]['bound_by']}), "
                    f"{r[half]['bound_ms'] / r[half]['ms']:.2%} of bound")
            if dtype == torch.bfloat16:
                r["yardstick"] = scale_sdpa(q, k, v, bi, o, dev)
            rec["kernels"][f"{arch}_{dt}"] = r
            del q, k, v, o, lse, dout, delta, qa, ka, va, da
            release()
    del bi, bit

    # ------------------------------------------------------------ (b)
    for arch, _ in SCALE_RUNS:
        cfg = gd.scale_config(arch)
        cfg = cfg.replace(n_layers=min(cfg.n_layers, SCALE_CHECK_LAYERS))
        model = GraphModel(cfg, device=dev, seed=0)
        batch = {k: v.to(dev) for k, v in draws[(arch, S)].items()}
        rec["steps"][arch] = scale_step_check(
            f"{arch} at S={S}", model, batch, read_counts,
            step_launches(cfg, UNBIASED_NAMES))
        del model, batch
        release()

    # ------------------------------------------------- (c) the main path
    launches = dict(zero)
    for arch, S_ in SCALE_RUNS:
        cfg = gd.scale_config(arch)
        host = draws.pop((arch, S_))
        resident = release()
        reset_counts()
        r = gd.run(arch, S_, steps=SCALE_STEPS, device=dev, batch=host)
        counts = read_counts()
        want = {**zero, **step_launches(cfg, UNBIASED_NAMES, SCALE_STEPS)}
        r["launches"] = {n: c for n, c in counts.items() if c}
        r["resident_bytes_before"] = resident
        log(f"[scale] {smi}")
        log(f"[scale] {json.dumps(r)}")
        if counts != want or not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"phase 9c {arch} S={S_}: launches "
                                 f"{counts}, want {want}; losses "
                                 f"{r['losses']}")
        for n, c in counts.items():
            launches[n] += c
        release()
        r["profile"] = scale_profile(arch, S_, host, dev, r["step_ms"])
        rec["runs"][f"{arch}_{S_}"] = r
        del host
        release()
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    log(f"[scale] phase 9c: {rec['seconds']:.1f} s (host draws "
        f"{rec['draw_s']:.1f} s on a thread during phase 3)")
    return rec


def scale_profile(arch, S, host, dev, step_ms):
    """Where a step of the scale run goes: a fresh seeded model and the
    run's own step (``steps.make_train_step`` on ``graph_loss``, as
    ``graph_dryrun.run`` builds it) at the run's shape and batch, one
    step to warm up, then one step profiled (``device_breakdown``), its
    wall to a synchronisation the run's median step (``step_ms``),
    outside the run's launch counts."""
    from repro_torch.core.graph_model import GraphModel
    from repro_torch.launch import graph_dryrun as gd
    from repro_torch.launch import steps

    model = GraphModel(gd.scale_config(arch), device=dev)
    step = steps.make_train_step(model, None, None, lr=gd.LR,
                                 loss=gd.graph_loss)
    batch = {k: v.to(dev) for k, v in host.items()}
    step(batch)
    out = device_breakdown(lambda: step(batch), step_ms, tag="scale",
                           what=f"one {arch} step at S={S}", focus="cluster")
    del model, step, batch
    return out


def scale_sdpa(q, k, v, bi, o, dev) -> dict:
    """One SDPA call (PyTorch's pick of backend) with the per-graph
    layouts as a dense boolean (B, 1, S, S) mask, forward and backward
    (dq, dk, dv); its forward held to the kernel's O at TOL_O."""
    import torch
    import torch.nn.functional as F

    B, S, H, _ = q.shape
    nq = bi.shape[-2]
    bq = S // nq
    mask = torch.zeros((B, 1, S, S), dtype=torch.bool, device=dev)
    for b in range(B):
        ii, mm = torch.nonzero(bi[b] >= 0, as_tuple=True)
        mask[b, 0].view(nq, bq, nq, bq).permute(0, 2, 1, 3)[
            ii, bi[b, ii, mm].long()] = True
    rec = {}
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    try:
        with torch.no_grad():
            got = F.scaled_dot_product_attention(
                *leaves, attn_mask=mask).transpose(1, 2).float()
        rec["max_abs_err_vs_kernel"] = (got - o.float()).abs().max().item()
        if not torch.allclose(got, o.float(), atol=TOL_O["bfloat16"],
                              rtol=TOL_O["bfloat16"]):
            raise AssertionError(f"kernel vs SDPA with the layout mask: "
                                 f"max|dO|={rec['max_abs_err_vs_kernel']}")
        del got
        rec["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            *(x.detach() for x in leaves), attn_mask=mask), 5)
        og = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        gout = torch.randn_like(og)
        rec["library_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
            og, leaves, gout, retain_graph=True), 5)
        del og, gout
    except RuntimeError as e:   # out of memory included: recorded
        rec["library_error"] = \
            f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
    log(f"[scale] SDPA with the layouts as a (B, 1, S, S) boolean mask, "
        f"B={B} S={S} H={H}: " + (
            f"fwd {rec['library_ms']:.4f} ms, bwd "
            f"{rec['library_bwd_ms']:.4f} ms (max|dO| vs kernel "
            f"{rec['max_abs_err_vs_kernel']:.3g})"
            if "library_bwd_ms" in rec else rec["library_error"]))
    del mask, leaves
    release()
    return rec


# phase 9d: the fit-and-roofline sweep (slice 22, ``python -m
# repro_torch.launch.dryrun``) held to the card: each cell at the
# sweep's published widths on a (1, 1) mesh, its batch cut to fit one
# card, traced on fake tensors (``dryrun.run_cell``) and then run for
# real from the same ``steps.build_cell``: (arch, shape, config
# overrides, global batch)
ESTIMATE_CELLS = (
    ("qwen3_0_6b", "train_4k", {"attn_backend": "cluster_sparse"}, 2),
    ("smollm_135m", "long_500k", None, 1),
)
# the trace's peak of live bytes against max_memory_allocated over the
# same step: the caching allocator hands out whole blocks (a large one
# up to 1 MiB past the request), and cuBLAS takes workspace the
# dispatcher does not see
ESTIMATE_MEM_RTOL = 0.10


def estimate_phase(dev, reset_counts, read_counts, smi) -> dict:
    """Phase 9d. For each of ESTIMATE_CELLS: the fake trace's record
    (``peak_est_bytes``, ``FlopCounterMode``'s count, each cluster-op
    launch's output shapes and dtypes) against one real step of the same
    cell on the card, built by ``steps.build_cell`` (seeded init drawn on
    the card, the batch from ``steps.fill_batch``): the peak within
    ESTIMATE_MEM_RTOL of ``max_memory_allocated`` over the step (from
    the bytes allocated before the cell was built, the peak statistics
    reset before the step), the FLOP counts equal, the launches' outputs
    equal, the loss (or the logits) finite. Each pair printed on its own
    line."""
    import torch

    from repro_torch.launch import dryrun, steps
    from repro_torch.models import layers as L

    t0 = time.perf_counter()
    rec = {"cells": {}}
    for arch, shape, over, batch in ESTIMATE_CELLS:
        tag = f"{arch} x {shape} (batch {batch}, 1x1)"
        est = dryrun.run_cell(arch, shape, mesh_shape=(1, 1),
                              overrides=over, global_batch=batch,
                              device="cuda", verbose=False)
        fake_launches = est.pop("launches")
        log(f"[estimate] {smi}")
        log(f"[estimate] {json.dumps(est)}")
        base = release()
        with L.draw_on_device():
            cell = steps.build_cell(arch, shape, {"data": 1, "model": 1},
                                    overrides=over, global_batch=batch,
                                    device=dev)
        steps.fill_batch(cell["cfg"], cell["args"][0] if
                         cell["shape"].kind != "decode" else
                         {"tokens": cell["args"][1]})
        torch.cuda.synchronize(dev)
        args_bytes = torch.cuda.memory_allocated(dev) - base
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t1 = time.perf_counter()
        real = dryrun.trace_step(cell)
        torch.cuda.synchronize(dev)
        step_s = time.perf_counter() - t1
        counts = {n: c for n, c in read_counts().items() if c}
        peak = torch.cuda.max_memory_allocated(dev) - base
        out = real["out"]
        value = out["loss"] if isinstance(out, dict) else out[0]
        finite = bool(torch.isfinite(value.float()).all())
        m = est["memory"]
        r = {"peak_est_bytes": m["peak_est_bytes"], "peak_bytes": peak,
             "peak_rel": (m["peak_est_bytes"] - peak) / peak,
             "argument_bytes_est": m["argument_bytes"],
             "argument_bytes": args_bytes,
             "peak_traced_real": real["trace"].peak,
             "flops_counted_est": est["flops_counted"],
             "flops_counted": real["flops"],
             "launches_est": len(fake_launches),
             "launches": counts, "step_s": step_s, "finite": finite,
             "trace_s": est["compile_s"]}
        log(f"[estimate] {tag}: peak_est_bytes {m['peak_est_bytes']} "
            f"max_memory_allocated {peak} ({100 * r['peak_rel']:+.2f}%); "
            f"the real step's dispatcher count {real['trace'].peak}")
        log(f"[estimate] {tag}: argument_bytes {m['argument_bytes']} "
            f"allocated by the build {args_bytes}")
        log(f"[estimate] {tag}: FlopCounterMode fake "
            f"{est['flops_counted']:.6e} real {real['flops']:.6e}")
        log(f"[estimate] {tag}: cluster-op launches fake "
            f"{len(fake_launches)} real {len(real['trace'].launches)} "
            f"(counters {counts}), outputs equal "
            f"{fake_launches == real['trace'].launches}")
        what = "loss" if isinstance(out, dict) else "logits"
        log(f"[estimate] {tag}: {what} finite {finite}; real step "
            f"{step_s:.2f} s, trace "
            f"{est['compile_s']} s")
        bad = []
        if abs(r["peak_rel"]) > ESTIMATE_MEM_RTOL:
            bad.append(f"peak {m['peak_est_bytes']} vs {peak}")
        if est["flops_counted"] != real["flops"]:
            bad.append(f"flops {est['flops_counted']} vs {real['flops']}")
        if fake_launches != real["trace"].launches:
            bad.append(f"launch outputs {fake_launches[:3]} vs "
                       f"{real['trace'].launches[:3]}")
        if len(fake_launches) != sum(counts.values()):
            bad.append(f"{len(fake_launches)} fake launches vs counters "
                       f"{counts}")
        if not finite:
            bad.append("not finite")
        if bad:
            raise AssertionError(f"phase 9d {tag}: " + "; ".join(bad))
        rec["cells"][f"{arch}_{shape}"] = r
        del cell, real, out, value
        release()
    rec["seconds"] = time.perf_counter() - t0
    log(f"[estimate] phase 9d: {rec['seconds']:.1f} s")
    return rec


# phase 10: the GT graph-level recovery cases' fault steps (16 steps,
# checkpoints every 4): skip at 6, a streak at 5-7 (the generation saved
# at 8 lies inside it), a preemption at 10 (rescued: resume at 10;
# unrescued: at 8), the final checkpoint at 16 corrupted (fall back to 12)
RECOVERY_STEPS = 16
RECOVERY_CKPT_EVERY = 4
RECOVERY_AT = {"skip": 6, "rollback": (5, 7), "preempt": 10, "corrupt": 16}


def recovery_phase(out_path: str) -> int:
    """Phase 10, in a child process: recovery on the card, bit for bit.

    ``CUBLAS_WORKSPACE_CONFIG`` comes from the parent's environment for
    this process only, and deterministic algorithms are on, so a replay
    computes the same bits as the run it replays (the port's kernels use
    no float atomics). GT graph-level at full width on phase 8's data and
    mini-batches, the layout frozen (``elastic_every=0``: the ladder reads
    wall time): the chaos sweep's cases (``run_training_cases``: an
    unfaulted baseline, a skipped step, a rollback past a generation saved
    inside the streak, preemption inside the update with and without a
    rescue copy, a corrupt last generation), each launch-counted; then GT
    link at phase 9's shape, preempted at 10 and resumed; then a
    graph-level run with an AutoTuner epoch every step, failed at 10 and
    resumed, whose task state must come back as the manifest holds it;
    the GT state's checkpoint costs; the step time with async saves. The
    record goes to ``out_path`` as JSON."""
    import contextlib
    import tempfile

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke phase 10: no CUDA device", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core.graph import sbm_graph
    from repro_torch.core.graph_model import GraphModel
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import cluster_attention as tca
    from repro_torch.kernels import cluster_attention_bwd as tcab
    from repro_torch.resilience.chaos import run_training_cases
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tasks import (GraphLevelTask, LinkTask,
                                   synthetic_graph_level_dataset)

    dev = torch.device("cuda")
    gt = get_config("gt")

    def graph_task():
        return GraphLevelTask(
            synthetic_graph_level_dataset(GRAPH_TRAIN, gt, seed=1), gt,
            batch_graphs=GRAPH_BATCH, device=dev)

    # the cases' task is host work (it uploads on first use): ahead of
    # the turn
    t0 = time.perf_counter()
    task = graph_task()
    prep_s = time.perf_counter() - t0
    await_turn(torch)
    t_start = time.perf_counter()
    kbuild.build_all((tca.LIBRARY_SM90, tcab.LIBRARY_DQ_SM90,
                      tcab.LIBRARY_DKV_SM90))
    reset_counts, read_counts = kernel_counters()
    log(f"[recovery] deterministic algorithms "
        f"{torch.are_deterministic_algorithms_enabled()}, "
        f"CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG')}")

    # sparse steps the case's trainers ran (every call of Trainer.step:
    # faulted, preempted and replayed steps launch their kernels too)
    sparse_steps = [0]

    def factory(task, **fixed):
        def make(d, **kw):
            model = GraphModel(gt, device=dev, seed=0)
            tr = Trainer(model, TrainerConfig(
                steps=RECOVERY_STEPS, lr=1e-3, warmup=2,
                interleave_period=gt.interleave_period,
                ckpt_every=RECOVERY_CKPT_EVERY, ckpt_dir=d,
                **{**fixed, **kw}), task=task)
            run_step = tr.step

            def counting_step(variant, batch, **faults):
                sparse_steps[0] += variant == "sparse"
                return run_step(variant, batch, **faults)
            tr.step = counting_step
            return tr
        return make

    launches, walls = {}, {}

    def counted(names, prefix=""):
        """Each case's launches, held to the path's kernels: exactly
        ``step_launches`` of ``names`` for the sparse steps the case ran,
        nothing else."""
        @contextlib.contextmanager
        def around(name):
            torch.cuda.synchronize()
            reset_counts()
            sparse_steps[0] = 0
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            walls[prefix + name] = time.perf_counter() - t0
            got = read_counts()
            launches[prefix + name] = got
            want = step_launches(gt, names, sparse_steps[0])
            if not sparse_steps[0] or got != {k: want.get(k, 0)
                                              for k in got}:
                raise AssertionError(f"{prefix}{name}: launches "
                                     f"{ {k: c for k, c in got.items() if c} }"
                                     f", want {want} ({sparse_steps[0]} "
                                     f"sparse steps, remat {gt.remat!r})")
        return around

    def report(out, tag):
        bad = []
        for rec in out["records"]:
            got = launches[tag + ":" + rec["fault"]]
            log(f"[{tag}] {rec['fault']:18s} "
                f"{'recovered' if rec['recovered'] else 'UNRECOVERED'} "
                f"replay={rec['replay']} ({rec['detail']}); launches "
                f"{ {k: c for k, c in got.items() if c} }")
            if not rec["recovered"]:
                bad.append(rec["fault"])
        return bad

    # ------------------------------------------- the cases, GT graph-level
    log(f"[recovery] GT graph-level: {task.n_batches} mini-batches of "
        f"{GRAPH_BATCH} graphs, S={task.layout.seq_len}, bq={task.layout.bq};"
        f" {RECOVERY_STEPS} steps, dense every {gt.interleave_period}, "
        f"checkpoints every {RECOVERY_CKPT_EVERY}, faults {RECOVERY_AT}; "
        f"host prep {prep_s:.2f}s ahead of the phase's turn")
    make = factory(task, elastic_every=0)
    out = run_training_cases(make, steps=RECOVERY_STEPS,
                             ckpt_every=RECOVERY_CKPT_EVERY, at=RECOVERY_AT,
                             around=counted(B16_NAMES, "graph:"))
    unrecovered = report(out, "graph")
    records = {"graph": out["records"]}
    base = out["baseline"]
    # the saves' cost on the loop, warm, in turns: the same 16 steps
    # without checkpoints, with async saves every 4, with, without
    turns = []
    with tempfile.TemporaryDirectory() as d:
        for i, saves in enumerate((False, True, True, False)):
            with counted(B16_NAMES, "graph:")(f"turn_{i}"):
                tr = make(os.path.join(d, str(i)) if saves else None)
                tr.run()
            sparse = [h for h in tr.history if h["variant"] == "sparse"]
            turn = {"saves": saves, "run_s": walls[f"graph:turn_{i}"],
                    "sparse_median_ms": float(np.median(
                        [h["seconds"] * 1e3 for h in sparse]))}
            if saves:  # the steps just after a save, its write in flight
                turn["after_save_median_ms"] = float(np.median(
                    [h["seconds"] * 1e3 for h in sparse
                     if (h["step"] - 1) % RECOVERY_CKPT_EVERY == 0]))
            turns.append(turn)
            log(f"[recovery] turn {i}: "
                + (f"async saves every {RECOVERY_CKPT_EVERY} steps"
                   if saves else "no checkpoints")
                + f", run {turn['run_s']:.3f} s, sparse step median "
                f"{turn['sparse_median_ms']:.3f} ms"
                + (f" ({turn['after_save_median_ms']:.3f} ms just after a "
                   f"save)" if saves else "")
                + " (deterministic algorithms on)")
    del tr
    costs = checkpoint_costs(base, make, "recovery")
    del base, out

    # ------------------------------------------- GT link, preempt and resume
    t0 = time.perf_counter()
    ltask = LinkTask(sbm_graph(LINK_NODES, 4, p_in=0.04, p_out=0.002,
                               feat_dim=gt.feat_dim, n_classes=gt.n_classes,
                               seed=0), gt, n_pairs=LINK_PAIRS, device=dev)
    log(f"[recovery] GT link: S={ltask.layout.seq_len}, bq={ltask.layout.bq}"
        f", {LINK_PAIRS} pairs a step; host prep "
        f"{time.perf_counter() - t0:.2f}s")
    lout = run_training_cases(factory(ltask, elastic_every=0),
                              steps=RECOVERY_STEPS,
                              ckpt_every=RECOVERY_CKPT_EVERY, at=RECOVERY_AT,
                              only="preempt_rescued",
                              around=counted(B32_NAMES, "link:"))
    unrecovered += ["link:" + f for f in report(lout, "link")]
    records["link"] = lout["records"]
    del lout, ltask

    # --------------------- the task's state across a restart (elastic run)
    with tempfile.TemporaryDirectory() as d:
        elastic = factory(task, elastic_every=gt.elastic_every)
        with counted(B16_NAMES, "elastic:")("failed_at_10"):
            died = False
            try:
                elastic(d, fail_at_step=10).run()
            except RuntimeError as e:
                if "injected failure at step 10" not in str(e):
                    raise
                died = True
        saved = Checkpointer(d).load_extra(10)["task"]
        fresh = graph_task()
        tr = factory(fresh, elastic_every=gt.elastic_every)(d)
        with counted(B16_NAMES, "elastic:")("resumed"):
            start = tr.restore_or_init()
            got = fresh.state_dict()
            same = (got["tuner"] == saved["tuner"]
                    and got["moves"] == saved["moves"])
            status = tr.run()
    elastic_rec = {"died": died, "resumed_at": start, "status": status,
                   "tuner": got["tuner"], "moves": got["moves"],
                   "task_state_equal": same,
                   "moves_after": len(fresh.moves)}
    log(f"[recovery] elastic graph-level run failed at 10 ({died}), resumed "
        f"at {start}: tuner pos {got['tuner']['pos']}, "
        f"{len(got['moves'])} moves, equal to the manifest's: {same}; "
        f"status {status}, {len(fresh.moves)} moves after the resume")
    if not (died and start == 10 and same and status == "done"):
        unrecovered.append("elastic_task_state")

    totals = {k: sum(c[k] for c in launches.values())
              for k in read_counts()}
    rec = {"cases": records, "unrecovered": unrecovered,
           "turns": turns, "gt_checkpoint": costs,
           "elastic": elastic_rec, "launches": totals,
           "launches_by_case": launches,
           "seconds": time.perf_counter() - t_start}
    with open(out_path, "w") as fh:
        json.dump(rec, fh)
    log(f"[recovery] {time.perf_counter() - t_start:.1f}s, unrecovered "
        f"{unrecovered}, launches { {k: c for k, c in totals.items() if c} }")
    return 0 if not unrecovered else 1


def attention_call(model, loss_fn, batch, nth=0):
    """The arguments of the ``nth`` cluster-attention call (default the
    first) of ``loss_fn``'s forward: that layer's q, k, v and the layout,
    bias and table the run gives it. Without grad (one call a layer), and
    the forward stops there."""
    import torch
    from repro_torch.kernels import ops as kops

    seen = {}

    class Seen(Exception):
        pass

    def grab(*args, **kw):
        if seen.setdefault("calls", 0) < nth:
            seen["calls"] += 1
            return real(*args, **kw)
        seen.update(args=args, kw=kw)
        raise Seen
    real = kops.cluster_attention
    kops.cluster_attention = grab
    try:
        with torch.no_grad():
            loss_fn(model, batch)
    except Seen:
        pass
    finally:
        kops.cluster_attention = real
    return seen["args"], seen["kw"]


def op_check(tag, model, loss_fn, batch, names, read_counts, seed=0,
             log_tag="remat", nth=0):
    """The attention op of the run's first layer (or of the ``nth``
    cluster-attention call), on its own q, k, v,
    layout and table: the kernels (``names``: the forward, dQ and
    dK/dV, each launched once) against ``impl="plain"``, the forward
    with O and lse and the autograd backward with a random dO, at the
    tolerances of phases 3 and 6: O within TOL_O (and, unbiased, as
    phase 6, TOL_O_ELEM), lse within TOL_LSE, dq, dk, dv and
    the table's gradient as max|diff| over max|plain| within
    TOL_GRAD (the table's absolutely where every bucket is alike, as
    softmax then cancels it)."""
    import torch
    from repro_torch.kernels import ops as kops

    (q, k, v, bi, bu, bias, bit), kw = attention_call(model, loss_fn,
                                                      batch, nth)
    dev = q.device
    dt = str(q.dtype).split(".")[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    res = []
    for impl in (None, "plain"):
        leaves = [x.detach().requires_grad_() for x in (q, k, v, bias)
                  if x is not None]
        before = read_counts()
        o, lse = kops.cluster_attention(
            *leaves[:3], bi, bu, leaves[3] if bias is not None else None,
            bit, causal=kw["causal"], return_lse=True, impl=impl)
        grads = torch.autograd.grad(o, leaves, dout)
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in read_counts().items()
                    if c != before[n]}
        res.append((o.detach(), lse, grads, launched))
        del o, leaves
    (o, lse, got, launched), (po, plse, want, plain_launched) = res
    diff = (o.float() - po.float()).abs()
    atol, rtol = TOL_O_ELEM[dt]
    o_share = (diff / (atol + rtol * po.float().abs())).max().item()
    uniform = bias is not None and (bias.shape[1] == 1 or bool(
        (bu == bu.flatten()[0]).all()))
    rels = []
    for i, (x, y) in enumerate(zip(got, want)):
        d = (x.float() - y.float()).abs().max().item()
        den = 1.0 if uniform and i == 3 else y.float().abs().max().item()
        rels.append(d / max(den, 1e-30))
    out = {"shape": {"B": q.shape[0], "S": q.shape[1],
                     "H": q.shape[2], "KV": k.shape[2],
                     "Dh": q.shape[3], "nq": bi.shape[-2],
                     "mb": bi.shape[-1],
                     "active_blocks": int((bi >= 0).sum()),
                     "causal": kw["causal"]},
           "dtype": dt, "max_abs_err_o": diff.max().item(),
           "o_elem_share": o_share,
           "max_abs_err_lse": (lse - plse).abs().max().item(),
           "grad_rel": dict(zip(("dq", "dk", "dv", "dbias"), rels)),
           "launched": launched}
    ok = (torch.allclose(o.float(), po.float(), atol=TOL_O[dt],
                         rtol=TOL_O[dt])
          and (bu is not None or o_share <= 1.0)
          and torch.allclose(lse, plse, atol=TOL_LSE, rtol=1e-5)
          and all(r <= TOL_GRAD[dt] for r in rels)
          and all(bool(torch.isfinite(x).all()) for x in (o, *got))
          and launched == {n: 1 for n in names}
          and not plain_launched)
    log(f"[{log_tag}] {tag}: layer 0's attention op, kernels vs plain at "
        f"{out['shape']} {dt}: max|dO| {out['max_abs_err_o']:.3g} (tol "
        f"{TOL_O[dt]}), worst element at {o_share:.3g} of its limit, "
        f"max|dlse| {out['max_abs_err_lse']:.3g} (tol {TOL_LSE}); rel "
        + " ".join(f"{n} {r:.3g}" for n, r in out["grad_rel"].items())
        + f" (tol {TOL_GRAD[dt]}); kernels launched {launched} "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{tag}: the attention kernels disagree "
                             f"with their plain versions: {out}")
    del res, o, lse, got, po, plse, want, diff
    return out


# phase 11: layer recomputation at full width, in a child process. The
# Qwen3-0.6B and Graphormer-Large A/B run REMAT_AB_STEPS steps under
# "none" and under "block" from the same initial parameters and batches;
# the larger configs run only under "block", which they need to fit
REMAT_AB_STEPS = 2            # cut from 3: room for phase 15
REMAT_LM_SEQ = 16384          # the A/B and Qwen3-1.7B (phase 6's shape)
REMAT_LONG_SEQ = 65536        # Qwen3-0.6B beyond phase 6's sequence
REMAT_LONG_STEPS = 2
REMAT_1_7B_STEPS = 3
REMAT_4B_SEQS = (8192, 4096)  # Qwen3-4B: the first that fits
REMAT_4B_STEPS = 2
REMAT_SSM_SEQ = 4096          # Mamba2-2.7B
REMAT_SSM_STEPS = 2
REMAT_SSM_LAYERS = 8          # of its 64: room for phases 13, 15 (PERF.md 4)
REMAT_GRAPH_NODES = SERVE_NODES   # the serve phase's graph, S=32800


def remat_graph_task(dev):
    """Phase 11's Graphormer-Large config (sparse steps only, the layout
    frozen, no recomputation), its 32768-node graph and its task, host
    work only (the task uploads on first use): ``(cfg, graph, task,
    seconds)``. The layout stays frozen, so the task prepares the start
    rung alone (``start_rung_task``)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import degree_scaled_sbm

    large = get_config("graphormer_large").replace(
        interleave_period=0, elastic_every=0, remat="none")
    t0 = time.perf_counter()
    g = degree_scaled_sbm(REMAT_GRAPH_NODES, CLUSTERS, large, seed=0)
    task = start_rung_task(g, large, bq=32, bk=32, d_b=8, device=dev,
                           train_mask=np.random.default_rng(0).random(g.n)
                           < 0.5)
    return large, g, task, time.perf_counter() - t0


def remat_runs(dev, reset_counts, read_counts, graph) -> dict:
    """Phase 11's runs on ``dev``: every config through the Trainer as a
    user trains it, each run's launches counted exactly
    (``step_launches``) and appended to ``counted``, its losses finite
    and falling, its peak memory (``reset_peak_memory_stats`` before,
    ``max_memory_allocated`` after) and step times recorded. Before each
    config's runs, the attention op of its first layer is held against
    its plain version at the shapes the run gives it (``op_check``). The
    A/B also holds step 0's loss and gradients of the recomputing
    backward to the one that keeps every activation, bit for bit.
    ``graph`` is ``remat_graph_task``'s, made ahead of the turn.
    Returns the phase's record and ``counted``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.graph_model import GraphModel, graph_loss
    from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch
    from repro_torch.models.api import SSMLMModel
    from repro_torch.models.lm import LMModel, lm_loss
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tasks import BatchFnTask

    counted = []   # every trainer run's launch counts

    def only(**want):
        return {name: want.get(name, 0) for name in read_counts()}

    def lm_task(cfg, S):
        dc = LMDataConfig(cfg.vocab_size, S, 1, seed=0)
        return BatchFnTask(lambda s: lm_batch(dc, s))

    def train(tag, model, task, steps, names, S):
        """``steps`` steps of ``task`` through the Trainer, every one
        sparse, the layout frozen: the run's record."""
        cfg = model.cfg
        left = release()
        # max_bad_steps=0: no re-init rung, so run() takes no host copy of
        # the parameters (16 GB for Qwen3-4B; phase 6 times that copy)
        tr = Trainer(model, TrainerConfig(steps=steps, lr=1e-3, warmup=2,
                                          max_bad_steps=0),
                     task=task)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        status = tr.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        counted.append(counts)
        peak = torch.cuda.max_memory_allocated()
        hist = tr.history
        losses = [h["loss"] for h in hist]
        step_ms = [h["seconds"] * 1e3 for h in hist]
        want = only(**step_launches(cfg, names, steps)) if names else only()
        # steps after the first (allocator and cuBLAS start-up)
        steady = float(np.median(step_ms[1:])) if steps > 1 else step_ms[0]
        n_params = sum(p.numel() for p in model.parameters())
        rec = {"config": cfg.name, "remat": cfg.remat, "S": S, "batch": 1,
               "layers": cfg.n_layers, "params": n_params, "steps": steps,
               "losses": losses, "step_ms": step_ms,
               "step_ms_median": steady, "run_s": run_s,
               # the loop's time outside its steps: mostly the host copy
               # of the parameters run() takes for the re-init rung
               "outside_steps_s": run_s - sum(h["seconds"] for h in hist),
               "peak_bytes": peak, "allocated_before_bytes": left,
               "launches": counts,
               "tokens_per_s": S * 1e3 / steady}
        log(f"[remat] {tag}: {cfg.name} remat={cfg.remat!r} S={S}, "
            f"{cfg.n_layers} layers, {n_params:,} params; losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}; step ms "
            f"{', '.join(f'{x:.2f}' for x in step_ms)} (median after the "
            f"first {steady:.2f}); peak {peak / 2**30:.2f} GiB "
            f"({left / 2**30:.2f} GiB allocated before); run "
            f"{run_s:.2f} s, {rec['outside_steps_s']:.2f} s outside the "
            f"steps; launches "
            f"{ {k: c for k, c in counts.items() if c} }")
        falling = steps == 1 or losses[-1] < losses[0]
        if status != "done" or counts != want or not falling or \
                not np.isfinite(losses).all() or any(h["skipped"]
                                                     for h in hist):
            raise AssertionError(
                f"{tag}: status {status}, losses {losses}, launches "
                f"{ {k: c for k, c in counts.items() if c} }, want "
                f"{ {k: c for k, c in want.items() if c} }")
        del tr
        return rec

    def ab_grads(tag, model, loss_fn, batch):
        """Step 0's loss and gradients under "none", then "block" and
        "dots" on the same parameters and batch, each forward and
        backward's peak memory; the recomputing ones held to "none" bit
        for bit (the max difference and the least cosine are
        reported)."""
        params = list(model.parameters())
        names = [n for n, _ in model.named_parameters()]
        base = model.cfg
        out, ref = {}, None
        for remat in ("none", "block", "dots"):
            model.cfg = base.replace(remat=remat)
            release()
            torch.cuda.reset_peak_memory_stats()
            loss = loss_fn(model, batch)
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            rec = {"loss": loss.item(),
                   "peak_bytes": torch.cuda.max_memory_allocated()}
            if ref is None:
                ref = (loss.detach(), grads)
            else:
                diff = {n: (a - b).abs().max().item()
                        for n, a, b in zip(names, grads, ref[1])}
                cos = {n: F.cosine_similarity(
                    a.flatten().float(), b.flatten().float(), dim=0,
                    eps=1e-30).item()
                    for n, a, b in zip(names, grads, ref[1])}
                worst = min(cos, key=cos.get)
                rec.update(
                    loss_bitwise=bool(torch.equal(loss.detach(), ref[0])),
                    grads_bitwise=all(torch.equal(a, b)
                                      for a, b in zip(grads, ref[1])),
                    max_abs_grad_diff=max(diff.values()),
                    max_abs_grad_diff_at=max(diff, key=diff.get),
                    min_grad_cosine=[worst, cos[worst]])
                if not (rec["loss_bitwise"] and rec["grads_bitwise"]):
                    raise AssertionError(f"{tag}: remat={remat!r} step 0 "
                                         f"against 'none': {rec}")
            log(f"[remat] {tag} step 0, remat={remat!r}: loss "
                f"{rec['loss']:.6f}, forward+backward peak "
                f"{rec['peak_bytes'] / 2**30:.2f} GiB"
                + ("" if remat == "none" else
                   f"; against 'none': loss bitwise {rec['loss_bitwise']}, "
                   f"gradients bitwise {rec['grads_bitwise']}, max |diff| "
                   f"{rec['max_abs_grad_diff']:.3g} "
                   f"({rec['max_abs_grad_diff_at']}), min cosine "
                   f"{rec['min_grad_cosine'][1]:.6f}"))
            out[remat] = rec
            del loss, grads
        model.cfg = base
        del ref
        return out

    def ab_runs(tag, model, make_task, names, S):
        """The trainer runs of the A/B: REMAT_AB_STEPS steps under "none"
        and under "block" (and one under "dots" for the LM) from the
        same initial parameters; step 0's losses bitwise equal."""
        init = [p.detach().clone() for p in model.parameters()]
        base = model.cfg
        runs = {}
        plan = [("none", REMAT_AB_STEPS), ("block", REMAT_AB_STEPS)]
        if base.family != "graph":   # the graph model has no "dots"
            plan.append(("dots", 1))
        for remat, steps in plan:
            with torch.no_grad():
                for p, p0 in zip(model.parameters(), init):
                    p.copy_(p0)
            model.cfg = base.replace(remat=remat)
            runs[remat] = train(f"{tag} {remat}", model, make_task(model),
                                steps, names, S)
        model.cfg = base
        first = {r: runs[r]["losses"][0] for r in runs}
        ratio = runs["block"]["step_ms_median"] / \
            runs["none"]["step_ms_median"]
        peak_ratio = runs["block"]["peak_bytes"] / runs["none"]["peak_bytes"]
        log(f"[remat] {tag}: step 0's trainer loss by remat {first}; "
            f"'block' step {ratio:.4f}x and peak {peak_ratio:.4f}x "
            f"'none''s")
        if len(set(first.values())) != 1:
            raise AssertionError(f"{tag}: step 0's losses differ: {first}")
        with torch.no_grad():     # the next run starts from them too
            for p, p0 in zip(model.parameters(), init):
                p.copy_(p0)
        del init
        return {"runs": runs, "block_over_none_step": ratio,
                "block_over_none_peak": peak_ratio}

    rec = {}
    # ------------------------------- Qwen3-0.6B A/B at S=16384, then 65536
    cfg = get_config("qwen3_0_6b").replace(attn_backend="cluster_sparse",
                                           remat="none")
    model = LMModel(cfg, device=dev, seed=0)
    task = lm_task(cfg, REMAT_LM_SEQ).prepare(model)
    tag = f"qwen3-0.6b S={REMAT_LM_SEQ}"
    rec["qwen3_0_6b_ab"] = {
        "op_check": op_check(tag, model, lm_loss, task.batches(0),
                             UNBIASED_NAMES, read_counts),
        "step0": ab_grads(tag, model, lambda m, b: lm_loss(m, b)[0],
                          task.batches(0)),
        **ab_runs(tag, model,
                  lambda m: lm_task(m.cfg, REMAT_LM_SEQ), UNBIASED_NAMES,
                  REMAT_LM_SEQ)}
    del task
    model.cfg = cfg.replace(remat="block")
    tag = f"qwen3-0.6b S={REMAT_LONG_SEQ}"
    task = lm_task(model.cfg, REMAT_LONG_SEQ)
    check = op_check(tag, model, lm_loss, task.prepare(model).batches(0),
                     UNBIASED_NAMES, read_counts)
    rec["qwen3_0_6b_long"] = train(tag, model, task, REMAT_LONG_STEPS,
                                   UNBIASED_NAMES, REMAT_LONG_SEQ)
    rec["qwen3_0_6b_long"]["op_check"] = check
    del model, task

    # ------------------------------------------- Qwen3-1.7B and Qwen3-4B
    cfg = get_config("qwen3_1_7b").replace(attn_backend="cluster_sparse")
    model = LMModel(cfg, device=dev, seed=0)
    task = lm_task(cfg, REMAT_LM_SEQ)
    check = op_check("qwen3-1.7b", model, lm_loss,
                     task.prepare(model).batches(0), UNBIASED_NAMES,
                     read_counts)
    rec["qwen3_1_7b"] = train("qwen3-1.7b", model, task, REMAT_1_7B_STEPS,
                              UNBIASED_NAMES, REMAT_LM_SEQ)
    rec["qwen3_1_7b"]["op_check"] = check
    del model, task
    release()
    cfg = get_config("qwen3_4b").replace(attn_backend="cluster_sparse")
    model = LMModel(cfg, device=dev, seed=0)
    cuts = []
    for S in REMAT_4B_SEQS:
        try:
            task = lm_task(cfg, S)
            check = op_check(f"qwen3-4b S={S}", model, lm_loss,
                             task.prepare(model).batches(0), UNBIASED_NAMES,
                             read_counts)
            rec["qwen3_4b"] = train(f"qwen3-4b S={S}", model, task,
                                    REMAT_4B_STEPS, UNBIASED_NAMES, S)
            rec["qwen3_4b"]["op_check"] = check
            break
        except torch.cuda.OutOfMemoryError as err:
            # the cut the configuration allows: the next sequence length
            cuts.append({"S": S, "peak_bytes":
                         torch.cuda.max_memory_allocated(),
                         "error": str(err).splitlines()[0][:300]})
            log(f"[remat] qwen3-4b S={S} does not fit: peak "
                f"{cuts[-1]['peak_bytes'] / 2**30:.2f} GiB; {cuts[-1]}")
        model.reset_parameters(0)
    else:
        raise AssertionError(f"qwen3-4b fits at none of {REMAT_4B_SEQS}")
    rec["qwen3_4b"]["cuts"] = cuts
    del model, task

    # -------------------------------------------------------- Mamba2-2.7B
    cfg = get_config("mamba2_2_7b").replace(n_layers=REMAT_SSM_LAYERS)
    model = SSMLMModel(cfg, device=dev, seed=0)
    # the plain SSD scan, as the reference's model: no kernel launches
    rec["mamba2_2_7b"] = train("mamba2-2.7b", model,
                               lm_task(cfg, REMAT_SSM_SEQ), REMAT_SSM_STEPS,
                               None, REMAT_SSM_SEQ)
    del model

    # ---------------- Graphormer-Large node training on the serve graph
    release()
    large, g, task, prep_s = graph
    lay = task.layout
    log(f"[remat] graphormer-large: {g.n} nodes, {g.e} edges, "
        f"S={lay.seq_len}, rung beta_thre={task.beta_thre:.5f} "
        f"({lay.stats['active_blocks']} active blocks, mb_cap "
        f"{task.mb_cap}); {len(task._preps)} ladder rung(s) prepared in "
        f"{prep_s:.2f}s ahead of the phase's turn; sparse steps only "
        f"(interleave_period=0: the "
        f"dense step's fp32 (1, H, S, S) bias would be "
        f"{large.n_heads * lay.seq_len ** 2 * 4 / 1e9:.1f} GB), the layout "
        f"frozen (elastic_every=0)")
    model = GraphModel(large, device=dev, seed=0)

    def graph_task(m):
        # the layouts do not depend on remat; Task.prepare compares the
        # whole config, so the task takes the run's
        task.cfg = m.cfg
        return task
    tag = f"graphormer-large S={lay.seq_len}"
    rec["graphormer_large_ab"] = {
        "op_check": op_check(tag, model, graph_loss,
                             task.prepare(model).batches(0), B32_NAMES,
                             read_counts),
        "step0": ab_grads(tag, model, lambda m, b: graph_loss(m, b)[0],
                          task.prepare(model).batches(0)),
        **ab_runs(tag, model, graph_task, B32_NAMES, lay.seq_len),
        "prep_s": prep_s, "active_blocks": lay.stats["active_blocks"],
        "mb_cap": task.mb_cap, "beta_thre": task.beta_thre}
    del model, task
    release()
    return rec, counted


def remat_phase(out_path: str) -> int:
    """Phase 11, in a child process: layer recomputation (``cfg.remat``)
    at full width (``remat_runs``), with ``CUBLAS_WORKSPACE_CONFIG`` from
    the parent and deterministic algorithms on, so that the A/B's
    recomputing backward can match the other bit for bit. A process of
    its own, so Qwen3-4B's ~60 GiB of state meets an empty card. The
    record, with the launches of every trainer run summed, goes to
    ``out_path`` as JSON."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke phase 11: no CUDA device", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import cluster_attention as tca
    from repro_torch.kernels import cluster_attention_bwd as tcab
    from repro_torch.models import layers as L

    # the Large run's graph and task are host work: ahead of the turn
    dev = torch.device("cuda")
    graph = remat_graph_task(dev)
    await_turn(torch)
    t_start = time.perf_counter()
    kbuild.build_all((tca.LIBRARY_SM90, tcab.LIBRARY_DQ_SM90,
                      tcab.LIBRARY_DKV_SM90, tca.LIBRARY_UNBIASED_SM90,
                      tcab.LIBRARY_UNBIASED_SM90))

    reset_counts, read_counts = kernel_counters()
    # every seeded init drawn on the card: no host time (the configs'
    # checks compare runs from one init with each other)
    with L.draw_on_device():
        rec, counted = remat_runs(dev, reset_counts, read_counts, graph)
    rec["launches"] = {k: sum(c[k] for c in counted) for k in read_counts()}
    rec["seconds"] = time.perf_counter() - t_start
    with open(out_path, "w") as fh:
        json.dump(rec, fh)
    log(f"[remat] {rec['seconds']:.1f}s, launches "
        f"{ {k: c for k, c in rec['launches'].items() if c} }")
    return 0


# phase 12: token serving at full width, in a child process (no
# deterministic mode: the pool's scatter writes the padding rows of a
# chunk and the idle slots' rows to one scratch index, in no fixed order)
SERVE_SLOTS = 8
SERVE_PAGE = 16
SERVE_CHUNK = 256
SERVE_MAX_LEN = 4096
SERVE_REQUESTS = 8              # room for phase 15 (PERF.md 4)
SERVE_PROMPT = (128, 3840)
SERVE_NEW = 128
SERVE_WARM_REQUESTS = 2         # room for phases 13 and 15 (PERF.md 4)
SPARSE_MAX_LEN = 8192           # past the window (4096), so that it binds
SPARSE_REQUESTS = 4             # room for phase 15 (PERF.md 4)
SPARSE_PROMPT = (4500, 8000)
SPARSE_NEW = 64
F32_REQUESTS = 4
F32_PROMPT = (64, 256)
F32_NEW = 32
CHECKED_REQUESTS = 1            # of (b), held to its oracle
# (c): an engine token must be the oracle's argmax wherever the oracle's
# top-2 margin exceeds this, and lie within it of the oracle's max
# elsewhere. bf16 logits of magnitude 2-4 are 2^-6 apart; this is 4 such
# steps, 2.7x the largest first-token logit difference measured between
# the engine's chunked prefill and its oracle (0.0234)
TOL_TOKEN_MARGIN = 0.0625
LONG_CHECK_SEQ = 16384          # (d), held to impl="plain"
LONG_SEQ = 65536
LONG_DECODE = 16                # cut from 64: room for phase 15
SSM_PREFILL_SEQ = 256           # (e); cut from 512: room for phase 15
SSM_DECODE = 16                 # (e); cut from 64
# (e): the reference's prefill-vs-decode tolerance
# (tests/test_serve_consistency.py:64-67), which holds the fp32 model; the
# bf16 model's gap at 64 layers is reported beside it
TOL_SSM_ATOL, TOL_SSM_RTOL = 0.15, 0.05
ENGINE_GRAPH_REPS = 10


def cuda_graph(fn):
    """A CUDA graph of ``fn()``, whose inputs are static tensors it closes
    over: two warm-up calls on a side stream, then the capture. Returns
    ``(graph, out)``; ``graph.replay()`` reruns every kernel of ``fn`` on
    the inputs' current values and rewrites ``out`` in place."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def release() -> int:
    """Free what the last run left; returns the bytes still allocated."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def event_pair():
    import torch

    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def pct(xs, q):
    """The reference CLI's percentiles (``launch/serve.py``)."""
    xs = sorted(xs)
    return xs[len(xs) // 2] if q == 50 else \
        xs[min(len(xs) - 1, int(len(xs) * q / 100))]


def serve_engine(model, max_len, sparse):
    """A ``ServeEngine`` at the serving phases' settings (SERVE_SLOTS
    slots, SERVE_PAGE, SERVE_CHUNK), its pool's bytes checked against the
    arithmetic (every layer's k and v, bf16), and CUDA events around
    every call of its two programs (each call's time on the device's
    clock, host issue gaps included): ``(engine, events)``."""
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(model, batch_slots=SERVE_SLOTS, page=SERVE_PAGE,
                      max_len=max_len, chunk=SERVE_CHUNK, sparse=sparse)
    want = (2 * model.cfg.n_layers * eng.allocator.num_blocks
            * SERVE_PAGE * model.cfg.kv_heads * model.cfg.head_dim * 2)
    if eng.pool_bytes() != want:
        raise AssertionError(f"pool {eng.pool_bytes()} B, want {want}")
    ev = {"prefill": [], "decode": []}
    for name, prog in (("prefill", eng._prefill), ("decode", eng._decode)):
        def wrapped(*a, _fn=prog.fn, _ev=ev[name], **kw):
            s, e = event_pair()
            s.record()
            out = _fn(*a, **kw)
            e.record()
            _ev.append((s, e))
            return out
        prog.fn = wrapped
    return eng, ev


def serve_engine_run(tag, eng, ev, prompts, n_new, reset_counts,
                     read_counts, gap=0.0, rid0=0, log_tag="serve-lm"):
    """Serve ``prompts`` (arrivals ``gap`` s apart) through ``eng`` (of
    ``serve_engine``) with its launch counts at 0 before and read after;
    checks the two-program budget, the drained pool, every stream's
    length and that no kernel launched. Returns the run's record."""
    import numpy as np
    import torch

    zero = {name: 0 for name in read_counts()}
    n_pf, n_dc = len(ev["prefill"]), len(ev["decode"])
    n_rows = len(eng.request_stats)
    for i, p in enumerate(prompts):
        eng.submit(rid0 + i, p, n_new, arrival=i * gap)
    release()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stats = eng.run()
    counts = read_counts()
    torch.cuda.synchronize()
    rows = eng.request_stats[n_rows:]
    pf = [s.elapsed_time(e) for s, e in ev["prefill"][n_pf:]]
    dc = [s.elapsed_time(e) for s, e in ev["decode"][n_dc:]]
    new = sum(r["new_tokens"] for r in rows)
    sec = stats["seconds"]
    out = {
        "requests": len(rows), "new_tokens": new,
        "prompt_tokens": sum(len(p) for p in prompts),
        "seconds": sec, "tok_per_s": new / sec,
        "req_per_s": len(rows) / sec, "arrival_gap_s": gap,
        "latency_p50_s": pct([r["latency_s"] for r in rows], 50),
        "latency_p99_s": pct([r["latency_s"] for r in rows], 99),
        "ttft_p50_s": pct([r["ttft_s"] for r in rows], 50),
        "ttft_p99_s": pct([r["ttft_s"] for r in rows], 99),
        "prefill_calls": len(pf), "decode_calls": len(dc),
        "prefill_chunk_ms": float(np.median(pf)),
        "decode_step_ms": float(np.median(dc)),
        "decode_step_ms_p90": float(np.percentile(dc, 90)),
        "device_busy_s": (sum(pf) + sum(dc)) / 1e3,
        "traced_programs": stats["traced_programs"],
        "pool_bytes": eng.pool_bytes(),
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "free_blocks": eng.allocator.n_free,
        "usable_blocks": eng.allocator.num_blocks - 1}
    log(f"[{log_tag}] {tag}: {json.dumps(out)}")
    if out["traced_programs"] != 2:
        raise AssertionError(f"{tag}: {out['traced_programs']} programs")
    if out["free_blocks"] != out["usable_blocks"] or eng.allocator.n_live:
        raise AssertionError(f"{tag}: blocks still live at drain")
    if len(rows) != len(prompts) or any(
            len(eng.done[rid0 + i]) != n_new for i in range(len(prompts))):
        raise AssertionError(f"{tag}: a request did not finish")
    if counts != zero:
        raise AssertionError(f"{tag}: the engine's path launched kernels: "
                             f"{counts}")
    return out


def margin_check(tag, logits, out):
    """``logits`` (n, V) fp32 of the oracle at the positions that chose
    ``out``'s n tokens: each token the oracle's argmax where its top-2
    margin exceeds TOL_TOKEN_MARGIN, and within it of the max
    elsewhere."""
    import torch

    top = logits.topk(2, dim=-1).values
    margin = top[:, 0] - top[:, 1]
    tok = torch.tensor(out, device=logits.device)
    strict = margin > TOL_TOKEN_MARGIN
    wrong = strict & (logits.argmax(-1) != tok)
    near = logits.gather(1, tok[:, None])[:, 0] >= \
        top[:, 0] - TOL_TOKEN_MARGIN
    res = {"checked": int(strict.sum()), "skipped": int((~strict).sum()),
           "mismatched": int(wrong.sum()),
           "outside_tolerance": int((~strict & ~near).sum()),
           "median_margin": float(margin.median())}
    if res["mismatched"] or res["outside_tolerance"]:
        raise AssertionError(f"{tag}: engine tokens disagree with the "
                             f"oracle: {res}")
    return res


def serve_runs(dev, reset_counts, read_counts) -> dict:
    """Phase 12's runs on ``dev``, each at full width and depth with
    seeded weights. (a) Qwen3-0.6B as published (bf16, dense attention)
    through ``ServeEngine``, then a second batch on the warm engine; (b)
    the same engine with the cluster-sparse decode mask at max_len 8192;
    (c) requests of (a) and (b) held to oracles, teacher-forced over the
    engine's own tokens, and an fp32 engine's streams to the contiguous
    greedy decode; (d) Qwen3-0.6B on the cluster-sparse backend:
    ``lm_prefill`` at S=16384 held to ``impl="plain"``, at S=65536, then
    16 tokens of sparse ``lm_decode_step``, row 2's launches counted
    exactly; (e) Mamba2-2.7B's prefill against 256 decode steps, then 16
    tokens. The engine's path launches no kernel (``paged_attention`` is
    plain on every device, as in the reference): its counts must stay 0.
    The engine's two programs are also replayed as CUDA graphs on the
    same shapes, which gives their device time without the host's issue
    gaps, and the long decode loops of the oracles run as CUDA graphs of
    the same steps. One set of seeded parameters per model serves each
    of its configs (the models read ``cfg`` at every call). Returns the
    phase's record, with row 2's launches under ``launches``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.api import SSMLMModel
    from repro_torch.models.lm import (LMModel, lm_decode_step, lm_forward,
                                       lm_prefill)

    rec = {}
    zero = {name: 0 for name in read_counts()}
    launches = dict(zero)
    rng = np.random.default_rng(0)

    def prompts_of(cfg, n, lo, hi, drawn=None):
        """``n`` seeded prompts of ``lo``-``hi`` tokens, the first of
        ``drawn`` (default ``n``) drawn: a run cut to fewer requests draws
        as many as before, so the later draws stay the same prompts."""
        got = [rng.integers(1, cfg.vocab_size, int(m)).tolist()
               for m in rng.integers(lo, hi + 1, drawn or n)]
        return got[:n]

    def run_engine(tag, eng, ev, prompts, n_new, gap=0.0, rid0=0):
        return serve_engine_run(tag, eng, ev, prompts, n_new, reset_counts,
                                read_counts, gap=gap, rid0=rid0)

    def chunked_first_logits(model, prompt, sparse):
        """The engine's prefill program over ``prompt`` alone (a pool of
        its own): the logits that chose its first token, (V,) fp32."""
        nb = -(-len(prompt) // SERVE_PAGE)
        pool = model.paged_cache_defs(nb + 1, SERVE_PAGE)
        bt = torch.arange(1, nb + 1, device=dev)[None]
        with torch.inference_mode():
            for off in range(0, len(prompt), SERVE_CHUNK):
                n = min(SERVE_CHUNK, len(prompt) - off)
                toks = torch.zeros((1, SERVE_CHUNK), dtype=torch.int64,
                                   device=dev)
                toks[0, :n] = torch.tensor(prompt[off:off + n], device=dev)
                logits, _ = model.prefill_chunk(pool, toks, off, n, bt,
                                                sparse=sparse)
        return logits[0, 0, :model.cfg.vocab_size].float()

    def first_logit_err(model, prompt, oracle_row, sparse):
        got = chunked_first_logits(model, prompt, sparse)
        return {"first_token_logit_err": float((got - oracle_row).abs()
                                               .max()),
                "first_token_logit_max": float(oracle_row.abs().max())}

    def engine_steps(tag, eng):
        """One decode step and one prefill chunk of ``eng``'s programs at
        their engine shapes (idle slots and a zero block table: every
        write lands in scratch block 0; the gather reads every slot's
        whole table, as a live step does): eager wall ms (host clock to
        a sync), device ms replayed as a CUDA graph, and one eager call
        profiled by kernel."""
        m, B, nmax = eng.model, eng.B, eng.nmax
        res = {}
        with torch.inference_mode():
            tok, pos = (torch.zeros((B, 1), dtype=torch.int64, device=dev),
                        torch.zeros(B, dtype=torch.int64, device=dev))
            bt = torch.zeros((B, nmax), dtype=torch.int64, device=dev)
            ptok = torch.zeros((1, eng.chunk), dtype=torch.int64,
                               device=dev)
            for name, fn in (
                    ("decode_step", lambda: m.paged_decode(
                        eng.pool, tok, pos, bt, sparse=eng.sparse)[0]),
                    ("prefill_chunk", lambda: m.prefill_chunk(
                        eng.pool, ptok, 0, eng.chunk, bt[:1],
                        sparse=eng.sparse)[0])):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(ENGINE_GRAPH_REPS):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / ENGINE_GRAPH_REPS
                graph, _ = cuda_graph(fn)
                s, e = event_pair()
                s.record()
                for _ in range(ENGINE_GRAPH_REPS):
                    graph.replay()
                e.record()
                e.synchronize()
                del graph
                res[name] = {
                    "eager_ms": wall,
                    "graph_ms": s.elapsed_time(e) / ENGINE_GRAPH_REPS,
                    "profile": device_breakdown(
                        fn, wall, tag="serve-lm",
                        what=f"{tag}: one {name.replace('_', ' ')}")}
        log(f"[serve-lm] {tag}: a decode step {res['decode_step']['eager_ms']:.3f} "
            f"ms eager, {res['decode_step']['graph_ms']:.3f} ms as a CUDA "
            f"graph; a prefill chunk {res['prefill_chunk']['eager_ms']:.3f} "
            f"/ {res['prefill_chunk']['graph_ms']:.3f} ms")
        return res

    # ------------------------------------------------- (a) dense engine
    cfg = get_config("qwen3_0_6b")
    V = cfg.vocab_size
    t0 = time.perf_counter()
    model = LMModel(cfg, device=dev, seed=0)
    rec["init_s"] = time.perf_counter() - t0
    eng, ev = serve_engine(model, SERVE_MAX_LEN, sparse=False)
    pa = prompts_of(cfg, SERVE_REQUESTS, *SERVE_PROMPT, drawn=16)
    rec["a"] = run_engine("(a) dense", eng, ev, pa, SERVE_NEW)
    rec["a_warm"] = run_engine(
        "(a) warm", eng, ev, prompts_of(cfg, SERVE_WARM_REQUESTS,
                                        *SERVE_PROMPT, drawn=4),
        SERVE_NEW, gap=2.0 / rec["a"]["req_per_s"], rid0=1000)
    rec["a"]["steps"] = engine_steps("(a)", eng)

    # (c) two of (a): the full causal forward over the engine's sequence,
    # whose logits at position t are lm_prefill's over the prefix ending
    # at t; the request with the longest prompt and the first
    longest = max(range(len(pa)), key=lambda i: len(pa[i]))
    checks = []
    for rid in (longest, 0 if longest else 1):
        prompt, out = pa[rid], eng.done[rid]
        with torch.inference_mode():
            seq = torch.tensor([prompt + out[:-1]], device=dev)
            h, _ = lm_forward(model, {"tokens": seq})
            logits = L.logits_fn(model.embed, cfg, h[:, len(prompt) - 1:])
            logits = logits[0, :, :V].float()
        res = margin_check(f"(c) dense request {rid}", logits, out)
        res.update(rid=rid, prompt_len=len(prompt),
                   **first_logit_err(model, prompt, logits[0], False))
        checks.append(res)
        del h, logits
    rec["c_dense"] = checks
    log(f"[serve-lm] (c) dense, teacher-forced against the full forward: "
        f"{json.dumps(checks)}")
    del eng, ev
    release()

    # -------------------------------------------------- (b) sparse engine
    eng, ev = serve_engine(model, SPARSE_MAX_LEN, sparse=True)
    pb = prompts_of(cfg, SPARSE_REQUESTS, *SPARSE_PROMPT, drawn=8)
    rec["b"] = run_engine("(b) sparse", eng, ev, pb, SPARSE_NEW)
    rec["b"]["steps"] = engine_steps("(b)", eng)

    # (c) the two shortest of (b): contiguous lm_decode_step with the
    # sparse mask, teacher-forced, both in one batch at shared positions.
    # Below the window the sparse decode mask keeps every earlier row, so
    # the first `window` positions' caches come from lm_prefill (dense,
    # causal: the same mask there); every position from the window on,
    # where the window binds, is one decode step, replayed as a CUDA
    # graph of lm_decode_step at a device-side position
    W = cfg.window
    rids = sorted(range(len(pb)), key=lambda i: len(pb[i]))[:CHECKED_REQUESTS]
    seqs = [pb[r] + eng.done[r][:-1] for r in rids]
    Lmax = max(len(q) for q in seqs)
    toks = torch.zeros((len(rids), Lmax), dtype=torch.int64, device=dev)
    for i, q in enumerate(seqs):
        toks[i, :len(q)] = torch.tensor(q, device=dev)
    got = torch.zeros((len(rids), SPARSE_NEW, V), device=dev)
    starts = [len(pb[r]) - 1 for r in rids]
    t0 = time.perf_counter()
    with torch.inference_mode():
        _, cache = lm_prefill(model, {"tokens": toks[:, :W]}, cache_len=Lmax)
        st_tok = toks[:, W:W + 1].clone()
        st_pos = torch.full((), W, dtype=torch.int64, device=dev)
        graph, out = cuda_graph(lambda: lm_decode_step(
            model, cache, st_tok, st_pos, sparse=True)[0])
        s, e = event_pair()
        s.record()
        for p in range(W, Lmax):
            st_tok.copy_(toks[:, p:p + 1])
            st_pos.fill_(p)
            graph.replay()
            for i, s0 in enumerate(starts):
                if s0 <= p < s0 + SPARSE_NEW:
                    got[i, p - s0] = out[i, 0, :V].float()
        e.record()
    e.synchronize()
    oracle_s = time.perf_counter() - t0
    oracle_step_ms = s.elapsed_time(e) / (Lmax - W)
    del graph, out
    checks = []
    for i, r in enumerate(rids):
        res = margin_check(f"(c) sparse request {r}", got[i], eng.done[r])
        res.update(rid=r, prompt_len=len(pb[r]),
                   **first_logit_err(model, pb[r], got[i, 0], True))
        checks.append(res)
    rec["c_sparse"] = {"checks": checks, "oracle_s": oracle_s,
                       "decode_steps": Lmax - W,
                       "oracle_step_graph_ms": oracle_step_ms}
    log(f"[serve-lm] (c) sparse, teacher-forced against contiguous sparse "
        f"decode ({Lmax - W} steps as a CUDA graph, {oracle_step_ms:.3f} "
        f"ms each, {oracle_s:.1f} s): {json.dumps(checks)}")
    del eng, ev, cache, got, toks
    release()

    # -------------------------------------- (c) an fp32 engine, full width
    model.cfg = cfg.replace(dtype="float32")
    eng, ev = serve_engine(model, SERVE_MAX_LEN, sparse=False)
    pf = prompts_of(cfg, F32_REQUESTS, *F32_PROMPT)
    rec["c_f32"] = run_engine("(c) fp32 engine", eng, ev, pf, F32_NEW)
    # the contiguous greedy decode, all four in one batch at shared
    # positions: a row feeds its prompt, then its own greedy tokens; each
    # step a replay of a CUDA graph of lm_decode_step
    plen = torch.tensor([len(p) for p in pf], device=dev)
    Lmax = max(len(p) for p in pf) + F32_NEW
    toks = torch.zeros((len(pf), Lmax), dtype=torch.int64, device=dev)
    for i, p in enumerate(pf):
        toks[i, :len(p)] = torch.tensor(p, device=dev)
    nxt = torch.zeros(len(pf), dtype=torch.int64, device=dev)
    with torch.inference_mode():
        cache = model.cache_defs(len(pf), Lmax)
        st_tok = toks[:, :1].clone()
        st_pos = torch.zeros((), dtype=torch.int64, device=dev)
        graph, out = cuda_graph(
            lambda: lm_decode_step(model, cache, st_tok, st_pos)[0])
        for p in range(Lmax - 1):
            st_tok.copy_(torch.where(p < plen, toks[:, p], nxt)[:, None])
            st_pos.fill_(p)
            graph.replay()
            nxt = out[:, 0, :V].float().argmax(-1)
            toks[:, p + 1] = torch.where(p + 1 < plen, toks[:, p + 1], nxt)
        del graph, out
    oracle = [toks[i, len(p):len(p) + F32_NEW].tolist()
              for i, p in enumerate(pf)]
    same = [oracle[i] == eng.done[i] for i in range(len(pf))]
    rec["c_f32"]["streams_equal"] = same
    log(f"[serve-lm] (c) fp32 engine streams equal to the contiguous "
        f"greedy decode: {same}")
    if not all(same):
        raise AssertionError(f"(c) fp32 streams differ: "
                             f"{[(eng.done[i], oracle[i]) for i in range(len(pf)) if not same[i]]}")
    del eng, ev, cache
    release()

    # ------------------------- (d) long-context prefill through row 2
    cfg_s = cfg.replace(attn_backend="cluster_sparse")
    model.cfg = cfg_s
    fwd = "cluster_attention_fwd_unbiased_sm90"
    want = {**zero, fwd: cfg_s.n_layers}
    d = {}
    tok = torch.from_numpy(rng.integers(1, V, (1, LONG_CHECK_SEQ))).to(dev)

    def prefill_timed(batch, **kw):
        s, e = event_pair()
        with torch.inference_mode():
            s.record()
            out = lm_prefill(model, batch, **kw)
            e.record()
        e.synchronize()
        return out, s.elapsed_time(e)

    prefill_timed({"tokens": tok[:, :1024]})      # warm-up, not counted
    release()
    reset_counts()
    (lk, ck), d["prefill_ms_16384"] = prefill_timed({"tokens": tok})
    counts = read_counts()
    if counts != want:
        raise AssertionError(f"(d) S={LONG_CHECK_SEQ}: launches {counts}, "
                             f"want {cfg_s.n_layers} of {fwd}")
    launches[fwd] += counts[fwd]
    (lp, cp), d["plain_prefill_ms_16384"] = prefill_timed({"tokens": tok},
                                                           impl="plain")
    if read_counts() != want:
        raise AssertionError("(d) the plain prefill launched a kernel")
    a, b = lk[0, 0, :V].float(), lp[0, 0, :V].float()
    d["logits_rel_err"] = float((a - b).abs().max() / b.abs().max())
    d["argmax_equal"] = bool(a.argmax() == b.argmax())
    worst = {"rel_err": 0.0, "cosine": 1.0}
    for key in ("k", "v"):
        for i in range(cfg_s.n_layers):
            x, y = ck["layers"][key][i].float(), cp["layers"][key][i].float()
            worst["rel_err"] = max(worst["rel_err"], float(
                (x - y).abs().max() / y.abs().max()))
            worst["cosine"] = min(worst["cosine"], float(
                torch.nn.functional.cosine_similarity(x.flatten(),
                                                      y.flatten(), dim=0)))
    d["cache_worst"] = worst
    log(f"[serve-lm] (d) S={LONG_CHECK_SEQ} prefill, kernel vs plain: "
        f"{d['prefill_ms_16384']:.3f} / {d['plain_prefill_ms_16384']:.3f} "
        f"ms, logits rel err {d['logits_rel_err']:.3e} (tol "
        f"{TOL_LOGITS_REL}), argmax equal {d['argmax_equal']}, every "
        f"layer's k/v: worst rel err {worst['rel_err']:.3e} (tol "
        f"{TOL_LOGITS_REL}), cosine {worst['cosine']:.6f} (min "
        f"{MIN_GRAD_COSINE})")
    if d["logits_rel_err"] > TOL_LOGITS_REL or not d["argmax_equal"] or \
            worst["rel_err"] > TOL_LOGITS_REL or \
            worst["cosine"] < MIN_GRAD_COSINE:
        raise AssertionError(f"(d) kernel prefill disagrees with plain: {d}")
    del lk, ck, lp, cp
    release()

    tok = torch.from_numpy(rng.integers(1, V, (1, LONG_SEQ))).to(dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (logits, cache), d["prefill_ms_65536"] = prefill_timed(
        {"tokens": tok}, cache_len=LONG_SEQ + LONG_DECODE)
    d["prefill_peak_bytes_65536"] = torch.cuda.max_memory_allocated()
    d["cache_bytes"] = sum(x.numel() * x.element_size()
                           for x in cache["layers"].values())
    nxt = logits[:, 0, :V].float().argmax(-1)
    s, e = event_pair()
    with torch.inference_mode():
        s.record()
        for p in range(LONG_SEQ, LONG_SEQ + LONG_DECODE):
            logits, cache = lm_decode_step(model, cache, nxt[:, None], p,
                                           sparse=True)
            nxt = logits[:, 0, :V].float().argmax(-1)
        e.record()
    e.synchronize()
    counts = read_counts()
    if counts != want:
        raise AssertionError(f"(d) S={LONG_SEQ}: launches {counts}, want "
                             f"{cfg_s.n_layers} of {fwd} (decode none)")
    launches[fwd] += counts[fwd]
    d["decode_ms_per_token"] = s.elapsed_time(e) / LONG_DECODE
    d["decode_finite"] = bool(torch.isfinite(logits).all())
    with torch.inference_mode():   # rewrites the last row, read no more
        d["decode_profile"] = device_breakdown(
            lambda: lm_decode_step(model, cache, nxt[:, None],
                                   LONG_SEQ + LONG_DECODE - 1, sparse=True),
            d["decode_ms_per_token"], tag="serve-lm",
            what="(d) one decode step over 65600 cache rows")
    d["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[serve-lm] (d) S={LONG_SEQ} prefill {d['prefill_ms_65536']:.3f} "
        f"ms, peak {d['prefill_peak_bytes_65536'] / 2**30:.2f} GiB "
        f"(caches {d['cache_bytes'] / 1e9:.3f} GB); {LONG_DECODE} sparse "
        f"decode tokens {d['decode_ms_per_token']:.3f} ms a token, peak "
        f"{d['peak_bytes'] / 2**30:.2f} GiB; row 2 launched "
        f"{launches[fwd]} times in (d)")
    if not d["decode_finite"]:
        raise AssertionError("(d) decode after 65536: non-finite logits")
    rec["d"] = d
    del cache, logits, model
    release()

    # ---------------------------------------------------- (e) Mamba2-2.7B
    scfg = get_config("mamba2_2_7b")
    Vs = scfg.vocab_size
    model = SSMLMModel(scfg, device=dev, seed=0)
    tok = torch.from_numpy(rng.integers(1, Vs, (1, SSM_PREFILL_SEQ))).to(dev)

    def ssm_prefill_vs_decode():
        """Prefill logits at S=512 and those of 512 decode steps over the
        same tokens (a CUDA graph of ``ssm_lm_decode``, its new caches
        copied into the static ones after each replay), as fp32 numpy;
        the caches the decode ends with; prefill ms; decode ms a step."""
        with torch.inference_mode():
            s, e = event_pair()
            s.record()
            full, _ = model.prefill({"tokens": tok})
            e.record()
            cache = model.cache_defs(1, SSM_PREFILL_SEQ)
            # an fp32 model keeps its conv history in fp32 from its first
            # step on, as the reference's does; zeros are exact in either
            hist = torch.promote_types(torch.bfloat16,
                                       getattr(torch, model.cfg.dtype))
            cache["layers"]["conv"] = cache["layers"]["conv"].to(hist)
            st_tok = tok[:, :1].clone()
            graph, (out, new) = cuda_graph(
                lambda: model.decode(cache, st_tok, 0))
            s2, e2 = event_pair()
            s2.record()
            for i in range(SSM_PREFILL_SEQ):
                st_tok.copy_(tok[:, i:i + 1])
                graph.replay()
                for key, val in new["layers"].items():
                    cache["layers"][key].copy_(val)
            e2.record()
            e2.synchronize()
            a = full[0, 0, :Vs].float().cpu().numpy()
            b = out[0, 0, :Vs].float().cpu().numpy()
            nxt = out[:, 0, :Vs].float().argmax(-1)
        del graph
        return (a, b, cache, nxt, s.elapsed_time(e),
                s2.elapsed_time(e2) / SSM_PREFILL_SEQ)

    reset_counts()
    ssm = {}
    a, b, cache, nxt, ssm["prefill_ms"], ssm["decode_step_graph_ms"] = \
        ssm_prefill_vs_decode()
    outside = np.abs(a - b) > TOL_SSM_ATOL + TOL_SSM_RTOL * np.abs(b)
    ssm["bfloat16"] = {"max_abs_err": float(np.abs(a - b).max()),
                       "max_abs_logit": float(np.abs(a).max()),
                       "share_outside_tolerance": float(outside.mean()),
                       "argmax_equal": bool(a.argmax() == b.argmax())}
    # 64 tokens from the 512-token state, eager, as a caller decodes
    s, e = event_pair()
    with torch.inference_mode():
        s.record()
        for i in range(SSM_DECODE):
            logits, cache = model.decode(cache, nxt[:, None],
                                         SSM_PREFILL_SEQ + i)
            nxt = logits[:, 0, :Vs].float().argmax(-1)
        e.record()
    e.synchronize()
    ssm["decode_ms_per_token"] = s.elapsed_time(e) / SSM_DECODE
    ssm["finite"] = bool(torch.isfinite(logits).all())
    del cache, logits
    # the same parameters as an fp32 model: held to the reference's
    # tolerance
    model.cfg = scfg.replace(dtype="float32")
    a, b, cache, _, _, _ = ssm_prefill_vs_decode()
    ssm["float32"] = {"max_abs_err": float(np.abs(a - b).max()),
                      "max_abs_logit": float(np.abs(a).max()),
                      "argmax_equal": bool(a.argmax() == b.argmax())}
    if read_counts() != zero:
        raise AssertionError(f"(e) Mamba2 launched kernels: {read_counts()}")
    rec["e"] = ssm
    log(f"[serve-lm] (e) Mamba2-2.7B: prefill S={SSM_PREFILL_SEQ} "
        f"{ssm['prefill_ms']:.3f} ms; prefill logits vs {SSM_PREFILL_SEQ} "
        f"decode steps: fp32 max |diff| {ssm['float32']['max_abs_err']:.3e} "
        f"(atol {TOL_SSM_ATOL}, rtol {TOL_SSM_RTOL}, the reference's), "
        f"argmax equal {ssm['float32']['argmax_equal']}; bf16 max |diff| "
        f"{ssm['bfloat16']['max_abs_err']:.4f} of max |logit| "
        f"{ssm['bfloat16']['max_abs_logit']:.3f}, "
        f"{100 * ssm['bfloat16']['share_outside_tolerance']:.2f}% of "
        f"logits outside that tolerance, argmax equal "
        f"{ssm['bfloat16']['argmax_equal']}; a decode step as a CUDA graph "
        f"{ssm['decode_step_graph_ms']:.3f} ms, {SSM_DECODE} tokens eager "
        f"{ssm['decode_ms_per_token']:.3f} ms a token")
    np.testing.assert_allclose(a, b, atol=TOL_SSM_ATOL, rtol=TOL_SSM_RTOL)
    if not ssm["float32"]["argmax_equal"] or not ssm["finite"]:
        raise AssertionError(f"(e) Mamba2 prefill/decode: {ssm}")
    del cache, model
    release()
    rec["launches"] = launches
    return rec


def serve_lm_phase(out_path: str) -> int:
    """Phase 12, in a child process: token serving at full width
    (``serve_runs``), on an empty card. Not under deterministic
    algorithms: the pool's ``index_copy_`` writes duplicate scratch
    indices. The record goes to ``out_path`` as JSON."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke phase 12: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import cluster_attention as tca
    from repro_torch.models import layers as L

    await_turn(torch)
    t_start = time.perf_counter()
    kbuild.build_all((tca.LIBRARY_UNBIASED_SM90,))

    reset_counts, read_counts = kernel_counters()
    # the seeded inits drawn on the card: no host time (every check holds
    # the engine to oracles on the same weights)
    with L.draw_on_device():
        rec = serve_runs(torch.device("cuda"), reset_counts, read_counts)
    rec["seconds"] = time.perf_counter() - t_start
    with open(out_path, "w") as fh:
        json.dump(rec, fh)
    log(f"[serve-lm] {rec['seconds']:.1f}s, launches "
        f"{ {k: c for k, c in rec['launches'].items() if c} }")
    return 0


# phase 13: the MoE family and the hybrid, in a child process. (a)
# Qwen3-235B-A22B at full width, its depth cut to one layer, trained on
# the cluster-sparse backend; (b) (a)'s weights served as published
# (dense attention); (c) Jamba-v0.1 at a quarter of its width, one period
# of 8 layers (full width, ~13e9 parameters, is ~208 GB of training
# state: no single card holds it)
MOE_ARCH = "qwen3_moe_235b_a22b"
MOE_LAYERS = 1
MOE_SEQS = (4096, 2048)       # (a): the first that fits; never the width
MOE_STEPS = 3
MOE_OP_TOKENS = 1024          # (a): the MoE op, card against CPU, fp32
MOE_SERVE_MAX_LEN = 2048      # (b)
MOE_SERVE_REQUESTS = 16
MOE_SERVE_PROMPT = (128, 1536)
MOE_SERVE_NEW = 32
JAMBA_ARCH = "jamba_v0_1_52b"
# (c): a quarter of d_model, heads and expert width; head_dim, kv heads'
# share, experts, top-k, the Mamba2 block's expand, state and head, and
# the vocab as published
JAMBA_CUT = dict(n_layers=8, d_model=1024, n_heads=8, n_kv_heads=2,
                 d_head=128, d_ff=3584, moe_d_ff=3584)
JAMBA_SEQ = 2048
JAMBA_BATCH = 2
JAMBA_STEPS = 3
JAMBA_PREFILL_SEQ = 256        # cut from 512: room for phase 15
# (a): the MoE op on the card against the same op on the CPU, both fp32
# with TF32 off: the largest difference over the largest output (sums in
# another order). A token whose top-k differs between the two (a near
# tie in fp32) is counted and left out of that bound, at most
# MOE_OP_MAX_FLIPS of the tokens
TOL_MOE_OP = 1e-4
MOE_OP_MAX_FLIPS = 1e-3
# step 0, kernel path against impl="plain": the attention's bf16
# roundings move the router's input, and a near tie may route a token
# elsewhere. At most this share of the (token, slot) choices may differ,
# by run: about the geometric middle between the shares
# tools/moe_routing.py reads on an H100 with the kernels (a: 0.65-0.83%,
# c: 0-0.012% over 8 batches) and with an attention made wrong on
# purpose (a: 29.8-97.5%, c: 0.23-0.32%). The kernels themselves are
# held by op_check; this bounds what routing may absorb
MAX_ROUTE_FLIPS = {"(a)": 0.05, "(c)": 5e-4}


def moe_runs(dev, reset_counts, read_counts) -> dict:
    """Phase 13's runs on ``dev``: (a) Qwen3-235B-A22B at full width (one
    layer) trained through the Trainer on the cluster-sparse backend,
    its MoE op held to the CPU's, its attention kernels held to their
    plain versions on layer 0's own q, k, v (``op_check``: 64 query heads
    over 4), step 0 held to ``impl="plain"``, a step profiled; (b) the same weights served as published through
    ``ServeEngine``, two requests held to the contiguous oracle; (c)
    Jamba-v0.1 at a quarter width trained the same way (its attention
    slot's kernels held by ``op_check`` too), then its prefill
    against JAMBA_PREFILL_SEQ decode steps. Every training run's launches of rows 2, 5
    and 6 counted exactly; returns the phase's record and those counts
    (``launches``, and the fp32 prefill's under ``launches_float32``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch
    from repro_torch.models import layers as L
    from repro_torch.models import moe as tmoe
    from repro_torch.models.hybrid import HybridLMModel, hybrid_loss
    from repro_torch.models.lm import (LMModel, lm_decode_step, lm_loss,
                                       lm_prefill)
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tasks import BatchFnTask

    rec = {}
    zero = {name: 0 for name in read_counts()}
    launches = dict(zero)
    rng = np.random.default_rng(0)

    def want_counts(cfg, steps, n_attn):
        return {**zero, **step_launches(cfg, UNBIASED_NAMES, steps, n_attn)}

    def step_vs_plain(tag, model, loss_fn, batch, n_attn, max_flips):
        """Step 0's loss and gradients, kernel path against
        ``impl="plain"`` on the same parameters and batch, outside the
        main path's counts: the loss within TOL_STEP_LOSS_REL, every
        parameter's gradient at a cosine of at least MIN_GRAD_COSINE, and
        at most ``max_flips`` of the (token, slot) routing choices
        different (every MoE call's, the recomputed ones included)."""
        named = list(model.named_parameters())
        params = [p for _, p in named]
        real = tmoe._route
        out = {}
        for impl in (None, "plain"):
            routes = []

            def spy(w, xt, k, _seen=routes, **kw):
                res = real(w, xt, k, **kw)
                _seen.append(res[1])
                return res
            tmoe._route = spy
            before = read_counts()
            try:
                loss, met = loss_fn(model, batch, impl=impl)
                grads = torch.autograd.grad(loss, params)
            finally:
                tmoe._route = real
            torch.cuda.synchronize()
            launched = {n: c - before[n] for n, c in read_counts().items()
                        if c != before[n]}
            out[impl] = (loss.detach().float(),
                         {k: v.item() for k, v in met.items()}, grads,
                         routes, launched)
            del loss, grads
        (kl, kmet, kg, kr, kn), (pl_, pmet, pg, pr, pn) = out[None], \
            out["plain"]
        cos = {n: F.cosine_similarity(a.flatten().float(),
                                      c.flatten().float(), dim=0,
                                      eps=1e-30).item()
               for (n, _), a, c in zip(named, kg, pg)}
        worst = min(cos, key=cos.get)
        flips = sum(int((a != b).sum()) for a, b in zip(kr, pr))
        choices = sum(a.numel() for a in kr)
        res = {"loss": kl.item(), "plain_loss": pl_.item(),
               "loss_rel": (abs(kl - pl_) / abs(pl_)).item(),
               "metrics": kmet, "plain_metrics": pmet,
               "min_grad_cosine": [worst, cos[worst]],
               "route_flips": flips, "route_choices": choices,
               "launched": kn}
        log(f"[moe] {tag}: step 0, kernel vs plain path: loss "
            f"{res['loss']:.6f} vs {res['plain_loss']:.6f} (rel "
            f"{res['loss_rel']:.3g}, tol {TOL_STEP_LOSS_REL}); aux "
            f"{kmet['aux']:.6f} vs {pmet['aux']:.6f}; gradient cosine min "
            f"{cos[worst]:.6f} ({worst}; min {MIN_GRAD_COSINE}); routing "
            f"choices differing {flips} of {choices} "
            f"({flips / max(choices, 1):.3%}, max {max_flips:.3%}); "
            f"kernels launched {kn}")
        want = {n: c for n, c in want_counts(model.cfg, 1, n_attn).items()
                if c}
        if not (res["loss_rel"] <= TOL_STEP_LOSS_REL
                and cos[worst] >= MIN_GRAD_COSINE
                and flips <= max_flips * choices
                and kn == want and not pn):
            raise AssertionError(f"{tag}: kernel and plain paths disagree: "
                                 f"{res}, plain launched {pn}")
        del out, kg, pg
        release()
        return res

    def train(tag, model, task, steps, n_attn, S, B):
        """``steps`` sparse steps through the Trainer, counted exactly."""
        cfg = model.cfg
        left = release()
        # max_bad_steps=0: no re-init rung, so run() takes no host copy of
        # the parameters (15 GB in (a); phase 6 times that copy)
        tr = Trainer(model, TrainerConfig(steps=steps, lr=1e-3, warmup=2,
                                          max_bad_steps=0),
                     task=task)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        status = tr.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        for k, c in counts.items():
            launches[k] += c
        peak = torch.cuda.max_memory_allocated()
        hist = tr.history
        losses = [h["loss"] for h in hist]
        step_ms = [h["seconds"] * 1e3 for h in hist]
        steady = float(np.median(step_ms[1:]))
        n_params = sum(p.numel() for p in model.parameters())
        out = {"config": cfg.name, "remat": cfg.remat, "S": S, "batch": B,
               "layers": cfg.n_layers, "params": n_params, "steps": steps,
               "losses": losses, "xent": [h["xent"] for h in hist],
               "aux": [h["aux"] for h in hist], "step_ms": step_ms,
               "step_ms_median": steady, "run_s": run_s,
               "outside_steps_s": run_s - sum(h["seconds"] for h in hist),
               "peak_bytes": peak, "allocated_before_bytes": left,
               "launches": counts, "tokens_per_s": B * S * 1e3 / steady,
               "launches_a_step": {k: c / steps for k, c in counts.items()
                                   if c}}
        log(f"[moe] {tag}: {cfg.name}, {cfg.n_layers} layers, "
            f"{n_params:,} params, S={S} batch {B}, remat={cfg.remat!r}; "
            f"losses {', '.join(f'{x:.4f}' for x in losses)} (aux "
            f"{', '.join(f'{x:.4f}' for x in out['aux'])}); step ms "
            f"{', '.join(f'{x:.2f}' for x in step_ms)} (median after the "
            f"first {steady:.2f}, {out['tokens_per_s']:.1f} tokens a "
            f"second); peak {peak / 2**30:.2f} GiB ({left / 2**30:.2f} GiB "
            f"allocated before); run {run_s:.2f} s, "
            f"{out['outside_steps_s']:.2f} s outside the steps; launches a "
            f"step {out['launches_a_step']}")
        want = want_counts(cfg, steps, n_attn)
        if status != "done" or counts != want or \
                not losses[-1] < losses[0] or \
                not np.isfinite(losses).all() or \
                any(h["skipped"] for h in hist):
            raise AssertionError(
                f"{tag}: status {status}, losses {losses}, launches "
                f"{ {k: c for k, c in counts.items() if c} }, want "
                f"{ {k: c for k, c in want.items() if c} }")
        return tr, out

    # ------------------------------------ (a) Qwen3-235B-A22B, one layer
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS,
                                       attn_backend="cluster_sparse",
                                       remat="block")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with L.draw_on_device():    # 3.7e9 numbers: no host time
        model = LMModel(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    a = {"init_s": time.perf_counter() - t0}
    n_params = sum(p.numel() for p in model.parameters())
    n_experts = sum(p.numel() for n, p in model.named_parameters()
                    if ".moe.w_" in n)
    a.update(params=n_params, expert_params=n_experts,
             state_bytes=16 * n_params)
    log(f"[moe] (a) {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"over {cfg.kv_heads} of {cfg.head_dim}, {cfg.moe_experts} experts "
        f"top-{cfg.moe_top_k} of width {cfg.moe_d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.n_layers} layer (of 94); {n_params:,} "
        f"params ({n_experts:,} in the experts), parameters, gradients "
        f"and two moments {16 * n_params / 2**30:.2f} GiB; seeded init "
        f"(drawn on the card) {a['init_s']:.1f} s")

    # the MoE op at full width on the card and on the CPU, fp32, TF32 off
    moe = model.layers[0].moe
    f32 = cfg.replace(dtype="float32")
    x = torch.from_numpy(rng.standard_normal(
        (MOE_OP_TOKENS, cfg.d_model)).astype(np.float32))
    cpu_moe = tmoe.MoE(cfg, device="cpu")
    cpu_moe.load_state_dict(moe.state_dict())
    with torch.no_grad():
        y_gpu, aux_gpu = tmoe.moe_tokens(moe, f32, x.to(dev))
        ti_gpu = tmoe._route(moe.router, x.to(dev), cfg.moe_top_k)[1]
        t0 = time.perf_counter()
        y_cpu, aux_cpu = tmoe.moe_tokens(cpu_moe, f32, x)
        cpu_s = time.perf_counter() - t0
        ti_cpu = tmoe._route(cpu_moe.router, x, cfg.moe_top_k)[1]
    y_gpu, ti_gpu = y_gpu.cpu(), ti_gpu.cpu()
    same = (ti_gpu.sort(-1).values == ti_cpu.sort(-1).values).all(-1)
    diff = (y_gpu - y_cpu).abs()[same]
    op = {"tokens": MOE_OP_TOKENS, "cpu_s": cpu_s,
          "max_abs_err": float(diff.max()),
          "max_abs_out": float(y_cpu.abs().max()),
          "rel_err": float(diff.max() / y_cpu.abs().max()),
          "tokens_routed_apart": int((~same).sum()),
          "aux_err": abs(float(aux_gpu) - float(aux_cpu))}
    del cpu_moe, moe, y_gpu, y_cpu, x
    log(f"[moe] (a) the MoE op on the card vs the CPU, {MOE_OP_TOKENS} "
        f"tokens, fp32: max |diff| {op['max_abs_err']:.3g} of max |y| "
        f"{op['max_abs_out']:.3g} (rel {op['rel_err']:.3g}, tol "
        f"{TOL_MOE_OP}); tokens routed apart {op['tokens_routed_apart']} "
        f"(max {MOE_OP_MAX_FLIPS:.1%}); aux diff {op['aux_err']:.3g}; CPU "
        f"{cpu_s:.2f} s")
    if op["rel_err"] > TOL_MOE_OP or op["aux_err"] > TOL_MOE_OP or \
            op["tokens_routed_apart"] > MOE_OP_MAX_FLIPS * MOE_OP_TOKENS:
        raise AssertionError(f"(a) the MoE op disagrees with the CPU: {op}")
    a["op_check"] = op

    cuts = []
    for S in MOE_SEQS:
        dc = LMDataConfig(cfg.vocab_size, S, 1, seed=0)
        task = BatchFnTask(lambda s, dc=dc: lm_batch(dc, s)).prepare(model)
        try:
            a["op_check"] = op_check(f"(a) S={S}", model, lm_loss,
                                     task.batches(0), UNBIASED_NAMES,
                                     read_counts, log_tag="moe")
            a["step0"] = step_vs_plain(f"(a) S={S}", model, lm_loss,
                                       task.batches(0), MOE_LAYERS,
                                       MAX_ROUTE_FLIPS["(a)"])
            tr, a["train"] = train(f"(a) S={S}", model, task, MOE_STEPS,
                                   MOE_LAYERS, S, 1)
            break
        except torch.cuda.OutOfMemoryError as err:
            cuts.append({"S": S, "peak_bytes":
                         torch.cuda.max_memory_allocated(),
                         "error": str(err).splitlines()[0][:300]})
            log(f"[moe] (a) S={S} does not fit: {cuts[-1]}")
            tr = None
            release()
            model.reset_parameters(0)
    else:
        raise AssertionError(f"(a) fits at none of {MOE_SEQS}")
    a["cuts"] = cuts

    def step_shares(tr, moe, S):
        """Where a step's time goes: a step profiled by kind of kernel
        (rows 2, 5 and 6 are the attention kernels), AdamW's update and
        the MoE op's forward and backward (the expert loop alone beside
        it) timed with CUDA events on the step's shapes; under
        remat="block" a step runs the MoE forward twice and its backward
        once."""
        batch = tr.task.batches(0)
        timed_update = []
        real_update = tr.opt.update

        def update(grads, **kw):
            s, e = event_pair()
            s.record()
            real_update(grads, **kw)
            e.record()
            timed_update.append((s, e))
        tr.opt.update = update
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.step("sparse", batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        del tr.opt.update
        adamw_ms = timed_update[0][0].elapsed_time(timed_update[0][1])
        prof = device_breakdown(lambda: tr.step("sparse", batch), wall,
                                tag="moe", what="(a) one step",
                                focus="cluster")
        m_in = torch.randn((S, cfg.d_model), device=dev,
                           dtype=torch.bfloat16, requires_grad=True)
        g_out = torch.randn((S, cfg.d_model), device=dev,
                            dtype=torch.bfloat16)
        topi = tmoe._route(moe.router, m_in.detach(), cfg.moe_top_k)[1]
        order = torch.sort(topi.reshape(-1), stable=True).indices
        sizes = torch.bincount(topi.reshape(-1),
                               minlength=cfg.moe_experts).tolist()
        xg = m_in.detach()[order // cfg.moe_top_k].requires_grad_()
        g_xg = torch.randn_like(xg)
        stacks = [moe.w_gate, moe.w_up, moe.w_down]

        def moe_fwd():
            return tmoe.moe_tokens(moe, cfg, m_in)[0]

        def experts_fwd():
            return tmoe._expert_ffn(xg, sizes, *stacks)
        with torch.no_grad():
            moe_f = cuda_ms(moe_fwd, 3)
            exp_f = cuda_ms(experts_fwd, 3)
        moe_fb = cuda_ms(lambda: torch.autograd.grad(
            moe_fwd(), [m_in, *moe.parameters()], g_out), 3)
        exp_fb = cuda_ms(lambda: torch.autograd.grad(
            experts_fwd(), [xg, *stacks], g_xg), 3)
        shares = {"adamw_ms": adamw_ms, "moe_fwd_ms": moe_f,
                  "moe_fwd_bwd_ms": moe_fb, "experts_fwd_ms": exp_f,
                  "experts_fwd_bwd_ms": exp_fb, "step_wall_ms": wall,
                  "moe_share": (moe_f + moe_fb) / wall,
                  "experts_share": (exp_f + exp_fb) / wall,
                  "adamw_share": adamw_ms / wall,
                  "live_experts": sum(1 for n in sizes if n)}
        log(f"[moe] (a) a step of {wall:.2f} ms: AdamW {adamw_ms:.2f} ms "
            f"({shares['adamw_share']:.1%}); the MoE op at the step's shape "
            f"forward {moe_f:.2f} ms, forward+backward {moe_fb:.2f} ms "
            f"(twice forward and once backward a step: "
            f"{shares['moe_share']:.1%}); of it the expert loop over "
            f"{shares['live_experts']} experts {exp_f:.2f} / {exp_fb:.2f} "
            f"ms ({shares['experts_share']:.1%})")
        return prof, shares

    a["profile"], a["shares"] = step_shares(tr, model.layers[0].moe, S)
    rec["a"] = a

    # ------------------------------ (b) the same weights, served as published
    del tr, task
    release()
    model.cfg = cfg.replace(attn_backend=get_config(MOE_ARCH).attn_backend)
    V = cfg.vocab_size
    eng, ev = serve_engine(model, MOE_SERVE_MAX_LEN, sparse=False)
    prompts = [rng.integers(1, V, int(m)).tolist() for m in
               rng.integers(MOE_SERVE_PROMPT[0], MOE_SERVE_PROMPT[1] + 1,
                            MOE_SERVE_REQUESTS)]
    b = serve_engine_run("(b) moe", eng, ev, prompts, MOE_SERVE_NEW,
                         reset_counts, read_counts, log_tag="moe")
    # two requests against the contiguous oracle: lm_prefill over the
    # prompt, then lm_decode_step over the engine's own tokens
    longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    checks = []
    for rid in (longest, 0 if longest else 1):
        prompt, out = prompts[rid], eng.done[rid]
        rows = []
        with torch.inference_mode():
            logits, cache = lm_prefill(
                model, {"tokens": torch.tensor([prompt], device=dev)},
                cache_len=len(prompt) + MOE_SERVE_NEW)
            rows.append(logits[0, 0, :V].float())
            for i, tok in enumerate(out[:-1]):
                logits, cache = lm_decode_step(
                    model, cache, torch.tensor([[tok]], device=dev),
                    len(prompt) + i)
                rows.append(logits[0, 0, :V].float())
        res = margin_check(f"(b) request {rid}", torch.stack(rows), out)
        res.update(rid=rid, prompt_len=len(prompt))
        checks.append(res)
        del cache
    b["oracle_checks"] = checks
    log(f"[moe] (b) teacher-forced against lm_prefill + lm_decode_step: "
        f"{json.dumps(checks)}")
    rec["b"] = b
    del eng, ev, model
    release()

    # --------------------------------- (c) Jamba-v0.1, a quarter of its width
    jcfg = get_config(JAMBA_ARCH).replace(attn_backend="cluster_sparse",
                                          **JAMBA_CUT)
    t0 = time.perf_counter()
    model = HybridLMModel(jcfg, device=dev, seed=0)
    torch.cuda.synchronize()
    c = {"init_s": time.perf_counter() - t0, "cut": JAMBA_CUT}
    n_attn = jcfg.n_layers // jcfg.attn_every
    dc = LMDataConfig(jcfg.vocab_size, JAMBA_SEQ, JAMBA_BATCH, seed=0)
    task = BatchFnTask(lambda s: lm_batch(dc, s)).prepare(model)
    c["op_check"] = op_check("(c) jamba", model, hybrid_loss,
                             task.batches(0), UNBIASED_NAMES, read_counts,
                             log_tag="moe")
    c["step0"] = step_vs_plain("(c) jamba", model, hybrid_loss,
                               task.batches(0), n_attn,
                               MAX_ROUTE_FLIPS["(c)"])
    tr, c["train"] = train("(c) jamba", model, task, JAMBA_STEPS, n_attn,
                           JAMBA_SEQ, JAMBA_BATCH)
    del tr, task
    release()

    # prefill (the attention slot through row 2, without grad) against
    # as many decode steps over the same tokens; fp32 held to the reference's
    # tolerance, bf16 reported
    Vj = jcfg.vocab_size
    tok = torch.from_numpy(rng.integers(1, Vj, (1, JAMBA_PREFILL_SEQ))).to(
        dev)
    for dtype in ("bfloat16", "float32"):
        model.cfg = jcfg.replace(dtype=dtype)
        before = read_counts()
        with torch.inference_mode():
            s, e = event_pair()
            s.record()
            full, _ = model.prefill({"tokens": tok})
            e.record()
            e.synchronize()
            prefill_ms = s.elapsed_time(e)
            after = read_counts()
            cache = model.cache_defs(1, JAMBA_PREFILL_SEQ)
            s2, e2 = event_pair()
            s2.record()
            for i in range(JAMBA_PREFILL_SEQ):
                out, cache = model.decode(cache, tok[:, i:i + 1], i)
            e2.record()
            e2.synchronize()
        pa = full[0, 0, :Vj].float().cpu().numpy()
        pb = out[0, 0, :Vj].float().cpu().numpy()
        outside = np.abs(pa - pb) > TOL_SSM_ATOL + TOL_SSM_RTOL * np.abs(pb)
        c[dtype] = {"prefill_ms": prefill_ms,
                    "decode_step_ms": s2.elapsed_time(e2) / JAMBA_PREFILL_SEQ,
                    "max_abs_err": float(np.abs(pa - pb).max()),
                    "max_abs_logit": float(np.abs(pa).max()),
                    "share_outside_tolerance": float(outside.mean()),
                    "argmax_equal": bool(pa.argmax() == pb.argmax()),
                    "launched": {k: v - before[k] for k, v in after.items()
                                 if v != before[k]}}
        for k, n in c[dtype]["launched"].items():
            launches[k] += n
        log(f"[moe] (c) jamba {dtype}: prefill S={JAMBA_PREFILL_SEQ} "
            f"{prefill_ms:.3f} ms (launched {c[dtype]['launched']}); "
            f"against {JAMBA_PREFILL_SEQ} decode steps "
            f"({c[dtype]['decode_step_ms']:.3f} ms a step, eager): max "
            f"|diff| {c[dtype]['max_abs_err']:.4g} of max |logit| "
            f"{c[dtype]['max_abs_logit']:.3f}, "
            f"{100 * c[dtype]['share_outside_tolerance']:.2f}% of logits "
            f"outside atol {TOL_SSM_ATOL} / rtol {TOL_SSM_RTOL}, argmax "
            f"equal {c[dtype]['argmax_equal']}")
        del cache, full, out
    np.testing.assert_allclose(pa, pb, atol=TOL_SSM_ATOL, rtol=TOL_SSM_RTOL)
    if not c["float32"]["argmax_equal"]:
        raise AssertionError(f"(c) jamba fp32 prefill/decode: {c}")
    rec["c"] = c
    del model
    release()
    rec["launches"] = launches
    return rec


def moe_phase(out_path: str) -> int:
    """Phase 13, in a child process: the MoE family and the hybrid
    (``moe_runs``), on an empty card (Qwen3-235B-A22B's one layer holds
    ~60 GB of training state). Not under deterministic algorithms (the
    serving pool's scatter). The record goes to ``out_path`` as JSON."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke phase 13: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import cluster_attention as tca
    from repro_torch.kernels import cluster_attention_bwd as tcab

    await_turn(torch)
    t_start = time.perf_counter()
    kbuild.build_all((tca.LIBRARY_UNBIASED_SM90, tcab.LIBRARY_UNBIASED_SM90,
                      tca.LIBRARY_UNBIASED))
    reset_counts, read_counts = kernel_counters()
    rec = moe_runs(torch.device("cuda"), reset_counts, read_counts)
    rec["seconds"] = time.perf_counter() - t_start
    with open(out_path, "w") as fh:
        json.dump(rec, fh)
    log(f"[moe] {rec['seconds']:.1f}s, launches "
        f"{ {k: c for k, c in rec['launches'].items() if c} }")
    return 0


# phase 14: the enc-dec and VLM families and AdamW's reduced-precision
# moments, in a child process. (a) SeamlessM4T-medium as published (12 +
# 12 layers, 978,384,896 parameters) on the cluster-sparse backend
A10_ENCDEC_ARCH = "seamless_m4t_medium"
A10_ENCDEC_PARAMS = 978_384_896        # the reference's n_params()
A10_ENCDEC_BATCH = 8                   # utterances a step
A10_ENCDEC_TARGET = 512                # target tokens an utterance
# (a): 2 steps and 64 decode steps (cut from 4 and 128): room
# for phase 15's (j)-(o), whose (l) trains the enc-dec on a mesh
A10_ENCDEC_STEPS = 2
A10_DECODE_STEPS = 64
# (b) InternVL2-76B at full width, its depth cut from 80 layers to 1
A10_VLM_ARCH = "internvl2_76b"
A10_VLM_LAYERS = 1
A10_VLM_PARAMS = 3_028_312_064         # the reference's n_params(), 1 layer
A10_VLM_SEQ = 4096                     # 256 patches + 3840 tokens
A10_VLM_STEPS = {"float32": 3, "bfloat16": 3, "int8": 3}
# (b)'s peak learning rate: a large model's (at 1e-3 the loss rose at
# step 3 on the card)
A10_VLM_LR = 3e-4
# step 0, kernel path against plain: every gradient's norm within this
# share of the plain one's (a cosine cannot see a wrong scale)
MAX_GRAD_NORM_REL = 1e-2
# a gradient whose bf16 plain version is itself further from the fp32
# plain gradient than MIN_GRAD_COSINE and MAX_GRAD_NORM_REL allow (an
# ill-conditioned leaf under bf16 roundings): the kernel path's distance
# from the fp32 gradient at most this many times the bf16 plain path's
FP32_DISTANCE_FACTOR = 2.0
# the reference's prefill-against-decode tolerance (test_serve_consistency)
TOL_DECODE_ATOL, TOL_DECODE_RTOL = 0.15, 0.05
# the moments after step 1 against the port's AdamW on the CPU from the
# same gradients, on the first A10_CPU_CHECK_ELEMENTS of every leaf
# (whole 256-blocks, so the same blocks as on the card): parameters
# within 1e-6 relative (1e-7 absolute), bf16 moments equal, int8 q
# within one step and equal but for this share, s within 1e-6 relative
A10_INT8_OFF_SHARE = 0.01
A10_CPU_CHECK_ELEMENTS = 1 << 20       # a leaf's first elements (4096 blocks)


def a10_encdec_config():
    """Phase 14 (a)'s config: SeamlessM4T-medium as published, on the
    cluster-sparse backend, each layer recomputed."""
    from repro_torch.configs import get_config

    return get_config(A10_ENCDEC_ARCH).replace(attn_backend="cluster_sparse",
                                               remat="block")


def a10_runs(dev, reset_counts, read_counts, host_model,
             host_init_s) -> dict:
    """Phase 14's runs on ``dev``: (a) SeamlessM4T-medium at full width
    and depth trained through the Trainer on the cluster-sparse backend
    (its encoder's non-causal and its decoder's causal attention op held
    to their plain versions on layer 0's own q, k, v; step 0 held to
    ``impl="plain"``; a step profiled), then decoded 128 steps over the
    encoder's cross caches and held to the full forward; (b)
    InternVL2-76B at full width with one layer, its attention op and step
    0 held the same way, trained from one init under each of AdamW's
    three moment dtypes, the reduced-precision moments after step 1 held
    to the port's AdamW on the CPU. Every training run's launches of rows
    2, 5 and 6 counted exactly; returns the phase's record and those
    counts (``launches``, and the fp32 decode check's under
    ``launches_float32``). ``host_model`` is (a)'s model already drawn on
    the CPU (``a10_phase`` draws it ahead of its turn, in
    ``host_init_s``): it is moved to ``dev``, the same weights as a model
    made there (the seeded init draws on the CPU either way)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch
    from repro_torch.models import encdec as ted
    from repro_torch.models import layers as L
    from repro_torch.models.lm import LMModel, lm_loss
    from repro_torch.optim import adamw as tadamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tasks import BatchFnTask

    rec = {}
    zero = {name: 0 for name in read_counts()}
    launches = dict(zero)
    launches_f32 = dict(zero)
    t_phase = time.perf_counter()

    def want_counts(cfg, steps, n_attn):
        return {**zero, **step_launches(cfg, UNBIASED_NAMES, steps, n_attn)}

    def step_vs_plain(tag, model, loss_fn, batch, n_attn):
        """Step 0's loss and gradients, kernel path against
        ``impl="plain"`` on the same parameters and batch, outside the
        main path's counts, with the plain path in fp32 as referee: the
        loss within TOL_STEP_LOSS_REL; every parameter's gradient at a
        cosine of at least MIN_GRAD_COSINE with the plain one and its
        norm within MAX_GRAD_NORM_REL of the plain one's, or, where the
        bf16 plain gradient itself is that far from the fp32 one, the
        kernel's no further from the fp32 gradient than
        FP32_DISTANCE_FACTOR times the plain one's (in 1 - cosine and in
        the norm ratio's distance from 1)."""
        cfg = model.cfg
        named = list(model.named_parameters())
        params = [p for _, p in named]
        out = {}
        for key, impl, dtype in (("kernel", None, cfg.dtype),
                                 ("plain", "plain", cfg.dtype),
                                 ("fp32", "plain", "float32")):
            model.cfg = cfg.replace(dtype=dtype)
            before = read_counts()
            try:
                loss, _ = loss_fn(model, batch, impl=impl)
                grads = torch.autograd.grad(loss, params)
            finally:
                model.cfg = cfg
            torch.cuda.synchronize()
            out[key] = (loss.detach().float(), grads,
                        {n: c - before[n] for n, c in read_counts().items()
                         if c != before[n]})
            del loss, grads

        def compare(xs, ys):
            cos, ratio = [], []
            for a, c in zip(xs, ys):
                a, c = a.flatten().float(), c.flatten().float()
                cos.append(F.cosine_similarity(a, c, dim=0,
                                               eps=1e-30).item())
                ratio.append((a.norm() / c.norm().clamp_min(1e-30)).item())
            return cos, ratio
        (kl, kg, kn), (pl_, pg, pn), (fl, fg, fn) = (
            out["kernel"], out["plain"], out["fp32"])
        kp, kf, pf = compare(kg, pg), compare(kg, fg), compare(pg, fg)
        names = [n for n, _ in named]
        rows, refereed, failed = {}, [], []
        for i, n in enumerate(names):
            direct = kp[0][i] >= MIN_GRAD_COSINE and \
                abs(kp[1][i] - 1) <= MAX_GRAD_NORM_REL
            ref = (1 - kf[0][i]) <= FP32_DISTANCE_FACTOR * (1 - pf[0][i]) \
                and abs(kf[1][i] - 1) <= max(
                    FP32_DISTANCE_FACTOR * abs(pf[1][i] - 1),
                    MAX_GRAD_NORM_REL)
            rows[n] = {"cos_kernel_plain": kp[0][i],
                       "norm_ratio_kernel_plain": kp[1][i],
                       "cos_kernel_fp32": kf[0][i],
                       "norm_ratio_kernel_fp32": kf[1][i],
                       "cos_plain_fp32": pf[0][i],
                       "norm_ratio_plain_fp32": pf[1][i]}
            if not direct:
                (refereed if ref else failed).append(n)
        worst = min(names, key=lambda n: rows[n]["cos_kernel_plain"])
        off = max(names, key=lambda n: abs(
            rows[n]["norm_ratio_kernel_plain"] - 1))
        res = {"loss": kl.item(), "plain_loss": pl_.item(),
               "fp32_loss": fl.item(),
               "loss_rel": (abs(kl - pl_) / abs(pl_)).item(),
               "min_grad_cosine": [worst, rows[worst]["cos_kernel_plain"]],
               "worst_grad_norm_ratio": [
                   off, rows[off]["norm_ratio_kernel_plain"]],
               "refereed_by_fp32": {n: rows[n] for n in refereed},
               "failed": {n: rows[n] for n in failed},
               "min_cos_plain_fp32": min(r["cos_plain_fp32"]
                                         for r in rows.values()),
               "min_cos_kernel_fp32": min(r["cos_kernel_fp32"]
                                          for r in rows.values()),
               "launched": kn}
        log(f"[a10] {tag}: step 0, kernel vs plain path: loss "
            f"{res['loss']:.6f} vs {res['plain_loss']:.6f} (rel "
            f"{res['loss_rel']:.3g}, tol {TOL_STEP_LOSS_REL}; fp32 "
            f"{res['fp32_loss']:.6f}); gradient cosine min "
            f"{rows[worst]['cos_kernel_plain']:.6f} ({worst}; min "
            f"{MIN_GRAD_COSINE}); norm ratio furthest from 1 "
            f"{rows[off]['norm_ratio_kernel_plain']:.6f} ({off}; tol "
            f"{MAX_GRAD_NORM_REL}); against fp32 plain: min cosine kernel "
            f"{res['min_cos_kernel_fp32']:.6f}, bf16 plain "
            f"{res['min_cos_plain_fp32']:.6f}; {len(refereed)} of "
            f"{len(names)} gradients held by the fp32 referee "
            f"{json.dumps({n: rows[n] for n in refereed})}; kernels "
            f"launched {kn}")
        want = {n: c for n, c in want_counts(cfg, 1, n_attn).items() if c}
        if not (res["loss_rel"] <= TOL_STEP_LOSS_REL and not failed
                and kn == want and not pn and not fn):
            raise AssertionError(f"{tag}: kernel and plain paths disagree: "
                                 f"{res}, plain launched {pn}, fp32 {fn}")
        del out, kg, pg, fg
        release()
        return res

    def train(tag, model, task, steps, n_attn, tokens, state_dtype,
              on_update=None, lr=1e-3):
        """``steps`` sparse steps through the Trainer, counted exactly,
        AdamW's update timed by CUDA events; ``on_update(tr, grads,
        update)`` may wrap the (timed) update."""
        cfg = model.cfg
        left = release()
        log(f"[a10] {tag} starts at {time.perf_counter() - t_phase:.1f} s")
        # max_bad_steps=0: no re-init rung, so run() takes no host copy of
        # the parameters (12 GB in (b), seconds; phase 5 times it)
        tr = Trainer(model, TrainerConfig(steps=steps, lr=lr, warmup=2,
                                          state_dtype=state_dtype,
                                          max_bad_steps=0),
                     task=task)
        timed = []
        real_update = tr.opt.update

        def update(grads, **kw):
            def timed_update():
                s, e = event_pair()
                s.record()
                real_update(grads, **kw)
                e.record()
                timed.append((s, e))
            if on_update is None:
                timed_update()
            else:
                on_update(tr, grads, timed_update)
        tr.opt.update = update
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        status = tr.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        for k, c in counts.items():
            launches[k] += c
        del tr.opt.update
        peak = torch.cuda.max_memory_allocated()
        hist = tr.history
        losses = [h["loss"] for h in hist]
        step_ms = [h["seconds"] * 1e3 for h in hist]
        steady = float(np.median(step_ms[1:]))
        update_ms = [s.elapsed_time(e) for s, e in timed]
        n_params = sum(p.numel() for p in model.parameters())
        state_bytes = sum(t.numel() * t.element_size()
                          for t in tr.opt.state_tensors())
        out = {"config": cfg.name, "remat": cfg.remat, "layers": cfg.n_layers,
               "params": n_params, "state_dtype": state_dtype,
               "moment_bytes": state_bytes, "steps": steps,
               "losses": losses, "step_ms": step_ms,
               "step_ms_median": steady, "run_s": run_s,
               "adamw_update_ms": update_ms,
               "peak_bytes": peak, "allocated_before_bytes": left,
               "launches": counts,
               "tokens_per_s": {k: n * 1e3 / steady
                                for k, n in tokens.items()},
               "launches_a_step": {k: c / steps for k, c in counts.items()
                                   if c}}
        log(f"[a10] {tag}: {cfg.name}, {cfg.n_layers} layers, "
            f"{n_params:,} params, moments {state_dtype} "
            f"({state_bytes / 2**30:.2f} GiB), remat={cfg.remat!r}; losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}; step ms "
            f"{', '.join(f'{x:.2f}' for x in step_ms)} (median after the "
            f"first {steady:.2f}; "
            + ", ".join(f"{v:.1f} {k} a second"
                        for k, v in out["tokens_per_s"].items())
            + f"); AdamW update ms "
            f"{', '.join(f'{x:.2f}' for x in update_ms)}; peak "
            f"{peak / 2**30:.2f} GiB ({left / 2**30:.2f} GiB allocated "
            f"before); run {run_s:.2f} s; launches a step "
            f"{out['launches_a_step']}")
        want = want_counts(cfg, steps, n_attn)
        if status != "done" or counts != want or \
                not losses[-1] < losses[0] or \
                not np.isfinite(losses).all() or \
                any(h["skipped"] for h in hist):
            raise AssertionError(
                f"{tag}: status {status}, losses {losses}, launches "
                f"{ {k: c for k, c in counts.items() if c} }, want "
                f"{ {k: c for k, c in want.items() if c} }")
        return tr, out

    # ------------------------------ (a) SeamlessM4T-medium, full depth
    cfg = a10_encdec_config()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = host_model.to(dev)
    del host_model
    torch.cuda.synchronize()
    a = {"init_s": time.perf_counter() - t0, "host_init_s": host_init_s}
    n_params = sum(p.numel() for p in model.parameters())
    a["params"] = n_params
    log(f"[a10] (a) {cfg.name}: {cfg.enc_layers} + {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {n_params:,} params "
        f"(reference {A10_ENCDEC_PARAMS:,}); seeded init (drawn on the "
        f"CPU) {a['init_s']:.1f} s to the card, drawn ahead of the phase's "
        f"turn in {host_init_s:.1f} s")
    if n_params != A10_ENCDEC_PARAMS:
        raise AssertionError(f"(a) {n_params} parameters, the reference "
                             f"has {A10_ENCDEC_PARAMS}")
    B, S, Tf = A10_ENCDEC_BATCH, A10_ENCDEC_TARGET, cfg.frontend_tokens
    dc = LMDataConfig(cfg.vocab_size, S, B, seed=0)

    def encdec_batch(step):
        frames = np.random.default_rng(1000 + step).standard_normal(
            (B, Tf, cfg.d_model), dtype=np.float32)
        return {**lm_batch(dc, step), "frames": frames}
    task = BatchFnTask(encdec_batch).prepare(model)
    batch = task.batches(0)
    a["op_check"] = {
        "encoder": op_check("(a) encoder layer 0", model, ted.encdec_loss,
                            batch, UNBIASED_NAMES, read_counts,
                            log_tag="a10"),
        "decoder": op_check("(a) decoder layer 0", model, ted.encdec_loss,
                            batch, UNBIASED_NAMES, read_counts,
                            log_tag="a10", nth=cfg.enc_layers)}
    for part, causal, S_ in (("encoder", False, Tf), ("decoder", True, S)):
        shape = a["op_check"][part]["shape"]
        if shape["causal"] != causal or shape["S"] != S_:
            raise AssertionError(f"(a) {part}'s op check took {shape}")
    n_attn = cfg.enc_layers + cfg.n_layers
    a["step0"] = step_vs_plain("(a)", model, ted.encdec_loss, batch, n_attn)
    del batch
    tr, a["train"] = train("(a)", model, task, A10_ENCDEC_STEPS, n_attn,
                           {"frames": B * Tf, "target tokens": B * S},
                           "float32")
    batch = task.batches(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.step("sparse", batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    a["profile"] = device_breakdown(lambda: tr.step("sparse", batch), wall,
                                    tag="a10", what="(a) one step",
                                    focus="cluster")
    del tr
    release()

    # decode: encode once, fill the cross caches, 128 steps over the
    # batch's first tokens; the last logits against the full forward's
    log(f"[a10] (a) decode starts at {time.perf_counter() - t_phase:.1f} s")
    T = A10_DECODE_STEPS
    tok = batch["tokens"][:, :T]
    V = cfg.vocab_size
    dec = {}
    for dtype in ("bfloat16", "float32"):
        model.cfg = cfg.replace(dtype=dtype)
        cdt = getattr(torch, dtype)
        before = read_counts()
        with torch.inference_mode():
            cache = {"dec": {k: v.to(cdt) for k, v in
                             model.cache_defs(B, T)["dec"].items()}}
            s0, e0 = event_pair()
            s0.record()
            enc = ted.encode(model, batch["frames"])
            for i, layer in enumerate(model.dec_layers):
                cache["dec"]["ck"][i], cache["dec"]["cv"][i] = ted.cross_kv(
                    layer.cross, enc)
            e0.record()
            s1, e1 = event_pair()
            s1.record()
            for i in range(T):
                out, cache = model.decode(cache, tok[:, i:i + 1], i)
            e1.record()
            full = L.logits_fn(model.embed, model.cfg, ted.encdec_forward(
                model, {"frames": batch["frames"], "tokens": tok})[:, -1:])
            torch.cuda.synchronize()
        after = read_counts()
        pa = full[:, 0, :V].float().cpu().numpy()
        pb = out[:, 0, :V].float().cpu().numpy()
        outside = np.abs(pa - pb) > TOL_DECODE_ATOL + TOL_DECODE_RTOL * \
            np.abs(pb)
        dec[dtype] = {
            "caches": dtype, "encode_and_fill_ms": s0.elapsed_time(e0),
            "decode_step_ms": s1.elapsed_time(e1) / T,
            "max_abs_err": float(np.abs(pa - pb).max()),
            "max_abs_logit": float(np.abs(pa).max()),
            "share_outside_tolerance": float(outside.mean()),
            "argmax_equal": float((pa.argmax(-1) == pb.argmax(-1)).mean()),
            "launched": {k: v - before[k] for k, v in after.items()
                         if v != before[k]}}
        for k, n in dec[dtype]["launched"].items():
            (launches_f32 if dtype == "float32" else launches)[k] += n
        log(f"[a10] (a) decode {dtype} (caches {dtype}): encode + cross "
            f"caches {dec[dtype]['encode_and_fill_ms']:.3f} ms, {T} decode "
            f"steps of batch {B} at {dec[dtype]['decode_step_ms']:.3f} ms a "
            f"step (eager); last logits against encdec_forward: max |diff| "
            f"{dec[dtype]['max_abs_err']:.4g} of max |logit| "
            f"{dec[dtype]['max_abs_logit']:.3f}, "
            f"{100 * dec[dtype]['share_outside_tolerance']:.3f}% outside atol "
            f"{TOL_DECODE_ATOL} / rtol {TOL_DECODE_RTOL}, argmax equal in "
            f"{dec[dtype]['argmax_equal']:.0%} of rows; launched "
            f"{dec[dtype]['launched']}")
        del cache, enc, full, out
    model.cfg = cfg
    a["decode"] = dec
    if dec["float32"]["share_outside_tolerance"] or \
            dec["float32"]["argmax_equal"] < 1:
        raise AssertionError(f"(a) fp32 decode disagrees with the forward: "
                             f"{dec['float32']}")
    rec["a"] = a
    del model, task, batch, tok
    release()

    # ----------------------- (b) InternVL2-76B, one layer, three moments
    log(f"[a10] (b) starts at {time.perf_counter() - t_phase:.1f} s")
    cfg = get_config(A10_VLM_ARCH).replace(n_layers=A10_VLM_LAYERS,
                                           attn_backend="cluster_sparse",
                                           remat="block")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with L.draw_on_device():    # 3.03e9 numbers: no host time
        model = LMModel(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    b = {"init_s": time.perf_counter() - t0}
    n_params = sum(p.numel() for p in model.parameters())
    b["params"] = n_params
    log(f"[a10] (b) {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"over {cfg.kv_heads} of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.frontend_tokens} patches, "
        f"{cfg.n_layers} layer (of 80); {n_params:,} params (reference "
        f"{A10_VLM_PARAMS:,}); seeded init (drawn on the card) "
        f"{b['init_s']:.1f} s")
    if n_params != A10_VLM_PARAMS:
        raise AssertionError(f"(b) {n_params} parameters, the reference "
                             f"has {A10_VLM_PARAMS}")
    Tp = cfg.frontend_tokens
    vdc = LMDataConfig(cfg.vocab_size, A10_VLM_SEQ - Tp, 1, seed=0)

    def vlm_batch(step):
        patches = np.random.default_rng(2000 + step).standard_normal(
            (1, Tp, cfg.d_model), dtype=np.float32)
        return {**lm_batch(vdc, step), "patches": patches}
    task = BatchFnTask(vlm_batch).prepare(model)
    batch = task.batches(0)
    b["op_check"] = op_check("(b) layer 0", model, lm_loss, batch,
                             UNBIASED_NAMES, read_counts, log_tag="a10")
    b["step0"] = step_vs_plain("(b)", model, lm_loss, batch, cfg.n_layers)
    del batch
    # the init for each moment dtype's run, kept on the card (a host copy
    # would cost seconds each way); each run's peak includes it
    init = [p.detach().clone() for p in model.parameters()]
    b["init_copy_bytes"] = sum(p.numel() * p.element_size() for p in init)

    def moments_vs_cpu(tr, grads, update):
        """Step 1's update, then its parameters and moments on the first
        A10_CPU_CHECK_ELEMENTS of every reference leaf against the port's
        AdamW on the CPU from the same parameters and gradients."""
        sd = tr.opt.state_dtype
        if tr.opt.step or sd == "float32":
            return update()
        n_of = {}
        heads = []
        for k, g in enumerate(tr.opt.groups):
            n = min(sum(tr.params[i].numel() for i in g),
                    A10_CPU_CHECK_ELEMENTS)
            pieces = list(tadamw._pieces(
                [tr.params[i].numel() for i in g], 0, n))
            flat_p = [tr.params[i].detach().view(-1) for i in g]
            flat_g = [grads[i].reshape(-1) for i in g]
            heads.append((k, g, pieces,
                          tadamw._gather(flat_p, pieces).cpu(),
                          tadamw._gather(flat_g, pieces).float().cpu()))
            n_of[k] = n
        update()
        worst = {"param_rel": 0.0, "moment_entries_off": 0,
                 "q_max_step": 0, "s_rel": 0.0}
        total = 0
        for k, g, pieces, want, g0 in heads:
            # updates ``want`` in place: the CPU's parameters after step 1
            cpu = tadamw.AdamW([want], lr=tr.opt.lr, b1=tr.opt.b1,
                               b2=tr.opt.b2, eps=tr.opt.eps,
                               weight_decay=tr.opt.weight_decay,
                               state_dtype=sd)
            cpu.update([g0])
            got = tadamw._gather([tr.params[i].detach().view(-1)
                                  for i in g], pieces).cpu()
            d = (got - want).abs() - 1e-7
            worst["param_rel"] = max(worst["param_rel"], float(
                (d / want.abs().clamp_min(1e-30)).max()))
            for name in ("m", "v"):
                if sd == "int8":
                    nb = cpu.m[0]["q"].shape[0]
                    mine = getattr(tr.opt, name)[k]
                    q = mine["q"][:nb].cpu().int()
                    s_ = mine["s"][:nb].cpu()
                    rq = getattr(cpu, name)[0]["q"].int()
                    rs = getattr(cpu, name)[0]["s"]
                    worst["q_max_step"] = max(worst["q_max_step"], int(
                        (q - rq).abs().max()))
                    worst["moment_entries_off"] += int((q != rq).sum())
                    worst["s_rel"] = max(worst["s_rel"], float(
                        ((s_ - rs).abs() / rs.abs().clamp_min(
                            1e-30)).max()))
                    total += q.numel()
                else:
                    mine = tadamw._gather(
                        [getattr(tr.opt, name)[i].view(-1) for i in g],
                        pieces).cpu()
                    worst["moment_entries_off"] += int(
                        (mine != getattr(cpu, name)[0]).sum())
                    total += mine.numel()
        worst["moment_entries"] = total
        worst["elements_a_leaf"] = A10_CPU_CHECK_ELEMENTS
        moments_check[sd] = worst
        log(f"[a10] (b) step 1's update against the port's AdamW on the "
            f"CPU, {sd} moments, the first {A10_CPU_CHECK_ELEMENTS} "
            f"elements of each "
            f"of {len(heads)} leaves: {worst}")
        if worst["param_rel"] > 1e-6 or (
                sd == "bfloat16" and worst["moment_entries_off"]) or (
                sd == "int8" and (worst["q_max_step"] > 1 or
                                  worst["moment_entries_off"] >
                                  A10_INT8_OFF_SHARE * total or
                                  worst["s_rel"] > 1e-6)):
            raise AssertionError(f"(b) {sd} moments disagree with the CPU's "
                                 f"AdamW: {worst}")

    moments_check = {}
    runs = {}
    for sd, steps in A10_VLM_STEPS.items():
        with torch.no_grad():
            for p, p0 in zip(model.parameters(), init):
                p.copy_(p0)
        tr, runs[sd] = train(f"(b) {sd}", model, task, steps, cfg.n_layers,
                             {"positions": A10_VLM_SEQ}, sd,
                             on_update=moments_vs_cpu, lr=A10_VLM_LR)
        del tr
        release()
    b["train"] = runs
    b["moments_vs_cpu"] = moments_check
    log(f"[a10] (b) losses by moment dtype: " + "; ".join(
        f"{sd} {', '.join(f'{x:.4f}' for x in r['losses'])}"
        for sd, r in runs.items()) + "; peaks " + ", ".join(
        f"{sd} {r['peak_bytes'] / 2**30:.2f} GiB" for sd, r in runs.items()))
    rec["b"] = b
    del model, task, init
    release()
    rec["launches"] = launches
    rec["launches_float32"] = launches_f32
    return rec


def a10_phase(out_path: str) -> int:
    """Phase 14, in a child process: the enc-dec and VLM families and
    AdamW's reduced-precision moments (``a10_runs``), on an empty card
    (InternVL2's one layer holds ~48 GB of training state with fp32
    moments), with deterministic algorithms where PyTorch has them
    (``warn_only``) and ``CUBLAS_WORKSPACE_CONFIG`` from the parent: step
    0's check holds the kernel path to ``impl="plain"``, whose
    ``index_add_`` otherwise accumulates with atomics in a new order each
    run, and SeamlessM4T's decoder norms' gradients sit within 1% of
    their norm limit (PERF.md 6). The record goes to ``out_path`` as
    JSON."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke phase 14: no CUDA device", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import cluster_attention as tca
    from repro_torch.kernels import cluster_attention_bwd as tcab

    from repro_torch.models import encdec as ted

    # (a)'s seeded init draws on the CPU: ahead of the turn, beside the
    # phase before this one, and moved to the card at the turn
    t0 = time.perf_counter()
    host_model = ted.EncDecModel(a10_encdec_config(), device="cpu", seed=0)
    host_init_s = time.perf_counter() - t0
    await_turn(torch)
    t_start = time.perf_counter()
    kbuild.build_all((tca.LIBRARY_UNBIASED_SM90, tcab.LIBRARY_UNBIASED_SM90,
                      tca.LIBRARY_UNBIASED))
    reset_counts, read_counts = kernel_counters()
    rec = a10_runs(torch.device("cuda"), reset_counts, read_counts,
                   host_model, host_init_s)
    rec["seconds"] = time.perf_counter() - t_start
    with open(out_path, "w") as fh:
        json.dump(rec, fh)
    log(f"[a10] {rec['seconds']:.1f}s, launches "
        f"{ {k: c for k, c in rec['launches'].items() if c} }, fp32 "
        f"{ {k: c for k, c in rec['launches_float32'].items() if c} }")
    return 0


GP_P = 2                     # ranks of phase 15, sharing card 0 over gloo
GP_TRAIN_STEPS = 4           # (b): dense at 0 (interleave period 8)
GP_TRAIN_LAYERS = 3          # (b): of Large's 12 (cut from 6)
GP_LM_STEPS = 2              # (c)
# (c): 4 of Qwen3-0.6B's 28 layers: at full depth its two steps took
# 21-30 s on an H100 (the gloo collectives through the host), at 8 layers
# 10-14 s, more than the script's time budget leaves once (d)-(i) run
# (PERF.md 4, 7)
GP_LM_LAYERS = 4
# (d)-(i), slice 17's paths on the same two ranks
MESH_STEPS = 4               # (d), (e): dense at 0 and 2
MESH_INTERLEAVE = 2
MESH_MIN_GRAD_COSINE = 0.9999   # init steps P = 2 vs P = 1; (f) EP vs dropless
MESH_EP_TOKENS = 4096        # (f): one MoE layer's tokens a model group
MESH_EP_CF = (16.0, 1.25)    # (f): E/k (nothing drops), the default
MESH_MOE_LAYERS = 1          # (g): of Qwen3-235B-A22B's 94
MESH_MOE_SEQ = 2048
MESH_MOE_STEPS = 2
MESH_SERVE_REQUESTS = 4      # (h); cut from 8
MESH_SERVE_NEW = 32
MESH_SERVE_PROMPT = (64, 512)        # Qwen3-0.6B, fp32
MESH_MOE_SERVE_PROMPT = (128, 1024)  # Qwen3-235B-A22B, one layer, bf16
MESH_TOKEN_MARGIN = 1e-4     # a token flip only at a near-tie
MESH_COMPRESS_REL = 0.02     # (i): the reference's bound
MESH_CONSERVED_REL = 1e-5    # (i): reduced + mean residual = exact mean
MESH_PIPE_MICRO = 4          # (i): microbatches of 32 graphs' tokens
MESH_PIPE_SEQ = 128          # (i): (d)'s packed sequence
MESH_PIPE_TOL = 1e-4         # (i): fp32, pipeline against sequential
# (j)-(o), slice 18's paths: (j) on a (1, 3) model mesh of its own ranks,
# (k)-(o) on phase 15's two
GP_FALLBACK_P = 3            # (j): GT's 8 heads do not split 3 ways
# (k)-(n): one step each on one batch, cut from 2 (room for phase 9c):
# each step's gradients cross the host twice in gloo's all-reduce
# (PERF.md 7)
FAM_STEPS = 1
FAM_SSM_LAYERS = 4           # (k): of Mamba2-2.7B's 64
FAM_SSM_SEQ = 8192
FAM_ENCDEC_LAYERS = 4        # (l): encoder and decoder layers, of 12 + 12
FAM_VLM_LAYERS = 1           # (m): of InternVL2-76B's 80
FAM_VLM_SEQ = 4096           # (m): 256 patches + 3840 tokens
FAM_JAMBA_SEQ = 2048         # (n): phase 13 (c)'s shape, a quarter width
FAM_JAMBA_BATCH = 2
FAM_CKPT_STEPS = 4           # (o): saved at 2, resumed to 4
FAM_CKPT_TOL = 1e-5          # (o): P = 1 against P = 2, fp32, relative


def _gp_timed(mod, name, store):
    """Replace ``mod.name`` (a collective) by a version that records a
    CUDA event pair around each call into ``store[name]``."""
    import torch

    real = getattr(mod, name)

    def timed(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(*a, **kw)
        e1.record()
        store.setdefault(name, []).append((e0, e1))
        return out
    setattr(mod, name, timed)
    return real


def _gp_ms(store) -> dict:
    import torch

    torch.cuda.synchronize()
    out = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in store.items()}
    store.clear()
    return out


def _gp_tools(say, reset_counts, read_counts, store):
    """``(trainer_steps, grads_at_init)`` of phase 15's ranks: a Trainer
    run with its collectives timed and its launches counted exactly, and
    each variant's loss and gradients at the init."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import recipe_for
    from repro_torch.runtime.trainer import Trainer

    zero = {name: 0 for name in read_counts()}

    def trainer_steps(tag, model, task, tc, want_fn, seq, mesh_=None,
                      on_trainer=None):
        """Train ``model`` on ``task`` (sequences of ``seq`` tokens), on
        ``mesh_`` or on one process, the collectives timed; returns the
        record and the Trainer. ``on_trainer(tr)`` sees the Trainer
        before it runs."""
        kw = {} if mesh_ is None else {
            "mesh": mesh_, "recipe": recipe_for(ShapeConfig(
                "t", "train", seq, 1), mesh_)}
        tr = Trainer(model, tc, task=task, **kw)
        if on_trainer is not None:
            on_trainer(tr)
        reals = [(n, _gp_timed(C, n, store)) for n in
                 ("all_to_all", "all_reduce_")] if mesh_ is not None else []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        try:
            tr.run()
        finally:
            for n, f in reals:
                setattr(C, n, f)
        torch.cuda.synchronize()
        out = {"run_s": time.perf_counter() - t0, "launches": read_counts(),
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "loss": [h["loss"] for h in tr.history],
               "variant": [h["variant"] for h in tr.history],
               "step_ms": [h["seconds"] * 1e3 for h in tr.history],
               "collective_ms": _gp_ms(store) if mesh_ is not None else {}}
        want = {**zero, **want_fn(tr.history)}
        say(f"{tag}: losses {[round(x, 5) for x in out['loss']]}, variants "
            f"{out['variant']}, step ms "
            f"{[round(x, 2) for x in out['step_ms']]}, peak "
            f"{out['peak_bytes'] / 2**30:.2f} GiB, collectives' ms "
            f"{ {k: round(x, 1) for k, x in out['collective_ms'].items()} }"
            f", launches { {n: c for n, c in out['launches'].items() if c} }")
        if out["launches"] != want or not np.isfinite(out["loss"]).all():
            raise AssertionError(f"{tag}: launches {out['launches']}, want "
                                 f"{want}; losses {out['loss']}")
        return out, tr

    def grads_at_init(model, task, mesh_=None):
        """Each variant's loss and gradients (summed over the ranks) at the
        init, on the task's batch of step 0."""
        out = {}
        for variant, fn in model.loss_variants.items():
            ctx = task.context()
            with ctx:
                loss, _ = fn(model, task.batches(0))
                gs = torch.autograd.grad(loss, list(model.parameters()),
                                         allow_unused=True)
            gs = [torch.zeros_like(p) if x is None else x
                  for x, p in zip(gs, model.parameters())]
            if mesh_ is not None:
                flat = torch.cat([x.reshape(-1) for x in gs])
                C.all_reduce_(flat, None)
                gs = list(flat.split([x.numel() for x in gs]))
            out[variant] = (loss.item(), [x.reshape(-1) for x in gs])
        return out

    return trainer_steps, grads_at_init


def gp_runs(rank: int, dev, reset_counts, read_counts, tmp) -> dict:
    """Phase 15's runs on this rank of a (1, GP_P) mesh over gloo, every
    rank on ``dev``: (a) ``sharded_cluster_attention`` at
    Graphormer-Large's width on the 8192-node graph's layout, in bf16,
    held to the unsharded kernel call and to ``impl="plain"``, its
    all-to-all bytes against ``cluster_a2a_budget``, the all-to-all's
    share of the call timed by CUDA events; (b) Graphormer-Large
    (GP_TRAIN_LAYERS layers) node training through ``NodeTask`` and the
    Trainer on the mesh, GP_TRAIN_STEPS steps with the dense interleave
    at 0, held to the P = 1 run on rank 0 (losses, the gradients of both
    variants at the init); (c) Qwen3-0.6B on the cluster-sparse backend
    under Ulysses, LM_SEQ tokens, GP_LM_STEPS steps, held to the P = 1
    run on rank 0. The launches of (b) and (c) on this rank, exactly;
    step ms; the collectives' ms by CUDA events; peaks."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.graph_model import GraphModel
    from repro_torch.data.graph_pipeline import prepare_node_task
    from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import degree_scaled_sbm
    from repro_torch.models import layers as L
    from repro_torch.models.lm import LMModel
    from repro_torch.parallel import cluster_parallel as tcp
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import ulysses as tu
    from repro_torch.parallel.sharding import recipe_for
    from repro_torch.runtime.trainer import TrainerConfig
    from repro_torch.tasks import BatchFnTask

    P = dist.get_world_size()
    mesh = make_host_mesh(model=P)
    group = mesh.get_group("model")
    rec = {"rank": rank}
    zero = {name: 0 for name in read_counts()}
    store = {}
    t_rank = time.perf_counter()

    def say(msg):
        # the seconds since this rank's turn: each sub-phase's share
        log(f"[graph-parallel] rank {rank} at "
            f"{time.perf_counter() - t_rank:.1f} s: {msg}")

    def shard(x):
        n = x.shape[1] // P
        return x[:, rank * n:(rank + 1) * n]

    # ---------------------------------------------------------------- (a)
    large = get_config("graphormer_large")
    g = degree_scaled_sbm(TRAIN_NODES, CLUSTERS, large, seed=0)
    prep = prepare_node_task(g, large, bq=32, bk=32, d_b=8)
    lay = prep.layout
    bi, bu, bit = (torch.from_numpy(np.ascontiguousarray(prep.batch[k])).to(
        dev) for k in ("block_idx", "buckets", "block_idx_t"))
    S, H, Dh = lay.seq_len, large.n_heads, large.head_dim
    gen = torch.Generator(device=dev).manual_seed(41)
    q, k, v, dout = (torch.randn(1, S, H, Dh, generator=gen, device=dev)
                     .to(torch.bfloat16) for _ in range(4))
    table = torch.randn(H, lay.n_buckets, generator=gen, device=dev) * 0.5

    def run(sharded, impl=None):
        leaves = [(shard(x) if sharded else x).clone().requires_grad_()
                  for x in (q, k, v)]
        tbl = table.clone().requires_grad_()
        if sharded:
            o = tcp.sharded_cluster_attention(
                *leaves, bi, bu, tbl, bit, group=group, bq=32, bk=32,
                impl=impl)
        else:
            o = ops.cluster_attention(*leaves, bi, bu, tbl, bit, impl=impl)
        o.backward(shard(dout) if sharded else dout)
        dt = tbl.grad
        if sharded:
            C.all_reduce_(dt, group)
        grads = [x.grad if sharded else shard(x.grad) for x in leaves]
        return (o.detach() if sharded else shard(o.detach())), grads, dt

    o_s, g_s, dt_s = run(True)
    o_k, g_k, dt_k = run(False)
    o_p, g_p, dt_p = run(False, "plain")
    atol, rtol = TOL_O_ELEM["bfloat16"]
    a = {"S": S, "H": H, "Dh": Dh, "active_blocks": int((bi >= 0).sum())}
    for ref_name, o_r, g_r, dt_r in (("kernel", o_k, g_k, dt_k),
                                     ("plain", o_p, g_p, dt_p)):
        excess = ((o_s.float() - o_r.float()).abs()
                  - (atol + rtol * o_r.float().abs())).max().item()
        rels = [_rel(x, y) for x, y in zip(g_s + [dt_s], g_r + [dt_r])]
        err = (o_s.float() - o_r.float()).abs().max().item()
        ok = rels and max(rels) <= TOL_GRAD["bfloat16"] and (
            excess <= 0 if ref_name == "kernel" else
            err <= TOL_O["bfloat16"])
        a[f"vs_{ref_name}"] = {"max_abs_err": err, "o_excess": excess,
                               "rel_dq_dk_dv_dtable": rels}
        say(f"(a) sharded_cluster_attention S={S} H={H} Dh={Dh} bf16 vs "
            f"the unsharded {ref_name} call: max|dO| {err:.3g} (kernel: "
            f"element by element within {atol} + {rtol}|O|, excess "
            f"{excess:.3g}; plain: tol {TOL_O['bfloat16']}), rel dq dk dv "
            f"dtable {[f'{r:.3g}' for r in rels]} (tol "
            f"{TOL_GRAD['bfloat16']})")
        if not ok:
            raise AssertionError(f"(a) sharded vs {ref_name}: {a}")
    del o_k, g_k, o_p, g_p
    ql, kl, vl = (shard(x).contiguous() for x in (q, k, v))
    with torch.no_grad():
        fwd = lambda: tcp.sharded_cluster_attention(  # noqa: E731
            ql, kl, vl, bi, bu, table, None, group=group, bq=32, bk=32)
        fwd()
        a["a2a_bytes"] = tcp.LAST_CALL["a2a_bytes"]
        a["a2a_budget"] = tcp.cluster_a2a_budget(q.shape, k.shape, 2, P)
        # each call timed whole and in its all-to-alls, the same calls
        real = _gp_timed(C, "all_to_all", store)
        calls = []
        try:
            for _ in range(5):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fwd()
                e1.record()
                torch.cuda.synchronize()
                calls.append((e0.elapsed_time(e1),
                              _gp_ms(store)["all_to_all"]))
        finally:
            C.all_to_all = real
        a["fwd_ms"] = float(np.median([t for t, _ in calls]))
        a["a2a_ms_in_fwd"] = float(np.median([x for _, x in calls]))
        a["a2a_share"] = float(np.median([x / t for t, x in calls]))
        a["unsharded_fwd_ms"] = cuda_ms(lambda: ops.cluster_attention(
            q, k, v, bi, bu, table), 5)
    say(f"(a) all-to-all {a['a2a_bytes']:,} bytes a forward, budget "
        f"{a['a2a_budget']:,} (cluster_a2a_budget); sharded forward "
        f"{a['fwd_ms']:.3f} ms, {a['a2a_ms_in_fwd']:.3f} ms of it in the "
        f"all-to-alls (medians of 5 calls; {a['a2a_share']:.1%} a call, "
        f"gloo through the host); the unsharded kernel "
        f"{a['unsharded_fwd_ms']:.3f} ms")
    if not 0 < a["a2a_bytes"] <= a["a2a_budget"]:
        raise AssertionError(f"(a) all-to-all bytes {a['a2a_bytes']} over "
                             f"the budget {a['a2a_budget']}")
    rec["a"] = a
    del q, k, v, dout, ql, kl, vl
    torch.cuda.empty_cache()

    trainer_steps, grads_at_init = _gp_tools(say, reset_counts, read_counts,
                                             store)

    # ---------------------------------------------------------------- (b)
    cfg_b = get_config("graphormer_large").replace(n_layers=GP_TRAIN_LAYERS)
    train_mask = np.random.default_rng(0).random(g.n) < 0.5
    tc_b = TrainerConfig(steps=GP_TRAIN_STEPS, lr=1e-3, warmup=2,
                         interleave_period=cfg_b.interleave_period,
                         elastic_every=0, max_bad_steps=0)
    n_sparse = sum(1 for s in range(GP_TRAIN_STEPS)
                   if s % cfg_b.interleave_period)
    want_b = lambda hist: step_launches(cfg_b, B32_NAMES, sum(  # noqa: E731
        1 for h in hist if h["variant"] == "sparse"))
    ref_b = None
    if rank == 0:   # the P = 1 run, while the other ranks wait
        model = GraphModel(cfg_b, device=dev, seed=0)
        task = start_rung_task(g, cfg_b, train_mask=train_mask, bq=32,
                               bk=32, d_b=8, device=dev).prepare(model)
        ref_grads = grads_at_init(model, task)
        ref_b = trainer_steps("(b) graphormer-large P=1", model, task,
                                 tc_b, want_b, S)[0]
        del model, task
        torch.cuda.empty_cache()
    dist.barrier()
    model = GraphModel(cfg_b, device=dev, seed=0)
    task = start_rung_task(g, cfg_b, train_mask=train_mask, bq=32, bk=32,
                           d_b=8, device=dev)
    recipe = recipe_for(ShapeConfig("t", "train", S, 1), mesh)
    task.prepare(model, mesh, recipe)
    got = grads_at_init(model, task, mesh)
    b = {"sparse_steps": n_sparse}
    if rank == 0:
        for variant, (loss, gs) in got.items():
            rl, rg = ref_grads[variant]
            cos = [F.cosine_similarity(x.float(), y.float(), dim=0,
                                       eps=1e-30).item()
                   for x, y in zip(gs, rg)]
            b[f"init_{variant}"] = {"loss": loss, "p1_loss": rl,
                                    "loss_rel": abs(loss - rl) / abs(rl),
                                    "min_grad_cosine": min(cos)}
            say(f"(b) {variant} step at the init, P={P} vs P=1: loss "
                f"{loss:.6f} vs {rl:.6f} (rel {abs(loss - rl) / abs(rl):.3g},"
                f" tol {TOL_STEP_LOSS_REL}); min gradient cosine "
                f"{min(cos):.6f} (min {MIN_GRAD_COSINE})")
            if abs(loss - rl) > TOL_STEP_LOSS_REL * abs(rl) or \
                    min(cos) < MIN_GRAD_COSINE:
                raise AssertionError(f"(b) {variant} at the init: {b}")
        del ref_grads
    del got
    # the Trainer prepares the task on the mesh again
    b["run"] = trainer_steps(f"(b) graphormer-large P={P}", model, task,
                                tc_b, want_b, S, mesh)[0]
    b["p1"] = ref_b
    rec["b"] = b
    del model, task
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- (c)
    cfg_c = get_config("qwen3_0_6b").replace(attn_backend="cluster_sparse",
                                             n_layers=GP_LM_LAYERS)
    dc = LMDataConfig(cfg_c.vocab_size, LM_SEQ, 1, seed=0)
    tc_c = TrainerConfig(steps=GP_LM_STEPS, lr=1e-3, warmup=2,
                         max_bad_steps=0)
    want_c = lambda hist: step_launches(  # noqa: E731
        cfg_c, UNBIASED_NAMES, len(hist))
    ref_c = None
    if rank == 0:
        with L.draw_on_device():
            model = LMModel(cfg_c, device=dev, seed=0)
        ref_c = trainer_steps("(c) qwen3-0.6b P=1", model,
                                 BatchFnTask(lambda s: lm_batch(dc, s)),
                                 tc_c, want_c, LM_SEQ)[0]
        del model
        torch.cuda.empty_cache()
    dist.barrier()
    with L.draw_on_device():
        model = LMModel(cfg_c, device=dev, seed=0)
    c = {"layers": GP_LM_LAYERS}
    c["run"] = trainer_steps(f"(c) qwen3-0.6b P={P} ulysses", model,
                                BatchFnTask(lambda s: lm_batch(dc, s)),
                                tc_c, want_c, LM_SEQ, mesh)[0]
    c["p1"] = ref_c
    rec["c"] = c
    del model
    release()
    rec.update(mesh_runs(rank, dev, mesh, say, trainer_steps, grads_at_init,
                         read_counts))
    rec.update(family_runs(rank, dev, mesh, say, trainer_steps, tmp,
                           read_counts))
    return rec


def _gt_held_to_p1(tag, task, names, seq, meshes, *, rank, dev, say,
                   trainer_steps, grads_at_init, read_counts,
                   min_cosine=MESH_MIN_GRAD_COSINE) -> dict:
    """GT at full width on ``task``: the P = 1 run on rank 0 (the other
    ranks waiting), then on each ``(name, mesh)`` of ``meshes`` the init
    step against it (the loss at TOL_STEP_LOSS_REL, every gradient at a
    cosine of ``min_cosine``), the attention op held to
    ``impl="plain"`` on the model mesh, and MESH_STEPS steps with the
    dense step every MESH_INTERLEAVE; returns the runs and the init
    checks. (d), (e) and (j)."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import graph_model as tgm
    from repro_torch.parallel.sharding import recipe_for
    from repro_torch.runtime.trainer import TrainerConfig

    gt = get_config("gt")
    P = dist.get_world_size()

    def recipe(m, seq):
        return recipe_for(ShapeConfig("t", "train", seq, 1), m)

    tc = TrainerConfig(steps=MESH_STEPS, lr=1e-3, warmup=2,
                       interleave_period=MESH_INTERLEAVE,
                       elastic_every=0, max_bad_steps=0)
    want = lambda hist: step_launches(gt, names, sum(  # noqa: E731
        1 for h in hist if h["variant"] == "sparse"))
    out = {}
    if rank == 0:
        model = tgm.GraphModel(gt, device=dev, seed=0)
        task.prepare(model)
        ref = grads_at_init(model, task)
        out["p1"] = trainer_steps(f"{tag} P=1", model, task, tc, want,
                                  seq)[0]
        del model
    dist.barrier()
    for name, m in meshes:
        model = tgm.GraphModel(gt, device=dev, seed=0)
        task.prepare(model, m, recipe(m, seq))
        if name == "model":
            with task.context():
                out["op_check"] = op_check(
                    f"{tag} model mesh, rank {rank}", model,
                    task.loss_variants["sparse"], task.batches(0),
                    names, read_counts, log_tag="graph-parallel")
        got = grads_at_init(model, task, m)
        if rank == 0:
            for variant, (loss, gs) in got.items():
                rl, rg = ref[variant]
                cos = min(F.cosine_similarity(
                    x.float(), y.float(), dim=0, eps=1e-30).item()
                    for x, y in zip(gs, rg))
                rel = abs(loss - rl) / abs(rl)
                out[f"init_{name}_{variant}"] = {
                    "loss": loss, "p1_loss": rl, "loss_rel": rel,
                    "min_grad_cosine": cos}
                say(f"{tag} {name} mesh, {variant} step at the init vs "
                    f"P=1: loss rel {rel:.3g} (tol "
                    f"{TOL_STEP_LOSS_REL}), min gradient cosine "
                    f"{cos:.7f} (min {min_cosine})")
                if rel > TOL_STEP_LOSS_REL or cos < min_cosine:
                    raise AssertionError(f"{tag} {name} at the init: "
                                         f"{out}")
        del got
        out[name] = trainer_steps(f"{tag} {name} mesh P={P}", model, task,
                                  tc, want, seq, m)[0]
        del model
        release()
    if rank == 0:
        del ref
    return out


def mesh_runs(rank: int, dev, mesh, say, trainer_steps, grads_at_init,
              read_counts) -> dict:
    """Phase 15's sub-phases (d)-(i), slice 17's paths, on this rank of
    the two sharing card 0 (``mesh``: the (1, GP_P) model mesh; a (GP_P,
    1) data mesh is made here). (d) GT graph-level at full width, 128
    graphs of S=128 at 16 x 16 blocks, on the data mesh and on the model
    mesh, and (e) GT link on the 2048-node SBM at 32 x 32 on the model
    mesh, each MESH_STEPS steps with the dense interleave, held to the
    P = 1 run on rank 0 (the init step's loss and gradient cosines, the
    losses in the parent), the model mesh's attention op held to
    ``impl="plain"``; (f) the expert-parallel MoE op at Qwen3-235B-A22B's
    width, bf16, MESH_EP_TOKENS tokens, at cf E/k against the dropless
    op (forward and gradients) and at 1.25 its dropped pairs against a
    host recount; (g) Qwen3-235B-A22B (one layer, each rank holding its
    64 experts) trained MESH_MOE_STEPS steps under Ulysses and expert
    parallelism with int8 moments, its attention op held to plain; (h)
    ``ServeEngine(mesh_model=GP_P)``: Qwen3-0.6B fp32 against the P = 1
    engine (a flip only at a near-tie), then (g)'s weights served; (i)
    the compressed all-reduce of GT's gradients against the exact mean,
    and a GP_P-stage pipeline of GT's fp32 layers against the sequential
    apply. Returns the record; (d), (e) and (g)'s launches exactly
    counted in their runs."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import graph_model as tgm
    from repro_torch.core.graph import sbm_graph
    from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import moe as tmoe
    from repro_torch.models.lm import LMModel, lm_forward, lm_loss
    from repro_torch.optim import compress as tcomp
    from repro_torch.parallel import axes as pax
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.parallel.sharding import recipe_for
    from repro_torch.runtime.trainer import TrainerConfig
    from repro_torch.serve import ServeEngine
    from repro_torch.tasks import (BatchFnTask, GraphLevelTask, LinkTask,
                                   synthetic_graph_level_dataset)

    P = dist.get_world_size()
    group = mesh.get_group("model")
    data_mesh = make_host_mesh(model=1, data=P)
    gt = get_config("gt")
    rec = {}

    def shard(x):
        n = x.shape[1] // P
        return x[:, rank * n:(rank + 1) * n]

    def recipe(m, seq):
        return recipe_for(ShapeConfig("t", "train", seq, 1), m)

    # ------------------------------------------------------- (d), (e)
    def held_to_p1(tag, task, names, seq, meshes):
        return _gt_held_to_p1(tag, task, names, seq, meshes, rank=rank,
                              dev=dev, say=say, trainer_steps=trainer_steps,
                              grads_at_init=grads_at_init,
                              read_counts=read_counts)

    t0 = time.perf_counter()
    task = GraphLevelTask(synthetic_graph_level_dataset(GRAPH_BATCH, gt,
                                                        seed=1), gt,
                          batch_graphs=GRAPH_BATCH, device=dev)
    prep_s = time.perf_counter() - t0
    seq = task.layout.seq_len
    rec["d"] = {"graphs": GRAPH_BATCH, "S": seq, "bq": task.layout.bq,
                "prep_s": prep_s, **held_to_p1(
                    "(d) gt graph-level", task, B16_NAMES, seq,
                    (("data", data_mesh), ("model", mesh)))}
    del task
    t0 = time.perf_counter()
    task = LinkTask(sbm_graph(LINK_NODES, 4, p_in=0.04, p_out=0.002,
                              feat_dim=gt.feat_dim, n_classes=gt.n_classes,
                              seed=0), gt, n_pairs=LINK_PAIRS, device=dev)
    prep_s = time.perf_counter() - t0
    seq = task.layout.seq_len
    rec["e"] = {"nodes": LINK_NODES, "S": seq, "prep_s": prep_s,
                **held_to_p1("(e) gt link", task, B32_NAMES, seq,
                             (("model", mesh),))}
    del task
    release()

    def resident(tag):
        """What this rank still holds when a sub-phase starts."""
        n = release()
        say(f"{tag} starts with {n / 2**30:.2f} GiB allocated")
        return n

    # ------------------------------------------------------------ (f)
    rec["resident_bytes"] = {"f": resident("(f)")}
    cfg_f = get_config(MOE_ARCH)
    D, E = cfg_f.d_model, cfg_f.moe_experts
    mine = slice(rank * E // P, (rank + 1) * E // P)
    gen = torch.Generator(device=dev).manual_seed(43)
    # tokens sharing one direction, as a layer's tokens do: the router
    # then prefers some experts (independent tokens load 128 experts so
    # evenly that 1.25 of the mean load drops nothing)
    x = (torch.randn(1, MESH_EP_TOKENS, D, generator=gen, device=dev) * 0.5
         + torch.randn(D, generator=gen, device=dev)).to(torch.bfloat16)
    gy = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)
    full = tmoe.MoE(cfg_f, device=dev)
    with L.draw_on_device():
        L.seeded_init(full, tmoe.moe_defs(cfg_f), seed=0)

    def fwd_bwd(p, xx, g, **kw):
        xx = xx.clone().requires_grad_()
        y, aux = tmoe.moe_apply(p, cfg_f, xx, **kw)
        obj = (y.float() * g.float()).sum() + aux
        grads = torch.autograd.grad(obj, [p.router, p.w_gate, p.w_up,
                                          p.w_down, xx])
        return y.detach(), aux.detach(), list(grads)

    torch.cuda.reset_peak_memory_stats()
    y, aux, g = fwd_bwd(full, x, gy)          # dropless, no mesh context
    ref = {"y": shard(y), "aux": aux, "grads": [g[0]] + [
        w[mine].clone() for w in g[1:4]] + [shard(g[4])]}
    part = tmoe.MoE(cfg_f, device=dev, experts=(rank, P))
    with torch.no_grad():
        part.router.copy_(full.router)
        for n in ("w_gate", "w_up", "w_down"):
            getattr(part, n).copy_(getattr(full, n)[mine])
    f = {"tokens": MESH_EP_TOKENS, "experts_per_rank": E // P,
         "dropless_peak_bytes": torch.cuda.max_memory_allocated()}
    del full, y, g
    release()
    rec_ep = recipe(mesh, MESH_EP_TOKENS)
    for cf in MESH_EP_CF:
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(3):
            e0, e1 = event_pair()
            e0.record()
            with pax.axis_rules(rec_ep, mesh):
                y, aux, g = fwd_bwd(part, shard(x), shard(gy),
                                    capacity_factor=cf)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        dropped = C.all_reduce_(tmoe.LAST_CALL["dropped"].clone(), group)
        C.all_reduce_(g[0], group)            # the router's, over the ranks
        c = {"capacity": tmoe.capacity(MESH_EP_TOKENS, cfg_f, cf),
             "fwd_bwd_ms": float(np.median(ms)),
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "dropped": int(dropped)}
        if cf == MESH_EP_CF[0]:
            # y and x's gradient sum a token's k = 8 slots in bf16, in
            # another order than the dropless op's: rel within TOL_O and
            # a cosine of MESH_MIN_GRAD_COSINE
            names = ("y", "router", "w_gate", "w_up", "w_down", "x")
            pairs = list(zip([y] + g, [ref["y"]] + ref["grads"]))
            c["rel"] = dict(zip(names, (_rel(a, b) for a, b in pairs)))
            c["cosine"] = dict(zip(names, (F.cosine_similarity(
                a.flatten().float(), b.flatten().float(), dim=0,
                eps=1e-30).item() for a, b in pairs)))
            c["aux_err"] = abs(aux.item() - ref["aux"].item())
            del pairs
            ok = (max(c["rel"].values()) <= TOL_O["bfloat16"]
                  and min(c["cosine"].values()) >= MESH_MIN_GRAD_COSINE
                  and c["aux_err"] <= 1e-5 and c["dropped"] == 0)
            what = (f"against the dropless op: rel "
                    f"{ {k: float(f'{v:.3g}') for k, v in c['rel'].items()} }"
                    f" (tol {TOL_O['bfloat16']}), min cosine "
                    f"{min(c['cosine'].values()):.7f} (min "
                    f"{MESH_MIN_GRAD_COSINE}), |daux| {c['aux_err']:.3g}")
        else:
            c["recount"] = tmoe.dropped_pairs(
                part, cfg_f, x.reshape(-1, D), P, cf)
            ok = c["dropped"] == c["recount"] > 0
            what = f"host recount {c['recount']}"
        say(f"(f) expert-parallel MoE op, {MESH_EP_TOKENS} tokens bf16, cf "
            f"{cf} (c_e {c['capacity']}): dropped {c['dropped']} pairs, "
            f"{what}; forward + backward {c['fwd_bwd_ms']:.2f} ms (median "
            f"of 3), peak {c['peak_bytes'] / 2**30:.2f} GiB")
        if not ok:
            raise AssertionError(f"(f) cf {cf}: {c}")
        f[f"cf_{cf}"] = c
        del y, g
    rec["f"] = f
    del part, ref, x, gy
    release()

    # ------------------------------------------------------------ (g)
    rec["resident_bytes"]["g"] = resident("(g)")
    cfg_g = get_config(MOE_ARCH).replace(n_layers=MESH_MOE_LAYERS,
                                         attn_backend="cluster_sparse",
                                         remat="block")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with L.draw_on_device():
        model = LMModel(cfg_g, device=dev, seed=0, experts=(rank, P))
    torch.cuda.synchronize()
    named = list(model.named_parameters())
    g_rec = {"init_s": time.perf_counter() - t0,
             "params": sum(p.numel() for _, p in named),
             "expert_params": sum(p.numel() for n, p in named
                                  if ".moe.w_" in n)}
    # one batch every step, so that the loss's fall is the update's
    dc = LMDataConfig(cfg_g.vocab_size, MESH_MOE_SEQ, 1, seed=0)
    task = BatchFnTask(lambda s: lm_batch(dc, 0))
    rec_g = recipe(mesh, MESH_MOE_SEQ)
    task.prepare(model, mesh, rec_g)
    with pax.axis_rules(rec_g, mesh):
        g_rec["op_check"] = op_check(
            f"(g) qwen3-235b-a22b rank {rank}", model, lm_loss,
            task.batches(0), UNBIASED_NAMES, read_counts,
            log_tag="graph-parallel")
    tc = TrainerConfig(steps=MESH_MOE_STEPS, lr=1e-3, warmup=0,
                       state_dtype="int8", max_bad_steps=0)
    g_rec["run"], tr = trainer_steps(
        f"(g) qwen3-235b-a22b 1 layer P={P} ulysses + experts", model, task,
        tc, lambda hist: step_launches(cfg_g, UNBIASED_NAMES, len(hist)),
        MESH_MOE_SEQ, mesh)
    losses = g_rec["run"]["loss"]
    say(f"(g) {g_rec['params']:,} parameters a rank ({g_rec['expert_params']:,}"
        f" of its experts), init {g_rec['init_s']:.2f} s; losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"(g) losses do not fall: {losses}")
    rec["g"] = g_rec
    del tr, task
    release()

    # ------------------------------------------------------------ (h)
    def serve(mdl, prompts, max_len, mesh_model):
        eng = ServeEngine(mdl, batch_slots=SERVE_SLOTS, page=SERVE_PAGE,
                          chunk=SERVE_CHUNK, max_len=max_len,
                          mesh_model=mesh_model)
        for i, p in enumerate(prompts):
            eng.submit(i, p, MESH_SERVE_NEW)
        torch.cuda.synchronize()
        stats = eng.run()
        torch.cuda.synchronize()
        stats["pool_bytes"] = eng.pool_bytes()
        return eng.done, stats

    def prompts_for(cfg, lo_hi, seed):
        rng = np.random.default_rng(seed)
        return [rng.integers(1, cfg.vocab_size // 8, int(n)).tolist()
                for n in rng.integers(*lo_hi, MESH_SERVE_REQUESTS)]

    h = {}
    cfg_h = get_config("qwen3_0_6b").replace(dtype="float32")
    prompts = prompts_for(cfg_h, MESH_SERVE_PROMPT, 7)
    max_len = MESH_SERVE_PROMPT[1] + MESH_SERVE_NEW
    with L.draw_on_device():
        dense = LMModel(cfg_h, device=dev, seed=0)
    if rank == 0:
        want, h["dense_p1"] = serve(dense, prompts, max_len, 1)
    dist.barrier()
    done, h["dense"] = serve(dense, prompts, max_len, P)
    if rank == 0:
        flips = []
        for rid, a in want.items():
            b = done[rid]
            if a == b:
                continue
            j = next(i for i, (u, v) in enumerate(zip(a, b)) if u != v)
            toks = torch.tensor([prompts[rid] + a[:j]], device=dev)
            with torch.no_grad():
                hid, _ = lm_forward(dense, {"tokens": toks})
                top = L.logits_fn(dense.embed, cfg_h, hid[:, -1:])[
                    0, 0, :cfg_h.vocab_size].float().topk(2).values
            flips.append((rid, j, (top[0] - top[1]).item()))
        h["flips"] = flips
        say(f"(h) qwen3-0.6b fp32 ServeEngine(mesh_model={P}) against P=1: "
            f"{MESH_SERVE_REQUESTS} requests, {MESH_SERVE_NEW} new each, "
            f"flips (request, position, top-2 margin) {flips} (a flip only "
            f"below {MESH_TOKEN_MARGIN}); {h['dense']['tok_per_s']:.1f} "
            f"tokens/s (P=1 {h['dense_p1']['tok_per_s']:.1f})")
        if any(m >= MESH_TOKEN_MARGIN for _, _, m in flips):
            raise AssertionError(f"(h) a token flipped off a near-tie: "
                                 f"{flips}")
    say(f"(h) qwen3-0.6b pool {h['dense']['pool_bytes']:,} bytes this rank")
    del dense
    release()
    cfg_m = model.cfg
    prompts = prompts_for(cfg_m, MESH_MOE_SERVE_PROMPT, 8)
    done, h["moe"] = serve(model, prompts, MESH_MOE_SERVE_PROMPT[1]
                           + MESH_SERVE_NEW, P)
    ok = len(done) == MESH_SERVE_REQUESTS and all(
        len(v) == MESH_SERVE_NEW for v in done.values())
    say(f"(h) qwen3-235b-a22b 1 layer bf16, (g)'s weights: "
        f"{h['moe']['requests']} requests, {h['moe']['tokens']} tokens in "
        f"{h['moe']['seconds']:.2f} s ({h['moe']['tok_per_s']:.1f} "
        f"tokens/s), pool {h['moe']['pool_bytes']:,} bytes this rank")
    if not ok:
        raise AssertionError(f"(h) moe serving: {h['moe']}")
    rec["h"] = h
    del model
    release()

    # ------------------------------------------------------------ (i)
    i_rec = {}
    task = GraphLevelTask(synthetic_graph_level_dataset(GRAPH_BATCH, gt,
                                                        seed=1), gt,
                          batch_graphs=GRAPH_BATCH, device=dev)
    model = tgm.GraphModel(gt, device=dev, seed=0)
    task.prepare(model, data_mesh, recipe(data_mesh, task.layout.seq_len))
    params = list(model.parameters())
    with task.context():
        loss, _ = task.loss_variants["sparse"](model, task.batches(0))
        grads = [torch.zeros_like(p) if x is None else x for x, p in zip(
            torch.autograd.grad(loss, params, allow_unused=True), params)]
    exact = [C.all_reduce_(x.clone(), None) / P for x in grads]
    norm = torch.sqrt(sum((e.float() ** 2).sum() for e in exact))
    for codec in ("int8", "topk"):
        C.reset_bytes()
        out = [tcomp.compressed_psum_int8(x, None, torch.zeros_like(x))
               if codec == "int8" else
               tcomp.compressed_psum_topk(x, None, torch.zeros_like(x))
               for x in grads]
        sent = C.BYTES["all_reduce"]
        err = torch.sqrt(sum(((m - e) ** 2).sum()
                             for (m, _), e in zip(out, exact))) / norm
        kept = torch.sqrt(sum(((m + C.all_reduce_(r.clone(), None) / P - e)
                               ** 2).sum()
                              for (m, r), e in zip(out, exact))) / norm
        res_max = max(r.abs().max().item() for _, r in out)
        i_rec[codec] = {"rel": err.item(), "conserved_rel": kept.item(),
                        "residual_max": res_max, "bytes_sent": sent,
                        "grad_bytes": sum(x.numel() * 4 for x in grads)}
        say(f"(i) {codec} all-reduce of GT's gradients at P={P}: rel "
            f"{err.item():.4g} against the exact mean (int8's tol "
            f"{MESH_COMPRESS_REL}), reduced + mean residual at "
            f"{kept.item():.3g} (tol {MESH_CONSERVED_REL}), max |residual| "
            f"{res_max:.3g}, {sent:,} bytes sent a rank (fp32 wire)")
        if (codec == "int8" and err.item() >= MESH_COMPRESS_REL) or \
                kept.item() > MESH_CONSERVED_REL or res_max <= 0:
            raise AssertionError(f"(i) {codec}: {i_rec[codec]}")
    del task, model, grads, exact, out

    class Stage(torch.nn.Module):
        def __init__(self, layers, cfg):
            super().__init__()
            self.layers = torch.nn.ModuleList(layers)
            self.cfg = cfg

        def forward(self, hh):
            for layer in self.layers:
                hh = tgm._layer(layer, hh, self.cfg, {}, None, True, None)
            return hh

    cfg_p = gt.replace(dtype="float32")
    model = tgm.GraphModel(cfg_p, device=dev, seed=0)
    per = cfg_p.n_layers // P
    stage = Stage(list(model.layers)[rank * per:(rank + 1) * per], cfg_p)
    snames = [n for n, _ in stage.named_parameters()]
    sparams = [p for _, p in stage.named_parameters()]
    gen = torch.Generator(device=dev).manual_seed(44)
    xs = torch.randn(MESH_PIPE_MICRO, GRAPH_BATCH // MESH_PIPE_MICRO,
                     MESH_PIPE_SEQ, cfg_p.d_model, generator=gen,
                     device=dev)
    gxs = torch.randn(xs.shape, generator=gen, device=dev)
    xl = xs.clone().requires_grad_()
    e0, e1 = event_pair()
    e0.record()
    out = pipeline_apply(lambda ps, a: torch.func.functional_call(
        stage, dict(zip(snames, ps)), (a,)), sparams, xl, None)
    got = torch.autograd.grad((out * gxs).sum(), sparams + [xl])
    e1.record()
    xf = xs.clone().requires_grad_()
    hh = Stage(list(model.layers), cfg_p)(xf.flatten(0, 1))
    want = torch.autograd.grad((hh * gxs.flatten(0, 1)).sum(),
                               sparams + [xf])
    torch.cuda.synchronize()
    rels = [_rel(out, hh.view(out.shape))] + [
        _rel(a, b) for a, b in zip(got, want)]
    i_rec["pipeline"] = {"stages": P, "micro": MESH_PIPE_MICRO,
                         "S": MESH_PIPE_SEQ, "out_rel": rels[0],
                         "max_grad_rel": max(rels[1:]),
                         "ms": e0.elapsed_time(e1)}
    say(f"(i) {P}-stage pipeline of GT's fp32 layers, {MESH_PIPE_MICRO} "
        f"microbatches: out rel {rels[0]:.3g}, worst gradient rel "
        f"{max(rels[1:]):.3g} (tol {MESH_PIPE_TOL}) against the "
        f"sequential apply; forward + backward "
        f"{i_rec['pipeline']['ms']:.2f} ms")
    if max(rels) > MESH_PIPE_TOL:
        raise AssertionError(f"(i) pipeline: {i_rec['pipeline']}")
    rec["i"] = i_rec
    del model, stage, out, got, want, hh
    release()
    return rec


def family_runs(rank: int, dev, mesh, say, trainer_steps, tmp,
                read_counts) -> dict:
    """Phase 15's sub-phases (k)-(o), slice 18's paths, on this rank of
    the two sharing card 0 (``mesh``: the (1, GP_P) model mesh). Each of
    (k)-(n) is held to its P = 1 run on rank 0 (the other rank waiting):
    the init step's loss (TOL_LM_STEP_LOSS_REL) and
    every gradient, reduced over the ranks in the Trainer's first step,
    at a cosine of MIN_GRAD_COSINE with the P = 1 one or, as phase 14
    holds its bf16 gradients, by its distance from the fp32 plain path's
    (``held``), and the losses of its FAM_STEPS steps (TOL_STEP_LOSS_REL,
    in the parent); the attention op held to
    ``impl="plain"`` (``op_check``) and rows 2, 5 and 6 counted exactly.
    (k) Mamba2-2.7B at full width, FAM_SSM_LAYERS layers, S=FAM_SSM_SEQ,
    its 80 SSM heads split over the ranks; (l) SeamlessM4T-medium at full
    width, FAM_ENCDEC_LAYERS + FAM_ENCDEC_LAYERS layers, phase 14 (a)'s
    batch, on the cluster-sparse backend (the encoder non-causal under
    Ulysses, the decoder causal); (m) InternVL2-76B at full width, one
    layer, 256 patches + 3840 tokens, int8 moments, the embedding tables'
    gradients left out of the cosines (each 1.05e9 numbers: their P = 1
    copy would not fit beside two ranks); (n) Jamba-v0.1 at phase 13
    (c)'s quarter width in fp32, one period, its MoE slots expert
    parallel at a
    capacity factor of E/k, where no pair drops, as (f)'s first case (at
    the default 1.25 pairs drop on the mesh and never at P = 1, so the
    two compute other functions; (f) and (g) hold that path); (o) an
    expert-parallel
    MoE (Qwen3-235B-A22B smoke with 4 experts, each token routed to all
    4, so nothing drops), each rank holding its 2 experts, checkpointed
    at P = 2 and resumed at P = 2 (bitwise) and at P = 1 (within
    FAM_CKPT_TOL of the unbroken run; two resumes bitwise alike), under
    deterministic algorithms."""
    import functools
    import inspect

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch
    from repro_torch.models import encdec as ted
    from repro_torch.models import hybrid as thyb
    from repro_torch.models import layers as L
    from repro_torch.models import moe as tmoe
    from repro_torch.models.api import SSMLMModel
    from repro_torch.models.lm import LMModel
    from repro_torch.parallel.sharding import recipe_for
    from repro_torch.runtime.trainer import TrainerConfig
    from repro_torch.tasks import BatchFnTask

    P = dist.get_world_size()
    rec = {}

    def held(tag, make, batch_fn, seq, tc, n_attn, op_nths=(),
             skip=lambda name: False, names=UNBIASED_NAMES):
        """``make()`` a model: the P = 1 run on rank 0, then the P = GP_P
        run on ``mesh``; ``skip`` names the gradients left out. Each
        gradient of the P = GP_P run's first step is held to P = 1's at a
        cosine of MIN_GRAD_COSINE or, where P = 1's own bf16 gradient is
        that far from the fp32 one (the plain path in fp32: phase 14's
        referee), by its distance from the fp32 gradient, at most
        FP32_DISTANCE_FACTOR times P = 1's (in 1 - cosine)."""
        want = lambda hist: ({} if not n_attn else  # noqa: E731
                             step_launches(make.cfg, names, len(hist),
                                           n_attn))
        out = {}
        ref = None
        if rank == 0:
            model = make()
            task = BatchFnTask(batch_fn).prepare(model)
            pnames = [n for n, _ in model.named_parameters()]
            keep = [i for i, n in enumerate(pnames) if not skip(n)]
            fn = model.loss_variants["sparse"]
            plain = functools.partial(fn, impl="plain") if "impl" in \
                inspect.signature(fn).parameters else fn
            base = model.cfg
            ref = {}
            for key, dtype, loss_fn in (("grads", base.dtype, fn),
                                        ("fp32", "float32", plain)):
                model.cfg = base.replace(dtype=dtype)
                loss, metrics = loss_fn(model, task.batches(0))
                params = list(model.parameters())
                gs = torch.autograd.grad(loss, [params[i] for i in keep])
                # on the host: the card holds two ranks' runs next
                ref[key] = {pnames[i]: g.reshape(-1).float().cpu()
                            for i, g in zip(keep, gs)}
                ref.setdefault("loss", loss.item())
                # the metrics' graph holds the parameters
                del loss, metrics, gs, params
            model.cfg = base
            ref["p1_fp32"] = {n: F.cosine_similarity(
                g, ref["fp32"][n], dim=0, eps=1e-30).item()
                for n, g in ref["grads"].items()}
            out["p1"] = trainer_steps(f"{tag} P=1", model, task, tc, want,
                                      seq)[0]
            del model, task
            release()
        dist.barrier()
        out["resident_bytes"] = release()
        say(f"{tag} P={P} starts with {out['resident_bytes'] / 2**30:.2f} "
            f"GiB allocated")
        model = make()
        task = BatchFnTask(batch_fn).prepare(model, mesh, recipe_for(
            ShapeConfig("t", "train", seq, 1), mesh))
        with task.context():
            out["op_check"] = [op_check(
                f"{tag} P={P} rank {rank}, attention call {nth}", model,
                model.loss_variants["sparse"], task.batches(0), names,
                read_counts, log_tag="graph-parallel", nth=nth)
                for nth in op_nths]
        cos, cos32 = {}, {}

        def first_grads(tr):
            real = tr._reduce

            def reduce(grads):
                got = real(grads)
                if ref is not None and not cos:
                    for n, g in zip(tr.names, got):
                        if n in ref["grads"]:
                            g = g.reshape(-1).float()
                            cos[n], cos32[n] = (F.cosine_similarity(
                                g, ref[k][n].to(g.device), dim=0,
                                eps=1e-30).item() for k in ("grads", "fp32"))
                return got
            tr._reduce = reduce
        out["run"], tr = trainer_steps(f"{tag} P={P}", model, task, tc,
                                       want, seq, mesh,
                                       on_trainer=first_grads)
        if rank == 0:
            refereed, failed = {}, {}
            for n, c in cos.items():
                if c >= MIN_GRAD_COSINE:
                    continue
                row = {"cos_p1": c, "cos_fp32": cos32[n],
                       "cos_p1_fp32": ref["p1_fp32"][n]}
                ok = 1 - cos32[n] <= FP32_DISTANCE_FACTOR * (
                    1 - ref["p1_fp32"][n])
                (refereed if ok else failed)[n] = row
            worst = min(cos, key=cos.get)
            rel = abs(out["run"]["loss"][0] - ref["loss"]) / abs(ref["loss"])
            out["init"] = {
                "loss": out["run"]["loss"][0], "p1_loss": ref["loss"],
                "loss_rel": rel, "min_grad_cosine": cos[worst],
                "worst": worst, "grads_compared": len(cos),
                "min_cos_fp32": min(cos32.values()),
                "min_cos_p1_fp32": min(ref["p1_fp32"].values()),
                "refereed_by_fp32": refereed, "failed": failed}
            say(f"{tag} init step P={P} vs P=1: loss rel {rel:.3g} (tol "
                f"{TOL_LM_STEP_LOSS_REL}), min gradient cosine "
                f"{cos[worst]:.6f} "
                f"({worst}; min {MIN_GRAD_COSINE}) over {len(cos)} "
                f"gradients; against fp32 plain P=1: min cosine P={P} "
                f"{out['init']['min_cos_fp32']:.6f}, bf16 P=1 "
                f"{out['init']['min_cos_p1_fp32']:.6f}; {len(refereed)} held "
                f"by the fp32 referee {json.dumps(refereed)}")
            if rel > TOL_LM_STEP_LOSS_REL or failed:
                raise AssertionError(f"{tag} at the init: {out['init']}")
        del tr, model, task, ref
        release()
        return out

    def steps_cfg(**kw):
        return TrainerConfig(steps=FAM_STEPS, lr=1e-3, warmup=0,
                             max_bad_steps=0, **kw)

    def on_card(cls, cfg):
        def make(experts=None):
            with L.draw_on_device():
                return cls(cfg, device=dev, seed=0)
        make.cfg = cfg
        return make

    # ------------------------------------------------------------ (k)
    cfg_k = get_config("mamba2_2_7b").replace(n_layers=FAM_SSM_LAYERS)
    dc_k = LMDataConfig(cfg_k.vocab_size, FAM_SSM_SEQ, 1, seed=0)
    rec["k"] = {"layers": FAM_SSM_LAYERS, "S": FAM_SSM_SEQ, **held(
        "(k) mamba2-2.7b", on_card(SSMLMModel, cfg_k),
        lambda s: lm_batch(dc_k, 0), FAM_SSM_SEQ, steps_cfg(), 0)}

    # ------------------------------------------------------------ (l)
    cfg_l = get_config(A10_ENCDEC_ARCH).replace(
        enc_layers=FAM_ENCDEC_LAYERS, n_layers=FAM_ENCDEC_LAYERS,
        attn_backend="cluster_sparse", remat="block")
    B, T, Tf = A10_ENCDEC_BATCH, A10_ENCDEC_TARGET, cfg_l.frontend_tokens
    dc_l = LMDataConfig(cfg_l.vocab_size, T, B, seed=0)
    frames = np.random.default_rng(1000).standard_normal(
        (B, Tf, cfg_l.d_model), dtype=np.float32)
    rec["l"] = {"layers": [FAM_ENCDEC_LAYERS] * 2, "batch": B, "frames": Tf,
                "tokens": T, **held(
                    "(l) seamless-m4t-medium", on_card(ted.EncDecModel,
                                                       cfg_l),
                    lambda s: {**lm_batch(dc_l, 0), "frames": frames}, T,
                    steps_cfg(), 2 * FAM_ENCDEC_LAYERS,
                    op_nths=(0, FAM_ENCDEC_LAYERS))}
    del frames

    # ------------------------------------------------------------ (m)
    cfg_m = get_config(A10_VLM_ARCH).replace(
        n_layers=FAM_VLM_LAYERS, attn_backend="cluster_sparse",
        remat="block")
    Tp = cfg_m.frontend_tokens
    dc_m = LMDataConfig(cfg_m.vocab_size, FAM_VLM_SEQ - Tp, 1, seed=0)
    patches = np.random.default_rng(2000).standard_normal(
        (1, Tp, cfg_m.d_model), dtype=np.float32)
    rec["m"] = {"layers": FAM_VLM_LAYERS, "S": FAM_VLM_SEQ, "patches": Tp,
                **held("(m) internvl2-76b", on_card(LMModel, cfg_m),
                       lambda s: {**lm_batch(dc_m, 0), "patches": patches},
                       FAM_VLM_SEQ, steps_cfg(state_dtype="int8"),
                       FAM_VLM_LAYERS, op_nths=(0,),
                       skip=lambda n: n.startswith("embed."))}
    del patches

    # ------------------------------------------------------------ (n)
    # fp32: in bf16 the split Mamba heads' and the experts' partial
    # products round once more than P = 1's before their sum over the
    # ranks, and a small gradient that cancels (a Mamba slot's a_log, 32
    # numbers) then lands at a cosine of 0.94 with P = 1's (measured on one
    # H100); (k), (f) and (g) run those paths in bf16
    cfg_n = get_config(JAMBA_ARCH).replace(**JAMBA_CUT, dtype="float32",
                                           attn_backend="cluster_sparse")
    dc_n = LMDataConfig(cfg_n.vocab_size, FAM_JAMBA_SEQ, FAM_JAMBA_BATCH,
                        seed=0)
    cf = cfg_n.moe_experts / cfg_n.moe_top_k
    drops = []
    real_ep, real_apply = tmoe._ep_local, thyb.moe_apply

    def counting(*a, **kw):
        got = real_ep(*a, **kw)
        drops.append(tmoe.LAST_CALL["dropped"])
        return got
    tmoe._ep_local = counting
    thyb.moe_apply = functools.partial(real_apply, capacity_factor=cf)
    try:
        rec["n"] = {"cut": JAMBA_CUT, "S": FAM_JAMBA_SEQ,
                    "batch": FAM_JAMBA_BATCH, "capacity_factor": cf, **held(
                        "(n) jamba-v0.1 1/4 width",
                        on_card(thyb.HybridLMModel, cfg_n),
                        lambda s: lm_batch(dc_n, 0), FAM_JAMBA_SEQ,
                        steps_cfg(), cfg_n.n_layers // cfg_n.attn_every,
                        op_nths=(0,), names=UNBIASED_F32_NAMES)}
    finally:
        tmoe._ep_local, thyb.moe_apply = real_ep, real_apply
    rec["n"]["ep_calls"] = len(drops)
    rec["n"]["dropped_pairs"] = int(sum(int(d) for d in drops))
    say(f"(n) {len(drops)} expert-parallel calls at capacity factor {cf} "
        f"dropped {rec['n']['dropped_pairs']} pairs on this rank's experts")
    if not drops or rec["n"]["dropped_pairs"]:
        raise AssertionError(f"(n) expert-parallel calls {len(drops)}, "
                             f"dropped {rec['n']['dropped_pairs']}")
    del drops

    # ------------------------------------------------------------ (o)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        rec["o"] = _ckpt_runs(rank, dev, mesh, say, tmp)
    finally:
        torch.use_deterministic_algorithms(False)
    release()
    return rec


def _ckpt_runs(rank: int, dev, mesh, say, tmp) -> dict:
    """(o): checkpoints of an expert-parallel MoE, fp32 and int8
    moments: saved at step 2 of FAM_CKPT_STEPS at P = GP_P, each rank
    holding its experts, resumed at P = GP_P and at P = 1."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch
    from repro_torch.models.lm import LMModel
    from repro_torch.parallel.sharding import recipe_for
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tasks import BatchFnTask

    P = dist.get_world_size()
    cfg = get_smoke_config(MOE_ARCH).replace(dtype="float32", moe_experts=4,
                                             moe_top_k=4)
    dc = LMDataConfig(cfg.vocab_size, 256, 2, seed=0)

    def run(sd, where, on_mesh):
        kw = {"experts": (rank, P)} if on_mesh else {}
        model = LMModel(cfg, device=dev, seed=0, **kw)
        tr = Trainer(model, TrainerConfig(
            steps=FAM_CKPT_STEPS, lr=1e-3, warmup=1, state_dtype=sd,
            ckpt_dir=str(where), ckpt_every=2, max_bad_steps=0),
            task=BatchFnTask(lambda s: lm_batch(dc, s)),
            **({"mesh": mesh, "recipe": recipe_for(ShapeConfig(
                "t", "train", 256, 2), mesh)} if on_mesh else {}))
        t0 = time.perf_counter()
        assert tr.run() == "done"
        torch.cuda.synchronize()
        return [h["loss"] for h in tr.history], time.perf_counter() - t0

    out = {}
    for sd in ("float32", "int8"):
        d = {k: os.path.join(tmp, f"o_{sd}_{k}") for k in
             ("unbroken", "p2", "p1a", "p1b")}
        unbroken, secs = run(sd, d["unbroken"], True)
        dist.barrier()
        if rank == 0:     # the step-2 generation alone, to resume from
            for k in ("p2", "p1a", "p1b"):
                shutil.copytree(os.path.join(d["unbroken"], "step_00000002"),
                                os.path.join(d[k], "step_00000002"))
        dist.barrier()
        p2 = run(sd, d["p2"], True)[0]
        o = {"unbroken": unbroken, "unbroken_s": secs, "resumed_p2": p2}
        ok = p2 == unbroken[2:]
        if rank == 0:
            p1a, p1b = run(sd, d["p1a"], False)[0], run(sd, d["p1b"],
                                                        False)[0]
            first = abs(p1a[0] - unbroken[2]) / abs(unbroken[2])
            rel = max(abs(a - b) / abs(b) for a, b in zip(p1a, unbroken[2:]))
            o.update(resumed_p1=p1a, resumed_p1_again=p1b,
                     p1_first_rel=first, p1_rel=rel)
            # int8 moments part P = 1 from P = 2 after an update (a second
            # moment rounded to another level): the first loss is held
            ok = ok and p1a == p1b and first <= FAM_CKPT_TOL and (
                sd == "int8" or rel <= FAM_CKPT_TOL)
        say(f"(o) expert-parallel checkpoint, {sd} moments: unbroken "
            f"{unbroken}; resumed at P={P} {p2} (bitwise: "
            f"{p2 == unbroken[2:]})"
            + (f"; resumed at P=1 {o['resumed_p1']} (twice alike: "
               f"{o['resumed_p1'] == o['resumed_p1_again']}), rel "
               f"{o['p1_first_rel']:.3g} first, {o['p1_rel']:.3g} worst "
               f"(tol {FAM_CKPT_TOL})" if rank == 0 else ""))
        if not ok:
            raise AssertionError(f"(o) {sd}: {o}")
        out[sd] = o
    return out


def fallback_runs(rank: int, dev, reset_counts, read_counts) -> dict:
    """Phase 15's (j), on this rank of a (1, GP_FALLBACK_P) model mesh of
    its own over gloo, every rank on ``dev``: GT graph-level at full
    width on (d)'s 128 graphs of S=128 at 16 x 16 blocks, whose 8 heads
    (and 128 tokens) do not split 3 ways: every rank runs the unsharded
    op on the whole sequence (the reference's GSPMD fallback), held to
    the P = 1 run on rank 0 as (d) is; the attention op held to
    ``impl="plain"``; rows 1, 3 and 4 counted exactly."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tasks import GraphLevelTask, synthetic_graph_level_dataset

    P = dist.get_world_size()
    mesh = make_host_mesh(model=P)
    store = {}

    def say(msg):
        log(f"[graph-parallel] rank {rank}: {msg}")

    trainer_steps, grads_at_init = _gp_tools(say, reset_counts, read_counts,
                                             store)
    gt = get_config("gt")
    t0 = time.perf_counter()
    task = GraphLevelTask(synthetic_graph_level_dataset(GRAPH_BATCH, gt,
                                                        seed=1), gt,
                          batch_graphs=GRAPH_BATCH, device=dev)
    prep_s = time.perf_counter() - t0
    seq = task.layout.seq_len
    out = {"rank": rank, "j": {
        "graphs": GRAPH_BATCH, "S": seq, "bq": task.layout.bq, "P": P,
        "prep_s": prep_s, **_gt_held_to_p1(
            "(j) gt graph-level, fallback", task, B16_NAMES, seq,
            (("model", mesh),), rank=rank, dev=dev, say=say,
            trainer_steps=trainer_steps, grads_at_init=grads_at_init,
            read_counts=read_counts,
            # every rank holds the whole sequence and backpropagates 1/3
            # of the loss in bf16, which rounds otherwise than the whole
            # (a factor that is no power of 2): phase 5's step gate
            min_cosine=MIN_GRAD_COSINE)}}
    return out


GP_GATE_TIMEOUT = 1800.0     # seconds a rank waits for its phase's turn


def _await_gate(gate: str) -> None:
    """In a rank of phase 15, started ahead of the phase's turn: wait for
    the file ``gate`` (the turn) or ``gate + ".stop"`` (no turn: leave)."""
    t0 = time.perf_counter()
    while not os.path.exists(gate):
        if os.path.exists(gate + ".stop") or \
                time.perf_counter() - t0 > GP_GATE_TIMEOUT:
            raise SystemExit(3)
        time.sleep(0.02)


def _gp_rank(rank, world, tmp, out_dir, which="main", gate=None):
    """A spawned rank of phase 15 (``graph_parallel_phase``): its runs on
    phase 15's two ranks (``gp_runs``) or, ``which="fallback"``, (j) on
    GP_FALLBACK_P ranks (``fallback_runs``). With ``gate``, it imports
    torch and the port, initialises CUDA and joins its world, then waits
    for the phase's turn (``_await_gate``)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.mesh import init_distributed

    init_distributed("gloo", rank, world, f"file://{tmp}/rdzv")
    import torch.distributed as dist
    try:
        if gate is not None:
            torch.cuda.init()
            _await_gate(gate)
        reset_counts, read_counts = kernel_counters()
        dev = torch.device("cuda", 0)
        rec = (gp_runs(rank, dev, reset_counts, read_counts, tmp)
               if which == "main" else
               fallback_runs(rank, dev, reset_counts, read_counts))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(rec, fh)
    finally:
        dist.destroy_process_group()


def graph_parallel_phase(out_path: str) -> int:
    """Phase 15, in a child process: GP_P ranks spawned on card 0 over
    gloo (``gp_runs``); every rank's record, and the checks across ranks
    (each rank's losses of (b) and (c) held to rank 0's P = 1 run), to
    ``out_path`` as JSON. Fails when any rank fails."""
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke phase 15: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.multiprocessing as mp

    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import cluster_attention as tca
    from repro_torch.kernels import cluster_attention_bwd as tcab

    # two ranks' allocators share the card: (g) holds ~36 GiB a rank (set
    # before this process initialises CUDA, as the ranks inherit it)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    # both worlds at once: (j)'s three ranks are small (under a GiB
    # each) and done within (a)-(c), so they take no wall of their own.
    # The ranks start ahead of the phase's turn, their start-up (imports,
    # CUDA, the worlds' rendezvous) overlapping the phase before, and wait
    # for the gate file this process writes at its turn
    ranks, fallback = [], []
    worlds = (("main", GP_P, ranks), ("fallback", GP_FALLBACK_P, fallback))
    with tempfile.TemporaryDirectory() as tmp:
        gate = os.path.join(tmp, "turn")
        running = []
        for which, world, got in worlds:
            d = os.path.join(tmp, which)
            os.makedirs(d)
            running.append((which, world, got, d, mp.spawn(
                _gp_rank, args=(world, d, d, which, gate), nprocs=world,
                join=False)))
        try:
            await_turn(torch)
        except SystemExit:      # no turn: the ranks leave, then this
            open(gate + ".stop", "w").close()
            for *_, ctx in running:
                for proc in ctx.processes:
                    proc.join(60)
            raise
        t_start = time.perf_counter()
        # built before the ranks' turn, so that they only load the
        # libraries
        kbuild.build_all((tca.LIBRARY_SM90, tcab.LIBRARY_DQ_SM90,
                          tcab.LIBRARY_DKV_SM90, tca.LIBRARY_UNBIASED_SM90,
                          tcab.LIBRARY_UNBIASED_SM90, tca.LIBRARY_UNBIASED,
                          tcab.LIBRARY_UNBIASED))
        t0 = time.perf_counter()
        open(gate, "w").close()
        for which, world, got, d, ctx in reversed(running):   # (j) first
            while not ctx.join():
                pass
            log(f"[graph-parallel] {which} ranks ({world}): "
                f"{time.perf_counter() - t0:.1f} s")
            for r in range(world):
                with open(os.path.join(d, f"rank{r}.json")) as fh:
                    got.append(json.load(fh))
    # every run held to rank 0's P = 1 run: (b), (c), and slice 17's
    # (d) on the data and the model mesh and (e) on the model mesh
    held = (("b", "run", TOL_STEP_LOSS_REL), ("c", "run",
                                             TOL_LM_STEP_LOSS_REL),
            ("d", "data", TOL_STEP_LOSS_REL), ("d", "model",
                                               TOL_STEP_LOSS_REL),
            ("e", "model", TOL_STEP_LOSS_REL),
            # slice 18's: (j) on its own three ranks, (k)-(n) on these two
            ("j", "model", TOL_STEP_LOSS_REL),
            ("k", "run", TOL_STEP_LOSS_REL), ("l", "run", TOL_STEP_LOSS_REL),
            ("m", "run", TOL_STEP_LOSS_REL), ("n", "run", TOL_STEP_LOSS_REL))
    for r in ranks + fallback:
        for part, run, tol in held:
            if part not in r:
                continue
            ref_ = (fallback if part == "j" else ranks)[0][part]["p1"]
            got = r[part][run]["loss"]
            rel = [abs(x - y) / abs(y) for x, y in zip(got, ref_["loss"])]
            r[part][f"{run}_loss_rel_vs_p1"] = rel
            log(f"[graph-parallel] ({part}) {run} rank {r['rank']}: losses "
                f"{got} vs P=1 {ref_['loss']}, rel {rel} (tol {tol})")
            if len(got) != len(ref_["loss"]) or max(rel) > tol:
                raise AssertionError(f"phase 15 ({part}) rank {r['rank']}: "
                                     f"losses {got} vs P=1 {ref_['loss']}")
    launches = {}
    for r in ranks + fallback:
        for part, run in (("b", "run"), ("c", "run"), ("d", "data"),
                          ("d", "model"), ("e", "model"), ("g", "run"),
                          ("j", "model"), ("k", "run"), ("l", "run"),
                          ("m", "run"), ("n", "run")):
            if part in r:
                for n, c in r[part][run]["launches"].items():
                    launches[n] = launches.get(n, 0) + c
    rec = {"ranks": ranks, "fallback_ranks": fallback, "launches": launches,
           "seconds": time.perf_counter() - t_start}
    with open(out_path, "w") as fh:
        json.dump(rec, fh)
    log(f"[graph-parallel] {rec['seconds']:.1f}s, launches over the ranks "
        f"{ {k: c for k, c in launches.items() if c} }")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA device only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.graph import sbm_graph
    from repro_torch.core.graph_model import (GraphModel, graph_forward,
                                              graph_predict)
    from repro_torch.core.reformation import (build_layout,
                                              lm_local_global_layout,
                                              transpose_block_idx)
    from repro_torch.data.graph_pipeline import (prepare_graph_task,
                                                 prepare_node_task)
    from repro_torch.data.lm_pipeline import LMDataConfig, lm_batch
    from repro_torch.core.graph_model import graph_loss
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import cluster_attention as tca
    from repro_torch.kernels import cluster_attention_bwd as tcab
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd as tks
    from repro_torch.launch.serve import degree_scaled_sbm
    from repro_torch.models.lm import LMModel, lm_loss
    from repro_torch.runtime.trainer import (Trainer, TrainerConfig,
                                             host_copy)
    from repro_torch.serve import GraphServe
    from repro_torch.tasks import (BatchFnTask, GraphLevelTask, LinkTask,
                                   NodeTask, link_loss,
                                   synthetic_graph_level_dataset)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ------------------------------------------------------------ 1. card
    log(f"[phase] 1 starts at {time.perf_counter() - t_start:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {kind} "
        f"count {torch.cuda.device_count()}")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    log(f"{n_sm} SMs, max SM clock {sm_mhz:.0f} MHz")

    # ----------------------------------------------------------- 2. build
    log(f"[phase] 2 starts at {time.perf_counter() - t_start:.1f} s")
    libs = (tca.LIBRARY, tcab.LIBRARY, tca.LIBRARY_SM90,
            tcab.LIBRARY_DQ_SM90, tcab.LIBRARY_DKV_SM90, tca.LIBRARY_UNBIASED,
            tca.LIBRARY_UNBIASED_SM90, tcab.LIBRARY_UNBIASED,
            tcab.LIBRARY_UNBIASED_SM90, tfa.LIBRARY, tfa.LIBRARY_BWD,
            tfa.LIBRARY_SM90, tfa.LIBRARY_DQ_SM90, tfa.LIBRARY_DKV_SM90,
            tks.LIBRARY)
    t0 = time.perf_counter()
    kbuild.build_all(libs)
    log(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.2f}s")
    for lib in libs:
        log(f"[build] {os.path.relpath(lib.path(), ROOT)} "
            f"({lib.seconds:.2f}s of nvcc)")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build]   {line.strip()}")

    # phase 9c's host draws (seconds of numpy), on a thread beside the
    # device-bound kernel checks of phase 3 (beside the build they slowed
    # nvcc, which has the host's cores)
    from concurrent.futures import ThreadPoolExecutor
    draw_pool = ThreadPoolExecutor(1)
    scale_future = draw_pool.submit(scale_draws)

    # -------------------------------------------- 3. kernels vs plain
    log(f"[phase] 3 starts at {time.perf_counter() - t_start:.1f} s")
    def bound(q, k, v, block_idx, buckets, with_lse=False):
        """Least time the card could take: each input read once (only the
        bucket tiles the layout visits), each output written once, and
        the score + PV arithmetic of the visited blocks at the peak rate
        of q's dtype. Returns (ms, "bytes" | "operations")."""
        B, S, H, Dh = q.shape
        nq = block_idx.shape[-2]
        bq, bk = S // nq, buckets.shape[-1]
        active = int((block_idx >= 0).sum()) * (
            B if block_idx.dim() == 2 else 1)
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) \
            * q.element_size() + active * bq * bk \
            + block_idx.numel() * 4 + (B * H * S * 4 if with_lse else 0)
        flops = 4.0 * active * bq * bk * Dh * H
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[1]] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    def exp_floor(q, block_idx, buckets):
        """Least time of one exp2 per score and head of the visited blocks
        at EX2_PER_CLOCK_PER_SM a clock on every SM, at the card's max SM
        clock: the floor under the biased kernels' softmax, beside the
        bytes and operations bound."""
        B, S, H_ = q.shape[:3]
        bq, bk = S // block_idx.shape[-2], buckets.shape[-1]
        active = int((block_idx >= 0).sum()) * (
            B if block_idx.dim() == 2 else 1)
        return active * bq * bk * H_ / (
            EX2_PER_CLOCK_PER_SM * n_sm * sm_mhz * 1e6) * 1e3

    def fwd_counts():
        return tca.launches, tca.sm90_launches, tca.sm90_b16_launches

    def bwd_counts():
        return (tcab.dq_launches, tcab.dq_sm90_launches,
                tcab.dq_sm90_b16_launches, tcab.dkv_launches,
                tcab.dkv_sm90_launches, tcab.dkv_sm90_b16_launches)

    def one_kernel(q, bu):
        """Which of a biased kernel's counters (fp32, bf16 at 32 x 32,
        bf16 at 16 x 16) one launch on these operands adds to."""
        sm90 = q.dtype == torch.bfloat16
        b16 = sm90 and bu.shape[-1] == 16
        return (int(not sm90), int(sm90 and not b16), int(b16))

    def compare(tag, q, k, v, bi, bu, bias):
        """Kernel vs plain on identical inputs, O and lse; bf16 must run
        the tensor-core forward of its block size, fp32 the CUDA-core
        one. Returns the max abs error of O."""
        dt = str(q.dtype).split(".")[1]
        before = fwd_counts()
        o, lse = ops.cluster_attention(q, k, v, bi, bu, bias,
                                       return_lse=True)
        po, plse = ops.cluster_attention(q, k, v, bi, bu, bias,
                                         return_lse=True, impl="plain")
        torch.cuda.synchronize()
        want = tuple(a + b for a, b in zip(before, one_kernel(q, bu)))
        if fwd_counts() != want:
            raise AssertionError(f"{tag} {dt}: forward launches "
                                 f"{fwd_counts()} from {before}, want "
                                 f"{want}")
        err = (o.float() - po.float()).abs().max().item()
        lerr = (lse - plse).abs().max().item()
        ok = torch.allclose(o.float(), po.float(), atol=TOL_O[dt],
                            rtol=TOL_O[dt]) and torch.allclose(
            lse, plse, atol=TOL_LSE, rtol=1e-5)
        log(f"[kernel] {tag} {dt}: max|dO|={err:.3g} (tol {TOL_O[dt]}) "
            f"max|dlse|={lerr:.3g} (tol {TOL_LSE}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not (ok and torch.isfinite(o).all()):
            raise AssertionError(f"cluster attention kernel disagrees with "
                                 f"its plain version: {tag} {dt}")
        return err

    def random_qkv(B, S, H, KV, Dh, nb, dtype, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randn(B, S, H, Dh, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, KV, Dh, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, KV, Dh, generator=gen, device=dev).to(dtype)
        bias = torch.randn(H, nb, generator=gen, device=dev) * 0.5
        return q, k, v, bias

    def to_dev(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    def bound_bwd(kind, q, k, bi, bu, bit, nb):
        """Least time of one backward kernel: each input read once (only
        the visited bucket tiles), each output written once, and the
        recompute + gradient arithmetic of the visited blocks at the peak
        rate of q's dtype. dQ: q, k, v, dO, lse, delta, block_idx and the
        tiles in; dq and the (B, H, nq, nb) bucket partials out; s, dp and
        dq products (6 flop per entry per Dh). dK/dV: q, k, v, dO, lse,
        delta, block_idx_t and the tiles in; per-q-head dk and dv out; s,
        dp, dv and dk products (8). Returns (ms, "bytes" | "operations")."""
        B, S, H, Dh = q.shape
        nq = bi.shape[-2]
        bq, bk = S // nq, bu.shape[-1]
        active = int((bi >= 0).sum()) * (B if bi.dim() == 2 else 1)
        elt = q.element_size()
        n_in = (2 * q.numel() + 2 * k.numel()) * elt + 2 * B * H * S * 4 \
            + active * bq * bk
        if kind == "dq":
            n_bytes = n_in + bi.numel() * 4 + q.numel() * elt \
                + B * H * nq * nb * 4
            flops = 6.0 * active * bq * bk * Dh * H
        else:
            n_bytes = n_in + bit.numel() * 4 + 2 * q.numel() * elt
            flops = 8.0 * active * bq * bk * Dh * H
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[1]] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    def bwd_inputs(q, k, v, bi, bu, bias, seed):
        """The forward kernel's O and lse and a random dO: the inputs
        both backwards take."""
        out, lse = tca.cluster_attention_fwd(q, k, v, bi, bu, bias,
                                             return_lse=True)
        gen = torch.Generator(device=dev).manual_seed(seed)
        dout = torch.randn(out.shape, generator=gen, device=dev).to(q.dtype)
        return out, lse, dout

    def compare_bwd(tag, q, k, v, bi, bu, bias, bit, seed=0):
        """Backward kernels vs the plain backward on identical inputs:
        dq, dk, dv and dbias, each as max|diff| over max|plain|; returns
        the max abs errors of (dq, max of dk and dv). Where every bucket
        is equal, or the table has one column (every bucket clips onto
        it), softmax cancels the bias, so dbias is zero up to rounding: it
        must then be below TOL_GRAD in absolute value."""
        uniform = bias.shape[1] == 1 or bool((bu == bu.flatten()[0]).all())
        dt = str(q.dtype).split(".")[1]
        out, lse, dout = bwd_inputs(q, k, v, bi, bu, bias, seed)
        before = bwd_counts()
        got = tcab.cluster_attention_bwd(q, k, v, dout, out, lse, bi, bu,
                                         bias, bit)
        want = ref.cluster_attention_bwd(q, k, v, dout, out, lse, bi, bu,
                                         bias, bit)
        torch.cuda.synchronize()
        # dQ and dK/dV on the tensor cores in bf16 (the instantiation of
        # the block size), on CUDA cores in fp32
        want_n = tuple(a + b for a, b in zip(before, 2 * one_kernel(q, bu)))
        if bwd_counts() != want_n:
            raise AssertionError(f"{tag} {dt}: backward launches "
                                 f"{bwd_counts()} from {before}, want "
                                 f"{want_n}")
        rels, errs = [], []
        for i, (x, y) in enumerate(zip(got, want)):
            d = (x.float() - y.float()).abs().max().item()
            errs.append(d)
            den = 1.0 if uniform and i == 3 else y.float().abs().max().item()
            rels.append(d / max(den, 1e-30))
        ok = all(r <= TOL_GRAD[dt] for r in rels) and all(
            torch.isfinite(x).all() for x in got)
        log(f"[bwd] {tag} {dt}{'' if bit is not None else ', derived layout'}"
            f": rel dq {rels[0]:.3g} dk {rels[1]:.3g} dv {rels[2]:.3g} "
            f"dbias {rels[3]:.3g} (tol {TOL_GRAD[dt]}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"backward kernels disagree with the plain "
                                 f"backward: {tag} {dt}")
        return errs[0], max(errs[1], errs[2])

    def compare_op(tag, q, k, v, bi, bu, bias, bit, seed):
        """``ops.cluster_attention`` forward and autograd backward, kernels
        vs ``impl="plain"``, on identical inputs and a random dO: O within
        TOL_O, then dq, dk, dv and dbias as max|diff| over max|plain|
        within TOL_GRAD; returns the max abs error over the gradients."""
        dt = str(q.dtype).split(".")[1]
        gen = torch.Generator(device=dev).manual_seed(seed)
        dout = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        res = []
        for impl in (None, "plain"):
            leaves = [x.detach().requires_grad_() for x in (q, k, v, bias)]
            o = ops.cluster_attention(*leaves[:3], bi, bu, leaves[3], bit,
                                      impl=impl)
            res.append((o.detach(), *torch.autograd.grad(o, leaves, dout)))
            del o, leaves
        torch.cuda.synchronize()
        (o, *got), (po, *want) = res
        o_ok = torch.allclose(o.float(), po.float(), atol=TOL_O[dt],
                              rtol=TOL_O[dt])
        rels, errs = [], []
        for x, y in zip(got, want):
            d = (x.float() - y.float()).abs().max().item()
            errs.append(d)
            rels.append(d / max(y.float().abs().max().item(), 1e-30))
        ok = o_ok and all(r <= TOL_GRAD[dt] for r in rels) and all(
            torch.isfinite(x).all() for x in (o, *got))
        log(f"[bwd] {tag} {dt}, op forward + autograd: max|dO|="
            f"{(o.float() - po.float()).abs().max().item():.3g} (tol "
            f"{TOL_O[dt]}); rel dq {rels[0]:.3g} dk {rels[1]:.3g} dv "
            f"{rels[2]:.3g} dbias {rels[3]:.3g} (tol {TOL_GRAD[dt]}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"the op's kernels disagree with its plain "
                                 f"versions: {tag} {dt}")
        return max(errs)

    def schedule_check(tag, q, k, v, bi, bu, bias, bit, seed, timed=False):
        """Rows 1, 3 and 4 under each (``hoist_scale``, ``fuse_bias``) of
        the cluster op's schedule: the forward kernel against the plain
        forward under the same flags (O within TOL_O, lse within TOL_LSE),
        then the dQ and dK/dV kernels against the plain backward on the
        kernel's O and lse and a random dO (dq, dk, dv, dbias as max|diff|
        over max|plain| within TOL_GRAD); each launch on its own counter.
        With ``timed`` each kernel is also timed under each flag pair.
        Returns ``{"hoist=..,fuse=..": record}``."""
        dt = str(q.dtype).split(".")[1]
        gen = torch.Generator(device=dev).manual_seed(seed)
        dout = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        out = {}
        for hoist in (False, True):
            for fuse in (False, True):
                fl = dict(hoist_scale=hoist, fuse_bias=fuse)
                before = fwd_counts() + bwd_counts()
                o, lse = tca.cluster_attention_fwd(q, k, v, bi, bu, bias,
                                                   return_lse=True, **fl)
                got = tcab.cluster_attention_bwd(q, k, v, dout, o, lse, bi,
                                                 bu, bias, bit, **fl)
                one = one_kernel(q, bu)
                want_n = tuple(a + b for a, b in zip(before, one + 2 * one))
                if fwd_counts() + bwd_counts() != want_n:
                    raise AssertionError(f"{tag} {dt} {fl}: launches "
                                         f"{fwd_counts() + bwd_counts()} "
                                         f"from {before}")
                po, plse = ref.cluster_sparse_attention(
                    q, k, v, bi, bu, bias, return_lse=True, **fl)
                want = ref.cluster_attention_bwd(q, k, v, dout, o, lse, bi,
                                                 bu, bias, bit, **fl)
                torch.cuda.synchronize()
                r = {"max_abs_err": (o.float() - po.float()).abs().max()
                     .item(),
                     "max_abs_err_lse": (lse - plse).abs().max().item()}
                rels = [((x.float() - y.float()).abs().max()
                         / y.float().abs().max().clamp_min(1e-30)).item()
                        for x, y in zip(got, want)]
                r.update(zip(("rel_dq", "rel_dk", "rel_dv", "rel_dbias"),
                             rels))
                ok = torch.allclose(o.float(), po.float(), atol=TOL_O[dt],
                                    rtol=TOL_O[dt]) and torch.allclose(
                    lse, plse, atol=TOL_LSE, rtol=1e-5) and all(
                    x <= TOL_GRAD[dt] for x in rels) and all(
                    bool(torch.isfinite(x).all()) for x in (o, *got))
                if timed:
                    delta = ref.row_delta(dout, o)
                    bias_op = ref.extend_bias_table(bias) if fuse \
                        else bias.float().contiguous()
                    r["ms"] = cuda_ms(lambda: tca.cluster_attention_fwd(
                        q, k, v, bi, bu, bias, return_lse=True, **fl), 10)
                    r["dq_ms"] = cuda_ms(lambda: tcab.dq_kernel(
                        q, k, v, dout, lse, delta, bi, bu, bias_op, **fl),
                        10)
                    r["dkv_ms"] = cuda_ms(lambda: tcab.dkv_kernel(
                        q, k, v, dout, lse, delta, bi, bit, bu, bias_op,
                        **fl), 10)
                    del delta, bias_op
                log(f"[schedule] {tag} {dt} hoist_scale={hoist} "
                    f"fuse_bias={fuse}: max|dO|={r['max_abs_err']:.3g} "
                    f"(tol {TOL_O[dt]}) max|dlse|={r['max_abs_err_lse']:.3g}"
                    f"; rel dq {rels[0]:.3g} dk {rels[1]:.3g} dv "
                    f"{rels[2]:.3g} dbias {rels[3]:.3g} (tol "
                    f"{TOL_GRAD[dt]})" + (
                        f"; kernels fwd {r['ms']:.4f} dq {r['dq_ms']:.4f} "
                        f"dkv {r['dkv_ms']:.4f} ms" if timed else "")
                    + f" {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    raise AssertionError(f"the biased kernels disagree with "
                                         f"their plain versions under "
                                         f"{fl}: {tag} {dt}")
                out[f"hoist={hoist},fuse={fuse}"] = r
                del o, lse, got, po, plse, want
        del dout
        torch.cuda.empty_cache()
        return out

    large = get_config("graphormer_large")
    slim = get_config("graphormer_slim")
    H, KV, Dh = large.n_heads, large.kv_heads, large.head_dim

    g = degree_scaled_sbm(SERVE_NODES, CLUSTERS, large, seed=0)
    prep = prepare_node_task(g, large, bq=32, bk=32, d_b=8)
    lay = prep.layout
    bi, bu = to_dev(prep.batch["block_idx"]), to_dev(prep.batch["buckets"])
    log(f"[kernel] serve layout: {g.n} nodes, {g.e} edges, S={lay.seq_len} "
        f"nq={lay.nq} mb={lay.mb} active={lay.stats['active_blocks']} "
        f"density={lay.stats['density']:.5f} "
        f"row visits min/mean/max="
        f"{(lay.block_idx >= 0).sum(1).min()}/"
        f"{(lay.block_idx >= 0).sum(1).mean():.1f}/"
        f"{(lay.block_idx >= 0).sum(1).max()}")
    bit = to_dev(lay.block_idx_t)
    col_visits = (lay.block_idx_t[..., 0] >= 0).sum(1)
    log(f"[bwd] serve transposed layout: nk={lay.block_idx_t.shape[0]} "
        f"mt={lay.mt} column visits min/mean/max={col_visits.min()}/"
        f"{col_visits.mean():.1f}/{col_visits.max()}")

    def dq_whole(q, k, v, dout, lse, delta, bi_, bu_, bias):
        """The bf16 dQ library called with no plan, every row whole: what
        the heavy rows cost uncut (a diagnostic; no path launches it so,
        and it adds nothing to the launch counts)."""
        B, S, H, Dh = q.shape
        nq, mb = bi_.shape[-2:]
        dq = torch.empty_like(q)
        db_part = torch.empty((B, H, nq, bias.shape[1]),
                              dtype=torch.float32, device=q.device)
        err = tcab.LIBRARY_DQ_SM90.lib().cluster_attention_bwd_dq_sm90(
            *(t.data_ptr() for t in (q, k, v, dout, lse, delta, bi_, bu_,
                                     bias)), None, None, dq.data_ptr(),
            db_part.data_ptr(), None, None, B, S, H, k.shape[2], Dh, nq, mb,
            S // nq, bu_.shape[-1], bias.shape[1], int(bi_.dim() == 3), 0,
            0, 0, Dh ** -0.5, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"unsplit bf16 dQ launch failed: CUDA error "
                               f"{err}")

    def dq_heavy_row(q, k, v, dout, lse, delta, bi_, bu_, bias):
        """The bf16 dQ kernel as the path runs it (heavy rows split) beside
        the same library with every row whole (``dq_whole``,
        ``ms_unsplit``) and the kernel with the layout's heaviest row cut
        to its first visit (``ms_without_heavy_row``: what the other rows
        cost alone), CUDA events, 10 launches each."""
        plan = tca.fwd_plan(bi_, q.shape[0])
        visits = (bi_ >= 0).sum(-1).reshape(-1)
        row = int(visits.argmax())
        trim = bi_.clone().reshape(-1, bi_.shape[-1])
        cut = torch.nonzero(trim[row] >= 0).flatten()[1:]
        trim[row, cut] = -1
        trim = trim.reshape(bi_.shape)
        rec = {
            "ms": cuda_ms(lambda: tcab.dq_kernel(
                q, k, v, dout, lse, delta, bi_, bu_, bias), 10),
            "ms_unsplit": cuda_ms(lambda: dq_whole(
                q, k, v, dout, lse, delta, bi_, bu_, bias), 10),
            "ms_without_heavy_row": cuda_ms(lambda: tcab.dq_kernel(
                q, k, v, dout, lse, delta, trim, bu_, bias), 10),
            "heavy_row_visits": int(visits[row]),
            "mean_row_visits": float(visits.float().mean()),
            "split": None if plan is None else {
                "pieces": len(plan[0]), "rows": len(plan[1]),
                "slots": plan[2]}}
        rec["heavy_row_share_unsplit"] = 1 - rec["ms_without_heavy_row"] \
            / rec["ms_unsplit"]
        rec["heavy_row_share"] = 1 - rec["ms_without_heavy_row"] / rec["ms"]
        return rec

    def bwd_serve(q, k, v, bias, dt):
        """Backward kernels vs plain at the serve shape: agreement, then
        each kernel and each plain half timed alone on the same inputs."""
        err_dq, err_dkv = compare_bwd("serve shape", q, k, v, bi, bu, bias,
                                      bit, seed=3)
        out, lse, dout = bwd_inputs(q, k, v, bi, bu, bias, seed=3)
        delta = ref.row_delta(dout, out)
        rec = {"dq": {"max_abs_err": err_dq}, "dkv": {"max_abs_err": err_dkv}}
        runs = {
            "dq": (lambda: tcab.dq_kernel(q, k, v, dout, lse, delta, bi, bu,
                                          bias),
                   lambda: ref.bwd_dq(q, k, v, dout, lse, delta, bi, bu,
                                      bias)),
            "dkv": (lambda: tcab.dkv_kernel(q, k, v, dout, lse, delta, bi,
                                            bit, bu, bias),
                    lambda: ref.bwd_dkv(q, k, v, dout, lse, delta, bi, bit,
                                        bu, bias))}
        for kind, (kern, plain) in runs.items():
            r = rec[kind]
            r["ms"] = cuda_ms(kern, 10)
            r["plain_ms"] = cuda_ms(plain, 3)
            r["bound_ms"], r["bound_by"] = bound_bwd(kind, q, k, bi, bu, bit,
                                                     bias.shape[1])
            r["exp_floor_ms"] = exp_floor(q, bi, bu)
            log(f"[bwd] serve shape {dt} {kind}: kernel {r['ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.2%} of bound, "
                f"exp floor {r['exp_floor_ms']:.4f} ms")
        if dt == "bfloat16":
            # diagnostics: the heavy dQ row and dK/dV column cut away
            heavy = dq_heavy_row(q, k, v, dout, lse, delta, bi, bu, bias)
            rec["dq"]["heavy_row"] = heavy
            rec["dq"]["ms_without_heavy_row"] = heavy["ms_without_heavy_row"]
            trim_t = bit.clone()
            trim_t[0, 1:] = -1
            rec["dkv"]["ms_without_global_column"] = cuda_ms(
                lambda: tcab.dkv_kernel(q, k, v, dout, lse, delta, bi,
                                        trim_t, bu, bias), 10)
            log(f"[bwd] serve shape {dt} dq: split {heavy['ms']:.4f} ms "
                f"({heavy['split']}), unsplit {heavy['ms_unsplit']:.4f} ms, "
                f"heavy row ({heavy['heavy_row_visits']} visits, mean "
                f"{heavy['mean_row_visits']:.1f}) cut to one visit "
                f"{heavy['ms_without_heavy_row']:.4f} ms: the row costs "
                f"{heavy['heavy_row_share']:.1%} split, "
                f"{heavy['heavy_row_share_unsplit']:.1%} unsplit; dkv heavy "
                f"column cut to one slot "
                f"{rec['dkv']['ms_without_global_column']:.4f} ms")
        del out, lse, dout, delta
        torch.cuda.empty_cache()
        return rec

    serve_rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[1]
        q, k, v, bias = random_qkv(1, lay.seq_len, H, KV, Dh,
                                   lay.n_buckets, dtype, seed=1)
        err = compare("serve shape", q, k, v, bi, bu, bias)
        ms = cuda_ms(lambda: ops.cluster_attention(q, k, v, bi, bu, bias),
                     20)
        plain_ms = cuda_ms(lambda: ops.cluster_attention(
            q, k, v, bi, bu, bias, impl="plain"), 5)
        # the plain forward without the default schedule's row chunking,
        # the op's plain path before it resolved a schedule
        unchunked_ms = cuda_ms(lambda: ref.cluster_sparse_attention(
            q, k, v, bi, bu, bias), 5)
        bms, by = bound(q, k, v, bi, bu)
        efl = exp_floor(q, bi, bu)
        log(f"[kernel] serve shape {dt}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms (without row chunks {unchunked_ms:.4f} ms), "
            f"bound {bms:.4f} ms ({by}), {bms / ms:.1%} of bound, exp floor "
            f"{efl:.4f} ms")
        serve_rec[dt] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "plain_unchunked_ms": unchunked_ms,
                         "bound_ms": bms, "bound_by": by,
                         "exp_floor_ms": efl}
        if dtype == torch.bfloat16:
            plan = tca.fwd_plan(bi, 1)
            serve_rec[dt]["split"] = None if plan is None else {
                "pieces": len(plan[0]), "rows": len(plan[1]),
                "slots": plan[2]}
            log(f"[kernel] serve shape {dt}: split grid "
                f"{serve_rec[dt]['split']} (rows above "
                f"max({tca.SPLIT_MIN_PIECE}, {tca.SPLIT_MEAN_FACTOR} x the "
                f"mean) visits cut into pieces)")
            # diagnostic: the same layout with the global token's q-block
            # row cut to one slot — what the other 1024 rows cost alone
            trim = bi.clone()
            trim[0, 0, 1:] = -1
            serve_rec[dt]["ms_without_global_row"] = cuda_ms(
                lambda: ops.cluster_attention(q, k, v, trim, bu, bias), 20)
            log(f"[kernel] serve shape {dt}, global row cut to one slot: "
                f"kernel {serve_rec[dt]['ms_without_global_row']:.4f} ms")
        # 3b. the backward kernels at the serve shape, with the host-built
        # transposed layout the training path threads through
        serve_rec[dt]["bwd"] = bwd_serve(q, k, v, bias, dt)
        # the schedule's rewrites on rows 1, 3, 4 (fp32 timed under each)
        serve_rec[dt]["schedules"] = schedule_check(
            "serve shape", q, k, v, bi, bu, bias, bit, seed=4,
            timed=dtype == torch.float32)
        del q, k, v
    torch.cuda.empty_cache()

    small = build_layout(
        degree_scaled_sbm(1000, 8, large, seed=3), bq=32, bk=32,
        k_clusters=8, d_b=8)
    S = small.seq_len
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        cases += [
            ("GQA H=8 KV=2 Dh=24, shared 2-D layout, B=2", dtype, 2, S,
             8, 2, 24, small.block_idx, small.buckets),
            ("Dh=8 H=8, shared 2-D layout", dtype, 1, S, 8, 8, 8,
             small.block_idx, small.buckets)]
    # per-graph 3-D layouts: two graphs padded to one mb
    lays = [build_layout(degree_scaled_sbm(1000, 8, large, seed=s), bq=32,
                         bk=32, k_clusters=8, d_b=8) for s in (4, 5)]
    mb = max(x.mb for x in lays)
    bi3 = np.stack([np.pad(x.block_idx, ((0, 0), (0, mb - x.mb)),
                           constant_values=-1) for x in lays])
    bu3 = np.stack([np.pad(x.buckets, ((0, 0), (0, mb - x.mb), (0, 0),
                                       (0, 0)), constant_values=-1)
                    for x in lays])
    cases.append(("per-graph 3-D layouts, B=2, GQA H=4 KV=2 Dh=24",
                  torch.bfloat16, 2, lays[0].seq_len, 4, 2, 24, bi3, bu3))
    dead_bi, dead_bu = small.block_idx.copy(), small.buckets.copy()
    dead_bi[3] = -1
    dead_bu[5] = -1
    cases.append(("dead rows (row 3 empty, row 5 fully masked)",
                  torch.float32, 1, S, 4, 4, 24, dead_bi, dead_bu))
    nq_full = 512 // 64
    cases.append(("full layout S=512 bq=bk=64", torch.float32, 1, 512, 4,
                  4, 24, np.tile(np.arange(nq_full, dtype=np.int32)[None],
                                 (nq_full, 1)),
                  np.zeros((nq_full, nq_full, 64, 64), np.int8)))
    for i, (tag, dtype, B, S_, H_, KV_, Dh_, bi_np, bu_np) in \
            enumerate(cases):
        q, k, v, bias = random_qkv(B, S_, H_, KV_, Dh_, 3, dtype,
                                   seed=10 + i)
        compare(tag, q, k, v, to_dev(bi_np), to_dev(bu_np), bias)
        # the shared layouts bring the host-built transposed layout; the
        # per-graph ones and the dead rows go without (derived in the op)
        bit_np = transpose_block_idx(bi_np, S_ // bu_np.shape[-1]) \
            if bi_np.ndim == 2 and "dead" not in tag else None
        compare_bwd(tag, q, k, v, to_dev(bi_np), to_dev(bu_np), bias,
                    None if bit_np is None else to_dev(bit_np), seed=i)
    dead_o = ops.cluster_attention(*random_qkv(1, S, 4, 4, 24, 3,
                                               torch.float32, seed=99)[:3],
                                   to_dev(dead_bi), to_dev(dead_bu))
    if dead_o[:, 3 * 32:4 * 32].any() or dead_o[:, 5 * 32:6 * 32].any():
        raise AssertionError("dead rows must output 0")

    # yardstick: one SDPA call with the dense (1, H, S, S) additive mask,
    # at the 8192-node graph and at the serve shape, on the backend that
    # PyTorch's own dispatch picks for it on the H100 (cuDNN) and on the
    # memory-efficient one. Both are named, so neither falls back to the
    # math backend, which would materialise H * S^2 fp32 scores.
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def dense_mask(bi_, bu_, bias, S_, bq_):
        """The 2-D layout ``bi_``/``bu_`` as one dense (1, H, S, S) bf16
        additive mask: each head's bias of the bucket, -inf where masked
        or unvisited; filled head by head and a band of rows at a time, so
        no temporary outgrows one band."""
        nq_ = S_ // bq_
        dense = torch.full((S_, S_), -1, dtype=torch.int8, device=dev)
        ii, mm = torch.nonzero(bi_ >= 0, as_tuple=True)
        dense.view(nq_, bq_, nq_, bq_).permute(0, 2, 1, 3)[
            ii, bi_[ii, mm].long()] = bu_[ii, mm]
        del ii, mm
        mask = torch.empty((1, bias.shape[0], S_, S_), dtype=torch.bfloat16,
                           device=dev)
        for r in range(0, S_, 2048):
            band = dense[r:r + 2048]
            idx, dead = band.clamp_min(0).long(), band < 0
            for h in range(bias.shape[0]):
                mask[0, h, r:r + 2048] = bias[h][idx].masked_fill_(
                    dead, float("-inf"))
            del idx, dead
        return mask

    def sdpa_bwd_ms(qt, kt, vt, mask, rec):
        """The backward of one SDPA call with the dense mask (gradients for
        q, k and v; the mask takes none), on the backend PyTorch's own
        dispatch picks, into ``rec["library_bwd_ms"]``, or the error it
        hit (out of memory included) into ``rec["library_bwd_error"]``."""
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        try:
            og = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
            gout = torch.randn_like(og)
            rec["library_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
                og, leaves, gout, retain_graph=True), 5)
            del og, gout
        except RuntimeError as e:
            rec["library_bwd_error"] = \
                f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
        del leaves
        torch.cuda.empty_cache()

    def sdpa_yardstick(graph, lay_, seed):
        bi_, bu_ = to_dev(lay_.block_idx), to_dev(lay_.buckets)
        q, k, v, bias = random_qkv(1, lay_.seq_len, H, KV, Dh,
                                   lay_.n_buckets, torch.bfloat16, seed=seed)
        S_, bq_ = lay_.seq_len, lay_.bq
        assert lay_.bk == bq_
        live = graph.n + large.n_global    # rows past the last node are dead
        o = ops.cluster_attention(q, k, v, bi_, bu_, bias)[:, :live].float()
        rec = {"graph_nodes": graph.n, "S": S_,
               "active_blocks": lay_.stats["active_blocks"],
               "ms": cuda_ms(lambda: ops.cluster_attention(
                   q, k, v, bi_, bu_, bias), 20),
               "plain_ms": cuda_ms(lambda: ops.cluster_attention(
                   q, k, v, bi_, bu_, bias, impl="plain"), 5),
               "bound_ms": bound(q, k, v, bi_, bu_)[0]}
        # the two backward kernels on this layout, beside SDPA's backward
        out_, lse_, dout_ = bwd_inputs(q, k, v, bi_, bu_, bias, seed=5)
        delta_ = ref.row_delta(dout_, out_)
        bit_ = to_dev(lay_.block_idx_t)
        rec["dq_ms"] = cuda_ms(lambda: tcab.dq_kernel(
            q, k, v, dout_, lse_, delta_, bi_, bu_, bias), 10)
        rec["dkv_ms"] = cuda_ms(lambda: tcab.dkv_kernel(
            q, k, v, dout_, lse_, delta_, bi_, bit_, bu_, bias), 10)
        log(f"[yardstick] {graph.n} nodes: backward kernels dq "
            f"{rec['dq_ms']:.4f} ms + dkv {rec['dkv_ms']:.4f} ms")
        del out_, lse_, dout_, delta_, bit_
        torch.cuda.empty_cache()
        mask = dense_mask(bi_, bu_, bias, S_, bq_)
        del bi_, bu_
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa(backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
        tol = TOL_O["bfloat16"]
        for key, backend in (("library", SDPBackend.CUDNN_ATTENTION),
                             ("efficient", SDPBackend.EFFICIENT_ATTENTION)):
            ref_o = sdpa(backend).transpose(1, 2)[:, :live].float()
            err = (o - ref_o).abs().max().item()
            if not torch.allclose(o, ref_o, atol=tol, rtol=tol):
                raise AssertionError(f"kernel vs SDPA ({backend}) at "
                                     f"{graph.n} nodes: max|dO|={err}")
            rec[f"{key}_ms"] = cuda_ms(lambda: sdpa(backend), 5)
            rec[f"max_abs_err_vs_{key}"] = err
            del ref_o
        # the backward of one such call: the library figure for the dQ and
        # dK/dV kernels together
        sdpa_bwd_ms(qt, kt, vt, mask, rec)
        log(f"[yardstick] {graph.n} nodes: SDPA backward with the dense "
            f"mask (PyTorch's pick): " + (
                f"{rec['library_bwd_ms']:.4f} ms" if "library_bwd_ms" in rec
                else rec["library_bwd_error"]))
        rec.update(mask_bytes=mask.numel() * mask.element_size(),
                   peak_bytes=torch.cuda.max_memory_allocated())
        log(f"[yardstick] {graph.n} nodes S={S_}: kernel {rec['ms']:.4f} "
            f"ms, plain {rec['plain_ms']:.4f} ms, SDPA with the dense mask "
            f"({rec['mask_bytes'] / 1e9:.2f} GB, peak "
            f"{rec['peak_bytes'] / 1e9:.2f} GB): cuDNN "
            f"{rec['library_ms']:.4f} ms (max|dO| "
            f"{rec['max_abs_err_vs_library']:.3g}), memory-efficient "
            f"{rec['efficient_ms']:.4f} ms (max|dO| "
            f"{rec['max_abs_err_vs_efficient']:.3g}); bound "
            f"{rec['bound_ms']:.4f} ms")
        del q, k, v, qt, kt, vt, mask, o
        torch.cuda.empty_cache()
        return rec

    del bi, bu
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g8 = degree_scaled_sbm(YARDSTICK_NODES, CLUSTERS, large, seed=0)
    yard = {str(YARDSTICK_NODES): sdpa_yardstick(
        g8, prepare_node_task(g8, large, bq=32, bk=32, d_b=8).layout, seed=2),
        str(SERVE_NODES): sdpa_yardstick(g, lay, seed=2)}

    # ------------------------- 3c. unbiased kernels of the LM path vs plain
    log(f"[phase] 3c starts at {time.perf_counter() - t_start:.1f} s")
    def unbiased_entries(bi, bq, causal):
        """Score entries one head of one sequence needs over the visited
        blocks of a (nq, mb) layout with bq = bk (or of every sequence's
        of a per-sequence (B, nq, mb) one): every entry of a block, or
        with the causal mask (a shared layout) only the (qpos, kpos) pairs
        with qpos >= kpos."""
        live = bi >= 0
        j = bi[live].long()
        if not causal:
            return j.numel() * bq * bq
        i = torch.arange(bi.shape[0], device=bi.device)[:, None].expand_as(
            bi)[live]
        a = torch.arange(bq, device=bi.device)
        # q-row a of block (i, j) keeps the k-columns b <= (i - j) bq + a
        return int(((i - j)[:, None] * bq + a[None] + 1).clamp(0, bq).sum())

    def bound_unbiased(kind, q, k, bi, bit, causal):
        """Least time of one unbiased kernel: each input read once, each
        output written once, and the arithmetic of the score entries the
        function needs (``unbiased_entries``: the causal mask's upper
        triangles excluded) at the peak rate of q's dtype. Forward: q,
        k, v, block_idx in, O and lse out, 4 flop per score entry per Dh
        (scores, PV). dQ: q, k, v, dO, lse, delta, block_idx in, dq out,
        6 (scores, dp, dq). dK/dV: the same inputs with block_idx_t,
        per-q-head dk and dv out, 8 (scores, dp, dv, dk). Returns (ms,
        "bytes" | "operations")."""
        B, S, H, Dh = q.shape
        bq = S // bi.shape[-2]
        # a layout shared by the batch counts once a sequence, one per
        # sequence (causal only shared) once
        entries = (B if bi.dim() == 2 else 1) * unbiased_entries(bi, bq,
                                                                 causal)
        elt = q.element_size()
        rows = B * H * S * 4
        qkv_b = (q.numel() + 2 * k.numel()) * elt
        if kind == "fwd":
            n_bytes = qkv_b + bi.numel() * 4 + q.numel() * elt + rows
            per = 4.0
        elif kind == "dq":
            n_bytes = qkv_b + q.numel() * elt + 2 * rows + bi.numel() * 4 \
                + q.numel() * elt
            per = 6.0
        else:
            n_bytes = qkv_b + q.numel() * elt + 2 * rows + bit.numel() * 4 \
                + 2 * q.numel() * elt
            per = 8.0
        flops = per * entries * Dh * H
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[1]] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    def compare_unbiased(tag, q, k, v, bi, bit, causal, seed):
        """The unbiased forward kernel vs the plain forward (O, lse), then
        the dQ and dK/dV kernels vs the plain backward on the forward
        kernel's O and lse and a random dO (dq, dk, dv as max|diff| over
        max|plain|). O is held to TOL_O and to TOL_O_ELEM. Returns
        (max|dO|, max|ddq|, max of max|ddk|, max|ddv|) and the forward's
        O, lse, dO."""
        dt = str(q.dtype).split(".")[1]
        before = (tca.unbiased_launches, tca.unbiased_sm90_launches)
        o, lse = ops.cluster_attention(q, k, v, bi, causal=causal,
                                       return_lse=True)
        bf16 = q.dtype == torch.bfloat16
        if (tca.unbiased_launches, tca.unbiased_sm90_launches) != (
                before[0] + (not bf16), before[1] + bf16):
            raise AssertionError(f"the {dt} unbiased forward went to the "
                                 f"other dtype's kernel: {tag}")
        po, plse = ops.cluster_attention(q, k, v, bi, causal=causal,
                                         return_lse=True, impl="plain")
        torch.cuda.synchronize()
        diff = (o.float() - po.float()).abs()
        err = diff.max().item()
        atol, rtol = TOL_O_ELEM[dt]
        # the worst element's share of its limit (ok at most 1)
        o_share = (diff / (atol + rtol * po.float().abs())).max().item()
        del diff
        lerr = (lse - plse).abs().max().item()
        ok = torch.allclose(o.float(), po.float(), atol=TOL_O[dt],
                            rtol=TOL_O[dt]) and o_share <= 1.0 \
            and torch.allclose(lse, plse, atol=TOL_LSE, rtol=1e-5) and bool(
                torch.isfinite(o).all())
        del po, plse
        gen = torch.Generator(device=dev).manual_seed(seed)
        dout = torch.randn(o.shape, generator=gen, device=dev).to(q.dtype)

        def bwd_counts():
            return (tcab.dq_unbiased_launches, tcab.dq_unbiased_sm90_launches,
                    tcab.dkv_unbiased_launches,
                    tcab.dkv_unbiased_sm90_launches)
        before = bwd_counts()
        got = tcab.cluster_attention_bwd(q, k, v, dout, o, lse, bi, None,
                                         None, bit, causal=causal)
        if bwd_counts() != tuple(c + d for c, d in zip(
                before, (not bf16, bf16) * 2)):
            raise AssertionError(f"the {dt} unbiased dQ or dK/dV went to "
                                 f"the other dtype's kernel: {tag}")
        want = ref.cluster_attention_bwd(q, k, v, dout, o, lse, bi, None,
                                         None, bit, causal=causal)
        torch.cuda.synchronize()
        rels, errs = [], []
        for x, y in zip(got[:3], want[:3]):
            d = (x.float() - y.float()).abs().max().item()
            errs.append(d)
            rels.append(d / max(y.float().abs().max().item(), 1e-30))
        ok = ok and all(r <= TOL_GRAD[dt] for r in rels) and all(
            bool(torch.isfinite(x).all()) for x in got[:3])
        log(f"[lm-kernel] {tag} {dt}"
            f"{'' if bit is not None else ', derived layout'}: max|dO|="
            f"{err:.3g} (tol {TOL_O[dt]}), worst element at {o_share:.3g} "
            f"of {atol:g} + {rtol:g}|O| max|dlse|={lerr:.3g} (tol "
            f"{TOL_LSE}); rel dq {rels[0]:.3g} dk {rels[1]:.3g} dv "
            f"{rels[2]:.3g} (tol {TOL_GRAD[dt]}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"unbiased kernels disagree with their "
                                 f"plain versions: {tag} {dt}")
        del got, want
        return (err, errs[0], max(errs[1], errs[2])), (o, lse, dout)

    def lm_qkv(B, S, H, KV, Dh, dtype, seed):
        return random_qkv(B, S, H, KV, Dh, 1, dtype, seed)[:3]

    def hoist_check(tag, q, k, v, bi, bit, seed, timed=False):
        """Rows 2, 5 and 6 (causal) under each value of ``hoist_scale``:
        the forward against the plain forward under the same flag (O
        within TOL_O and TOL_O_ELEM, lse within TOL_LSE), the dQ and
        dK/dV against the plain backward on the kernel's O and lse (rel
        within TOL_GRAD); with ``timed`` each kernel timed under each
        value. Returns ``{"hoist=..": record}``."""
        dt = str(q.dtype).split(".")[1]
        bf16 = q.dtype == torch.bfloat16
        gen = torch.Generator(device=dev).manual_seed(seed)
        dout = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        qa, ka, va, da = (tca.aligned(x) for x in (q, k, v, dout))

        def counts():
            return (tca.unbiased_launches, tca.unbiased_sm90_launches,
                    tcab.dq_unbiased_launches,
                    tcab.dq_unbiased_sm90_launches,
                    tcab.dkv_unbiased_launches,
                    tcab.dkv_unbiased_sm90_launches)
        out = {}
        for hoist in (False, True):
            before = counts()
            o, lse = tca.cluster_attention_fwd(q, k, v, bi, None, None,
                                               causal=True, return_lse=True,
                                               hoist_scale=hoist)
            got = tcab.cluster_attention_bwd(q, k, v, dout, o, lse, bi,
                                             None, None, bit, causal=True,
                                             hoist_scale=hoist)
            if counts() != tuple(c + d for c, d in zip(
                    before, (not bf16, bf16) * 3)):
                raise AssertionError(f"{tag} {dt} hoist_scale={hoist}: "
                                     f"launches {counts()} from {before}")
            po, plse = ref.cluster_sparse_attention(
                q, k, v, bi, causal=True, return_lse=True,
                hoist_scale=hoist)
            want = ref.cluster_attention_bwd(q, k, v, dout, o, lse, bi,
                                             None, None, bit, causal=True,
                                             hoist_scale=hoist)
            torch.cuda.synchronize()
            diff = (o.float() - po.float()).abs()
            atol, rtol = TOL_O_ELEM[dt]
            r = {"max_abs_err": diff.max().item(),
                 "max_abs_err_lse": (lse - plse).abs().max().item(),
                 "o_share": (diff / (atol + rtol * po.float().abs())).max()
                 .item()}
            del diff
            rels = [((x.float() - y.float()).abs().max()
                     / y.float().abs().max().clamp_min(1e-30)).item()
                    for x, y in zip(got[:3], want[:3])]
            r.update(zip(("rel_dq", "rel_dk", "rel_dv"), rels))
            ok = torch.allclose(o.float(), po.float(), atol=TOL_O[dt],
                                rtol=TOL_O[dt]) and r["o_share"] <= 1.0 \
                and torch.allclose(lse, plse, atol=TOL_LSE, rtol=1e-5) \
                and all(x <= TOL_GRAD[dt] for x in rels) and all(
                    bool(torch.isfinite(x).all()) for x in (o, *got[:3]))
            if timed:
                delta = ref.row_delta(dout, o)
                r["ms"] = cuda_ms(lambda: tca.cluster_attention_fwd(
                    q, k, v, bi, None, None, causal=True, return_lse=True,
                    hoist_scale=hoist), 5)
                r["dq_ms"] = cuda_ms(lambda: tcab.dq_unbiased_kernel(
                    qa, ka, va, da, lse, delta, bi, True,
                    hoist_scale=hoist), 5)
                r["dkv_ms"] = cuda_ms(lambda: tcab.dkv_unbiased_kernel(
                    qa, ka, va, da, lse, delta, bi, bit, True,
                    hoist_scale=hoist), 5)
                del delta
            log(f"[schedule] {tag} {dt} hoist_scale={hoist}: max|dO|="
                f"{r['max_abs_err']:.3g}, worst element at "
                f"{r['o_share']:.3g} of {atol:g} + {rtol:g}|O|, max|dlse|="
                f"{r['max_abs_err_lse']:.3g}; rel dq {rels[0]:.3g} dk "
                f"{rels[1]:.3g} dv {rels[2]:.3g} (tol {TOL_GRAD[dt]})" + (
                    f"; kernels fwd {r['ms']:.4f} dq {r['dq_ms']:.4f} dkv "
                    f"{r['dkv_ms']:.4f} ms" if timed else "")
                + f" {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"the unbiased kernels disagree with "
                                     f"their plain versions under "
                                     f"hoist_scale={hoist}: {tag} {dt}")
            out[f"hoist={hoist}"] = r
            del o, lse, got, po, plse, want
        del dout, qa, ka, va, da
        torch.cuda.empty_cache()
        return out

    lm_cfg = get_config("qwen3_0_6b")
    lm_lay = lm_local_global_layout(LM_SEQ, window=lm_cfg.window,
                                    n_global=lm_cfg.n_global)
    lm_bi, lm_bit = to_dev(lm_lay.block_idx), to_dev(lm_lay.block_idx_t)
    col = (lm_lay.block_idx_t[..., 0] >= 0).sum(1)
    log(f"[lm-kernel] layout S={LM_SEQ} window={lm_cfg.window} "
        f"n_global={lm_cfg.n_global}: nq={lm_lay.nq} mb={lm_lay.mb} "
        f"active={int((lm_lay.block_idx >= 0).sum())} density="
        f"{lm_lay.stats['density']:.4f}; transposed mt={lm_lay.mt}, column "
        f"visits min/mean/max={col.min()}/{col.mean():.2f}/{col.max()}")
    lm_rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[1]
        q, k, v = lm_qkv(1, LM_SEQ, lm_cfg.n_heads, lm_cfg.kv_heads,
                         lm_cfg.head_dim, dtype, seed=21)
        errs, (o, lse, dout) = compare_unbiased(
            "Qwen3-0.6B training shape, causal", q, k, v, lm_bi, lm_bit,
            True, seed=22)
        delta = ref.row_delta(dout, o)
        qa, ka, va, da = (tca.aligned(x) for x in (q, k, v, dout))
        runs = {
            "fwd": (lambda: tca.cluster_attention_fwd(
                        q, k, v, lm_bi, None, None, causal=True,
                        return_lse=True),
                    lambda: ref.cluster_sparse_attention(
                        q, k, v, lm_bi, causal=True, return_lse=True)),
            "dq": (lambda: tcab.dq_unbiased_kernel(qa, ka, va, da, lse,
                                                   delta, lm_bi, True),
                   lambda: ref.bwd_dq(q, k, v, dout, lse, delta, lm_bi,
                                      None, None, causal=True)),
            "dkv": (lambda: tcab.dkv_unbiased_kernel(
                        qa, ka, va, da, lse, delta, lm_bi, lm_bit, True),
                    lambda: ref.bwd_dkv(q, k, v, dout, lse, delta, lm_bi,
                                        lm_bit, None, None, causal=True))}
        lm_rec[dt] = {}
        for (half, (kern, plain)), err in zip(runs.items(), errs):
            r = lm_rec[dt][half] = {"max_abs_err": err}
            r["ms"] = cuda_ms(kern, 5)
            # one call, unwarmed: compare_flash has run it (2-4 s a call)
            r["plain_ms"] = cuda_ms(plain, 1, warm=False)
            r["bound_ms"], r["bound_by"] = bound_unbiased(half, q, k, lm_bi,
                                                          lm_bit, True)
            log(f"[lm-kernel] training shape {dt} {half}: kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"{r['bound_ms'] / r['ms']:.2%} of bound")
        # the schedule's hoist_scale on rows 2, 5, 6 (fp32 timed)
        lm_rec[dt]["schedules"] = hoist_check(
            "Qwen3-0.6B training shape, causal", q, k, v, lm_bi, lm_bit,
            seed=23, timed=dtype == torch.float32)
        if dtype == torch.bfloat16:
            # diagnostic: the heavy column (k-block 0, every q-row visits
            # it) cut to its first visitor
            trim_t = lm_bit.clone()
            trim_t[0, 1:] = -1
            lm_rec[dt]["dkv"]["ms_without_global_column"] = cuda_ms(
                lambda: tcab.dkv_unbiased_kernel(qa, ka, va, da, lse, delta,
                                                 lm_bi, trim_t, True), 5)
            log(f"[lm-kernel] training shape {dt}, heavy column cut to one "
                f"visit: dkv "
                f"{lm_rec[dt]['dkv']['ms_without_global_column']:.4f} ms")
            lm_o = o
        del q, k, v, o, lse, dout, delta, qa, ka, va, da
        torch.cuda.empty_cache()

    lm_cases = []
    for dtype in (torch.bfloat16, torch.float32):
        lm_cases += [
            ("non-causal layout S=2048 window 512, H=16 KV=8 Dh=128", dtype,
             1, 2048, 16, 8, 128, 512, False, True),
            ("SmolLM heads H=9 KV=3 Dh=64, S=2048 window 512", dtype, 1,
             2048, 9, 3, 64, 512, True, True),
            ("S=512 window 64, H=16 KV=8 Dh=128", dtype, 1, 512, 16, 8,
             128, 64, True, False),
            ("B=2, H=9 KV=3 Dh=64, S=1024 window 256", dtype, 2, 1024, 9, 3,
             64, 256, True, False)]
    for i, (tag, dtype, B, S_, H_, KV_, Dh_, win, causal, with_bit) in \
            enumerate(lm_cases):
        lay_ = lm_local_global_layout(S_, window=win, n_global=128,
                                      causal=causal)
        q, k, v = lm_qkv(B, S_, H_, KV_, Dh_, dtype, seed=30 + i)
        compare_unbiased(tag, q, k, v, to_dev(lay_.block_idx),
                         to_dev(lay_.block_idx_t) if with_bit else None,
                         causal, seed=40 + i)
        del q, k, v

    def lm_sdpa_yardstick():
        """One SDPA call at the training shape with the local+global
        causal layout as a dense boolean (S, S) mask and ``enable_gqa``,
        forward and backward (dq, dk, dv), on PyTorch's own pick of
        backend; and the dense causal one (``is_causal``) beside it. The
        masked forward must agree with the kernel's."""
        H, KV, Dh = lm_cfg.n_heads, lm_cfg.kv_heads, lm_cfg.head_dim
        q, k, v = lm_qkv(1, LM_SEQ, H, KV, Dh, torch.bfloat16, seed=21)
        nq, bq = lm_lay.nq, lm_lay.bq
        mask = torch.zeros((LM_SEQ, LM_SEQ), dtype=torch.bool, device=dev)
        ii, mm = torch.nonzero(lm_bi >= 0, as_tuple=True)
        mask.view(nq, bq, nq, bq).permute(0, 2, 1, 3)[
            ii, lm_bi[ii, mm].long()] = True
        mask &= torch.ones_like(mask).tril_()
        rec = {"mask_bytes": mask.numel()}
        leaves = [x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
        gout = torch.randn_like(leaves[0])
        for key, kw in (("library", {"attn_mask": mask}),
                        ("causal_dense", {"is_causal": True})):
            def fwd():
                return F.scaled_dot_product_attention(*leaves, **kw,
                                                      enable_gqa=True)
            try:
                with torch.no_grad():
                    o = fwd()
                if key == "library":
                    o = o.transpose(1, 2).float()
                    err = (o - lm_o.float()).abs().max().item()
                    rec["max_abs_err_vs_kernel"] = err
                    tol = TOL_O["bfloat16"]
                    if not torch.allclose(o, lm_o.float(), atol=tol,
                                          rtol=tol):
                        raise AssertionError(f"kernel vs SDPA with the "
                                             f"layout mask: max|dO|={err}")
                del o
                rec[f"{key}_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        *(x.detach() for x in leaves), **kw,
                        enable_gqa=True), 5)
                og = fwd()
                rec[f"{key}_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
                    og, leaves, gout, retain_graph=True), 5)
                del og
            except RuntimeError as e:   # out of memory included: recorded
                rec[f"{key}_error"] = \
                    f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
            torch.cuda.empty_cache()
        log(f"[lm-yardstick] SDPA at S={LM_SEQ}, H={H} over KV={KV}, bf16: "
            + "; ".join(
                f"{key}: " + (f"fwd {rec[key + '_ms']:.4f} ms, bwd "
                              f"{rec[key + '_bwd_ms']:.4f} ms"
                              if key + "_bwd_ms" in rec
                              else rec.get(key + "_error", "not measured"))
                for key in ("library", "causal_dense"))
            + f" (layout-mask max|dO| vs kernel "
            f"{rec.get('max_abs_err_vs_kernel', float('nan')):.3g})")
        del q, k, v, mask, leaves, gout
        torch.cuda.empty_cache()
        return rec

    lm_yard = lm_sdpa_yardstick()
    del lm_o, lm_bi, lm_bit
    torch.cuda.empty_cache()

    # -------------- 3d. the flash and SSD kernels (rows 7-10) vs plain
    log(f"[phase] 3d starts at {time.perf_counter() - t_start:.1f} s")
    flash_rec = flash_ssd_kernels(dev)

    # ------------ 3e. the biased kernels at 16 x 16 blocks (rows 1, 3, 4)
    log(f"[phase] 3e starts at {time.perf_counter() - t_start:.1f} s")
    def b16_kernels():
        """Rows 1, 3 and 4 at the graph-level task's 16 x 16 blocks, on
        the packed layout of the first mini-batch of phase 8 (128 graphs
        of ``synthetic_graph_level_dataset``, per-graph 3-D layouts, the
        smaller graphs' trailing q-block rows dead, the host-built
        transposed layout): GT heads (H=8, Dh=16) with a 1-wide table (GT
        has no bias; the op gives it a zero one, here random) and
        Graphormer-Slim heads (H=8, Dh=8) with 3 buckets and a random
        table, in bf16 and fp32. Each kernel against its plain version
        (``compare``, ``compare_bwd``: each launch on its own counter),
        then timed beside its plain version, bound and exp floor; in bf16
        one SDPA call with the layout as a dense (B, H, S, S) additive
        mask, forward and backward, on PyTorch's own pick of backend."""
        gcfg = get_config("gt")
        prep = prepare_graph_task(
            synthetic_graph_level_dataset(GRAPH_BATCH, gcfg, seed=1), gcfg,
            bq=16, bk=16, with_dense_buckets=True)
        b = prep.batch
        bi, bu = to_dev(b["block_idx"]), to_dev(b["buckets"])
        bit, dense_b = to_dev(b["block_idx_t"]), to_dev(b["dense_buckets"])
        B, S = bi.shape[0], prep.layout.seq_len
        live = (dense_b >= 0).any(-1)           # (B, S): rows not dead
        rec = {"graphs": B, "S": S, "bq": 16, "nq": bi.shape[1],
               "mb": bi.shape[2], "mt": bit.shape[2],
               "active_blocks": int((bi >= 0).sum()),
               "dead_q_blocks": int((bi < 0).all(-1).sum()),
               "live_rows": int(live.sum())}
        log(f"[b16] graph-level layout: {B} graphs, S={S}, bq=bk=16, "
            f"nq={rec['nq']} mb={rec['mb']} mt={rec['mt']}, "
            f"{rec['active_blocks']} active blocks, {rec['dead_q_blocks']} "
            f"dead q-blocks, {rec['live_rows']} of {B * S} rows live")
        for name, cfg_, nb in (("gt", gcfg, 1), ("graphormer_slim", slim, 3)):
            H_, KV_, Dh_ = cfg_.n_heads, cfg_.kv_heads, cfg_.head_dim
            r = rec[name] = {"H": H_, "Dh": Dh_, "n_buckets": nb}
            for dtype in (torch.bfloat16, torch.float32):
                dt = str(dtype).split(".")[1]
                q, k, v, bias = random_qkv(B, S, H_, KV_, Dh_, nb, dtype,
                                           seed=31)
                tag = f"16x16 {name} H={H_} Dh={Dh_} nb={nb}"
                err = compare(tag, q, k, v, bi, bu, bias)
                err_dq, err_dkv = compare_bwd(tag, q, k, v, bi, bu, bias,
                                              bit, seed=32)
                out, lse, dout = bwd_inputs(q, k, v, bi, bu, bias, seed=33)
                delta = ref.row_delta(dout, out)
                runs = {
                    "fwd": (lambda: tca.cluster_attention_fwd(
                        q, k, v, bi, bu, bias, return_lse=True),
                        lambda: ref.cluster_sparse_attention(
                            q, k, v, bi, bu, bias, return_lse=True), err),
                    "dq": (lambda: tcab.dq_kernel(
                        q, k, v, dout, lse, delta, bi, bu, bias),
                        lambda: ref.bwd_dq(q, k, v, dout, lse, delta, bi,
                                           bu, bias), err_dq),
                    "dkv": (lambda: tcab.dkv_kernel(
                        q, k, v, dout, lse, delta, bi, bit, bu, bias),
                        lambda: ref.bwd_dkv(q, k, v, dout, lse, delta, bi,
                                            bit, bu, bias), err_dkv)}
                d = r[dt] = {}
                for kind, (kern, plain, e) in runs.items():
                    x = d[kind] = {"max_abs_err": e, "ms": cuda_ms(kern, 20),
                                   "plain_ms": cuda_ms(plain, 3),
                                   "exp_floor_ms": exp_floor(q, bi, bu)}
                    x["bound_ms"], x["bound_by"] = (
                        bound(q, k, v, bi, bu, with_lse=True)
                        if kind == "fwd" else
                        bound_bwd(kind, q, k, bi, bu, bit, nb))
                    log(f"[b16] {tag} {dt} {kind}: kernel {x['ms']:.4f} ms, "
                        f"plain {x['plain_ms']:.4f} ms, bound "
                        f"{x['bound_ms']:.4f} ms ({x['bound_by']}), "
                        f"{x['bound_ms'] / x['ms']:.2%} of bound, exp floor "
                        f"{x['exp_floor_ms']:.4f} ms")
                if dtype == torch.bfloat16:
                    b16_sdpa(q, k, v, bias, dense_b, live, out, r)
                    if nb > 1:   # a real bias table: the rewrites at 16 x 16
                        d["schedules"] = schedule_check(
                            tag, q, k, v, bi, bu, bias, bit, seed=34)
                del q, k, v, out, lse, dout, delta
                torch.cuda.empty_cache()
        return rec

    def b16_sdpa(q, k, v, bias, dense_b, live, out, r):
        """One SDPA call with the packed layout as a dense (B, H, S, S)
        bf16 additive mask (each head's bias of the clipped bucket, -inf
        where masked), forward and backward, on PyTorch's own pick of
        backend, into ``r``; its O held to the kernel's on the live rows
        (a dead row's SDPA output is NaN)."""
        nb = bias.shape[1]
        idx = dense_b.clamp(0, nb - 1).long()
        mask = bias.to(torch.bfloat16)[:, idx].permute(1, 0, 2, 3) \
            .masked_fill((dense_b < 0)[:, None], float("-inf")).contiguous()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask)
        ref_o = sdpa().transpose(1, 2)[live].float()
        err = (out[live].float() - ref_o).abs().max().item()
        tol = TOL_O["bfloat16"]
        if not torch.allclose(out[live].float(), ref_o, atol=tol, rtol=tol):
            raise AssertionError(f"16x16 kernel vs SDPA: max|dO|={err}")
        r["library_ms"] = cuda_ms(sdpa, 20)
        r["max_abs_err_vs_library"] = err
        sdpa_bwd_ms(qt, kt, vt, mask, r)
        log(f"[b16] H={q.shape[2]} Dh={q.shape[3]}: SDPA with the dense "
            f"(B, H, S, S) mask ({mask.numel() * 2 / 1e6:.1f} MB), forward "
            f"{r['library_ms']:.4f} ms (max|dO| {err:.3g} on live rows), "
            f"backward " + (f"{r['library_bwd_ms']:.4f} ms"
                            if "library_bwd_ms" in r
                            else r["library_bwd_error"]))
        del mask, qt, kt, vt, ref_o

    b16_rec = b16_kernels()

    # ------------------------------------------- 4. serve (first main path)
    log(f"[phase] 4 starts at {time.perf_counter() - t_start:.1f} s")
    reset_counts, read_counts = kernel_counters()

    def only(**want):
        """The launch counts of a path that launches ``want`` and nothing
        else."""
        return {name: want.get(name, 0) for name in read_counts()}

    def serve(cfg, seed):
        model = GraphModel(cfg, device=dev, seed=seed)
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():   # a nonzero bias, so the lookup matters
            model.bias_table.copy_(
                torch.randn(model.bias_table.shape, generator=gen) * 0.5)
        srv = GraphServe(model)
        rng = np.random.default_rng(seed)
        nodes = rng.integers(0, g.n, QUERIES)
        eidx = rng.integers(0, g.e, QUERIES)
        rnd = rng.integers(0, g.n, (2, QUERIES))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        passes, outs = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            out = (srv.node(g, nodes), srv.link(g, g.src[eidx], g.dst[eidx]),
                   srv.link(g, rnd[0], rnd[1]))
            torch.cuda.synchronize()
            passes.append(time.perf_counter() - t0)
            outs.append(out)
            if len(passes) == 1:
                first = srv.prepared(g)
        counts = read_counts()
        launches = counts["cluster_attention_fwd_sm90"]
        peak = torch.cuda.max_memory_allocated()
        if srv.n_cached_layouts() != 1 or srv.prepared(g) is not first:
            raise AssertionError("the second pass missed the layout cache")
        want = 2 * 3 * cfg.n_layers
        if counts != only(cluster_attention_fwd_sm90=want):
            raise AssertionError(f"{cfg.name}: launches {counts} in 2 passes "
                                 f"x 3 forwards, want {want} forwards")
        node = outs[0][0]
        if node["logits"].shape != (QUERIES, cfg.n_classes) or \
                not np.isfinite(node["logits"]).all() or \
                not np.isfinite(outs[0][1]["scores"]).all():
            raise AssertionError("non-finite or misshapen serve output")
        prep_s, _, batch = srv.prepared(g)

        def forward():
            with torch.inference_mode():
                return graph_forward(srv.model, batch)
        fwd_ms = cuda_ms(forward, 5)
        breakdown = device_breakdown(forward, fwd_ms)
        with torch.inference_mode():
            logits = graph_predict(srv.model, batch)[0].float()
            plain = graph_predict(srv.model, batch, impl="plain")[0].float()
        ng = cfg.n_global
        logits, plain = logits[ng:ng + g.n], plain[ng:ng + g.n]
        rel = ((logits - plain).abs().max() / plain.abs().max()).item()
        agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
        st = prep_s.layout.stats
        log(f"[serve] {cfg.name}: {QUERIES} node + {2 * QUERIES} link "
            f"queries, pass 1 {passes[0]:.3f}s (prep "
            f"{prep_s.prep_seconds:.3f}s), pass 2 (cached) "
            f"{passes[1]:.3f}s; forward {fwd_ms:.3f} ms; peak "
            f"{peak / 2**30:.2f} GiB; S={prep_s.layout.seq_len} "
            f"nq={prep_s.layout.nq} mb={prep_s.layout.mb} "
            f"active={st['active_blocks']} density={st['density']:.5f}; "
            f"launches {launches}; kernel vs plain logits: max rel "
            f"{rel:.3g} (tol {TOL_LOGITS_REL}), argmax agree {agree:.4f} "
            f"(min {MIN_ARGMAX_AGREE})")
        if not (rel <= TOL_LOGITS_REL and agree >= MIN_ARGMAX_AGREE):
            raise AssertionError(f"{cfg.name}: kernel path and plain path "
                                 f"disagree")
        rec = {"launches": counts, "passes_s": passes,
               "prep_s": prep_s.prep_seconds, "forward_ms": fwd_ms,
               "peak_bytes": peak, "device_breakdown": breakdown}
        del srv, model, batch
        torch.cuda.empty_cache()
        return rec

    main_path = serve(large, seed=0)
    slim_run = serve(slim, seed=0)

    # --------------------------------------------- 5. train (slice 2's path)
    log(f"[phase] 5 starts at {time.perf_counter() - t_start:.1f} s")
    def rung_kernels(bi_, bu_, bit_, nb, live, tag):
        """Rows 1, 3 and 4 on one training rung, with the trainer's device
        layout (per-graph 3-D, B=1) and random bf16 inputs at the Large
        heads: each kernel timed beside its plain version, its bound and
        its exp floor; then one SDPA call with the rung's layout as a dense
        additive mask, forward (cuDNN, its O held to the kernel's on the
        live rows) and backward (PyTorch's pick)."""
        S_ = bi_.shape[-2] * 32
        q, k, v, bias = random_qkv(1, S_, H, KV, Dh, nb, torch.bfloat16,
                                   seed=21)
        out_, lse_, dout_ = bwd_inputs(q, k, v, bi_, bu_, bias, seed=22)
        delta_ = ref.row_delta(dout_, out_)
        runs = {
            "fwd": (lambda: tca.cluster_attention_fwd(q, k, v, bi_, bu_,
                                                      bias),
                    lambda: ref.cluster_sparse_attention(q, k, v, bi_, bu_,
                                                         bias)),
            "dq": (lambda: tcab.dq_kernel(q, k, v, dout_, lse_, delta_, bi_,
                                          bu_, bias),
                   lambda: ref.bwd_dq(q, k, v, dout_, lse_, delta_, bi_, bu_,
                                      bias)),
            "dkv": (lambda: tcab.dkv_kernel(q, k, v, dout_, lse_, delta_,
                                            bi_, bit_, bu_, bias),
                    lambda: ref.bwd_dkv(q, k, v, dout_, lse_, delta_, bi_,
                                        bit_, bu_, bias))}
        rec = {"active_blocks": int((bi_ >= 0).sum()), "S": S_}
        for kind, (kern, plain) in runs.items():
            r = rec[kind] = {"ms": cuda_ms(kern, 5),
                             "plain_ms": cuda_ms(plain, 2),
                             "exp_floor_ms": exp_floor(q, bi_, bu_)}
            r["bound_ms"], r["bound_by"] = (
                bound(q, k, v, bi_, bu_) if kind == "fwd" else
                bound_bwd(kind, q, k, bi_, bu_, bit_, nb))
            log(f"[rung] {tag} bfloat16 {kind}: kernel {r['ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.2%} of bound, "
                f"exp floor {r['exp_floor_ms']:.4f} ms")
        o = out_[:, :live].float()
        del out_, lse_, dout_, delta_
        torch.cuda.empty_cache()
        mask = dense_mask(bi_[0], bu_[0], bias, S_, 32)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            with sdpa_kernel(SDPBackend.CUDNN_ATTENTION):
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
        ref_o = sdpa().transpose(1, 2)[:, :live].float()
        err = (o - ref_o).abs().max().item()
        tol = TOL_O["bfloat16"]
        if not torch.allclose(o, ref_o, atol=tol, rtol=tol):
            raise AssertionError(f"kernel vs SDPA on {tag}: max|dO|={err}")
        rec["library_ms"] = cuda_ms(sdpa, 5)
        rec["max_abs_err_vs_library"] = err
        del ref_o, o
        sdpa_bwd_ms(qt, kt, vt, mask, rec)
        log(f"[rung] {tag}: SDPA with the dense mask, forward (cuDNN) "
            f"{rec['library_ms']:.4f} ms (max|dO| {err:.3g}), backward "
            f"(PyTorch's pick) " + (
                f"{rec['library_bwd_ms']:.4f} ms" if "library_bwd_ms" in rec
                else rec["library_bwd_error"]))
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()
        return rec

    def sparse_rung_dq(bi_, bu_, nb, tag):
        """The bf16 dQ kernel on the sparse training rung, with the
        trainer's device layout and random bf16 inputs at the Large heads:
        against the plain dQ, timed beside it and its bound, split, unsplit
        and with the heavy row cut to one visit (``dq_heavy_row``)."""
        S_ = bi_.shape[-2] * 32
        q, k, v, bias = random_qkv(1, S_, H, KV, Dh, nb, torch.bfloat16,
                                   seed=23)
        out_, lse_, dout_ = bwd_inputs(q, k, v, bi_, bu_, bias, seed=24)
        delta_ = ref.row_delta(dout_, out_)
        args = (q, k, v, dout_, lse_, delta_, bi_, bu_, bias)
        dq, db_part = tcab.dq_kernel(*args)
        want_dq, want_db = ref.bwd_dq(*args)
        rels = [_rel(dq, want_dq), _rel(db_part.sum(dim=(0, 2)), want_db)]
        if not all(r <= TOL_GRAD["bfloat16"] for r in rels):
            raise AssertionError(f"dQ kernel vs plain on {tag}: rel dq, "
                                 f"dbias {rels}")
        rec = dq_heavy_row(*args)
        rec.update(active_blocks=int((bi_ >= 0).sum()), S=S_,
                   plain_ms=cuda_ms(lambda: ref.bwd_dq(*args), 2),
                   rel_dq=rels[0], rel_dbias=rels[1])
        rec["bound_ms"], rec["bound_by"] = bound_bwd("dq", q, k, bi_, bu_,
                                                     None, nb)
        log(f"[rung] {tag} bfloat16 dq: rel dq {rels[0]:.3g} dbias "
            f"{rels[1]:.3g} (tol {TOL_GRAD['bfloat16']}); kernel "
            f"{rec['ms']:.4f} ms ({rec['split']}), unsplit "
            f"{rec['ms_unsplit']:.4f} ms, heavy row "
            f"({rec['heavy_row_visits']} visits, mean "
            f"{rec['mean_row_visits']:.1f}) cut to one visit "
            f"{rec['ms_without_heavy_row']:.4f} ms: the row costs "
            f"{rec['heavy_row_share']:.1%} split, "
            f"{rec['heavy_row_share_unsplit']:.1%} unsplit; plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
        del q, k, v, out_, lse_, dout_, delta_, args, dq, db_part
        torch.cuda.empty_cache()
        return rec

    def train():
        large = get_config("graphormer_large").replace(
            n_layers=TRAIN_LAYERS)
        g8 = degree_scaled_sbm(TRAIN_NODES, CLUSTERS, large, seed=0)
        train_mask = np.random.default_rng(0).random(g8.n) < 0.5
        model = GraphModel(large, device=dev, seed=0)
        params = list(model.parameters())
        t0 = time.perf_counter()
        task = NodeTask(g8, large, train_mask=train_mask, bq=32, bk=32,
                        d_b=8, device=dev)
        prep_s = time.perf_counter() - t0
        lay8 = task.layout
        log(f"[train] {large.name}: {sum(p.numel() for p in params):,} "
            f"params, {g8.n} nodes, {g8.e} edges, S={lay8.seq_len}; "
            f"{len(task._preps)} ladder rungs "
            f"{[round(b, 5) for b in task._preps]} prepared in "
            f"{prep_s:.2f}s (mb_cap={task.mb_cap}, mt_cap={lay8.mt}); "
            f"active blocks by rung "
            f"{[p[0].layout.stats['active_blocks'] for p in task._preps.values()]}")
        tr = Trainer(model, TrainerConfig(
            steps=TRAIN_STEPS, lr=1e-3, warmup=2,
            interleave_period=large.interleave_period,
            elastic_every=large.elastic_every), task=task)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        tr.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        hist = tr.history
        for h in hist:
            log(f"[train] step {h['step']:2d} [{h['variant']:6s}] loss "
                f"{h['loss']:.4f} acc {h['acc']:.4f} "
                f"{h['seconds'] * 1e3:9.2f} ms beta_thre "
                f"{h['beta_thre']:.5f}")
        for m in task.moves:
            log(f"[train] ladder move @ step {m.step}: pos={m.pos} "
                f"beta_thre={m.beta_thre:.5f} (LDR {m.ldr:+.3e})")
        ev = task.eval(model)
        n_sparse = sum(1 for h in hist if h["variant"] == "sparse")
        dense_at = [i for i, h in enumerate(hist) if h["dense"]]
        log(f"[train] {TRAIN_STEPS} steps in {run_s:.2f}s, dense at "
            f"{dense_at}, peak {peak / 2**30:.2f} GiB, launches {counts}; "
            f"eval acc {ev['acc']:.4f} xent {ev['xent']:.4f}")
        losses = [h["loss"] for h in hist]
        want = step_launches(large, B32_NAMES, n_sparse)
        if counts != only(**want):
            raise AssertionError(f"launches {counts}: want {want} of the "
                                 f"tensor-core forward, dQ and dK/dV "
                                 f"({n_sparse} sparse steps x "
                                 f"{large.n_layers} layers, remat "
                                 f"{large.remat!r})")
        if dense_at != [0, 8] or not np.isfinite(losses).all() or any(
                h["skipped"] for h in hist):
            raise AssertionError(f"dense steps {dense_at}, losses {losses}")
        tail = float(np.mean(losses[-4:]))
        if not tail < min(losses[0], losses[1]):
            raise AssertionError(f"loss did not fall: last 4 mean {tail} vs "
                                 f"steps 0 and 1 {losses[:2]}")
        # checkpoints at Graphormer-Large's size (phase 10's costs): the
        # state after the run, saved now, its background write going on
        # through the checks, profiles and kernel timings below and
        # phase 6, as an async save runs beside training; then restored
        # into a fresh Trainer on a model of its own (another seed)
        ckpt = checkpoint_start(tr, "train")

        # the rungs the sparse steps ran on, with the device batches the
        # trainer gave them: the kernels are held to the plain versions on
        # exactly these layouts (rung 1 is nearly dense and padded to
        # mb_cap, the others sparse)
        rungs = sorted({h["beta_thre"] for h in hist
                        if h["variant"] == "sparse"})
        checks = []
        torch.cuda.reset_peak_memory_stats()
        for bt in rungs:
            b = task._batches_dev[(bt, 0)]
            active = int((b["block_idx"] >= 0).sum())
            tag = f"rung beta_thre={bt:.5f} ({active} active blocks)"
            # the op alone, forward and autograd backward, random inputs
            # at the Large heads
            q, k, v, bias = random_qkv(1, lay8.seq_len, H, KV, Dh,
                                       model.bias_table.shape[1],
                                       torch.bfloat16, seed=11)
            op_err = compare_op(f"train {tag}", q, k, v, b["block_idx"],
                                b["buckets"], bias, b["block_idx_t"],
                                seed=12)
            del q, k, v, bias
            # one sparse step of the model, same parameters

            def loss_grads(impl):
                loss, _ = graph_loss(model, b, impl=impl)
                return loss.detach().float(), torch.autograd.grad(loss,
                                                                  params)
            kl, kg = loss_grads(None)
            pl_, pg = loss_grads("plain")
            loss_rel = (abs(kl - pl_) / abs(pl_)).item()
            names = [n for n, _ in model.named_parameters()]
            cos = {n: F.cosine_similarity(a.flatten().float(),
                                          c.flatten().float(), dim=0,
                                          eps=1e-30).item()
                   for n, a, c in zip(names, kg, pg)}
            worst = min(cos, key=cos.get)
            log(f"[train] one sparse step on {tag}, kernel vs plain path: "
                f"loss {kl.item():.6f} vs {pl_.item():.6f} (rel "
                f"{loss_rel:.3g}, tol {TOL_STEP_LOSS_REL}); gradient cosine "
                f"min {cos[worst]:.6f} ({worst}), bias_table "
                f"{cos['bias_table']:.6f} (min {MIN_GRAD_COSINE})")
            if not (loss_rel <= TOL_STEP_LOSS_REL
                    and cos[worst] >= MIN_GRAD_COSINE):
                raise AssertionError(f"kernel and plain training paths "
                                     f"disagree on {tag}")
            checks.append({"beta_thre": bt, "active_blocks": active,
                           "op_max_abs_err": op_err, "loss_rel": loss_rel,
                           "min_grad_cosine": [worst, cos[worst]],
                           "bias_table_cosine": cos["bias_table"]})
            del kg, pg
            torch.cuda.empty_cache()
        check_peak = torch.cuda.max_memory_allocated()
        log(f"[train] checks on {len(rungs)} rungs: peak "
            f"{check_peak / 2**30:.2f} GiB")
        # the nearly dense rung (most active blocks), kept for the kernel
        # times after the model is gone
        dense_bt = max(rungs, key=lambda bt: int(
            (task._batches_dev[(bt, 0)]["block_idx"] >= 0).sum()))
        rb = task._batches_dev[(dense_bt, 0)]
        rung_layout = (rb["block_idx"], rb["buckets"], rb["block_idx_t"],
                       model.bias_table.shape[1])
        # and the sparse rung (fewest active blocks), whose global-token
        # row is the dQ kernel's heavy row
        sparse_bt = min(rungs, key=lambda bt: int(
            (task._batches_dev[(bt, 0)]["block_idx"] >= 0).sum()))
        sb = task._batches_dev[(sparse_bt, 0)]
        sparse_layout = (sb["block_idx"], sb["buckets"])

        # profile one sparse and one dense step, on the active rung: the
        # sparse one against one unprofiled step's wall, the dense one
        # against the run's second dense step (step 8)
        batch = task.batches(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.step("sparse", batch)
        torch.cuda.synchronize()
        walls = {"sparse": (time.perf_counter() - t0) * 1e3,
                 "dense": hist[8]["seconds"] * 1e3}
        prof = {variant: device_breakdown(
            lambda: tr.step(variant, batch), walls[variant], tag="train",
            what=f"one {variant} step") for variant in ("sparse", "dense")}
        def ckpt_finish():
            return checkpoint_finish(ckpt, lambda d: Trainer(
                GraphModel(large, device=dev, seed=1),
                TrainerConfig(steps=TRAIN_STEPS, ckpt_dir=d), task=task))
        rec = {"launches": counts, "steps": hist, "moves": [
            vars(m) for m in task.moves], "eval": ev, "run_s": run_s,
            "prep_s": prep_s, "peak_bytes": peak, "checks": checks,
            "check_peak_bytes": check_peak, "profile": prof}
        del tr, model, batch, params, rb, sb
        torch.cuda.empty_cache()
        rec["rung"] = rung_kernels(
            *rung_layout, g8.n + large.n_global,
            f"nearly dense rung beta_thre={dense_bt:.5f}")
        rec["rung"]["beta_thre"] = dense_bt
        rec["sparse_rung"] = sparse_rung_dq(
            *sparse_layout, rung_layout[3],
            f"sparse rung beta_thre={sparse_bt:.5f}")
        rec["sparse_rung"]["beta_thre"] = sparse_bt
        return rec, ckpt_finish

    train_run, train_ckpt_finish = train()

    # ---------------------------------------- 6. LM train (slice 3's path)
    log(f"[phase] 6 starts at {time.perf_counter() - t_start:.1f} s")
    # phases 10-15 run in child processes, each started while the one
    # before it runs (``ChildPhase``), phase 10's now, so that its start-up
    # overlaps phase 6's GPU-bound training: deterministic cuBLAS where a
    # phase compares bits, an empty card for the large models; a child
    # fails its phase on a non-zero exit
    cublas = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    child_specs = [("--recovery", cublas, "phase 10 (recovery)", 600),
                   ("--remat", cublas, "phase 11 (recomputation)", 900),
                   ("--serve-lm", {}, "phase 12 (token serving)", 600),
                   ("--moe", {}, "phase 13 (MoE and hybrid)", 600),
                   ("--a10", cublas, "phase 14 (enc-dec, VLM, moments)",
                    600),
                   ("--graph-parallel", cublas,
                    "phase 15 (graph parallelism)", 900)]
    warm = {0: ChildPhase(*child_specs[0][:3])}

    def child_turn(i):
        """Child phase ``i`` (0 for phase 10), started ahead, given its
        turn, the next one started to warm up beside it; returns its
        record with ``wall_s``, the seconds from its turn to its exit."""
        import gc

        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        child = warm.pop(i)
        if i + 1 < len(child_specs):
            warm[i + 1] = ChildPhase(*child_specs[i + 1][:3])
        rec, wall = child.run(child_specs[i][3])
        rec["wall_s"] = wall
        return rec

    def train_lm():
        cfg = get_config("qwen3_0_6b").replace(attn_backend="cluster_sparse")
        model = LMModel(cfg, device=dev, seed=0)
        params = list(model.parameters())
        names = [n for n, _ in model.named_parameters()]
        dc = LMDataConfig(cfg.vocab_size, LM_SEQ, 1, seed=0)
        task = BatchFnTask(lambda s: lm_batch(dc, s))
        tr = Trainer(model, TrainerConfig(steps=LM_STEPS, lr=1e-3, warmup=2),
                     task=task)
        log(f"[lm-train] {cfg.name}: {sum(p.numel() for p in params):,} "
            f"params, {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
            f"{cfg.n_heads}/{cfg.kv_heads}, d_head {cfg.head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size} (padded "
            f"{cfg.vocab_padded}), {cfg.dtype} compute; S={LM_SEQ}, batch 1")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        tr.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        hist = tr.history
        for h in hist:
            log(f"[lm-train] step {h['step']} loss {h['loss']:.4f} "
                f"{h['seconds'] * 1e3:10.2f} ms")
        log(f"[lm-train] {LM_STEPS} steps in {run_s:.2f}s, peak "
            f"{peak / 2**30:.2f} GiB, launches {counts}, per step "
            f"{ {n: c / LM_STEPS for n, c in counts.items() if c} }")
        want = step_launches(cfg, UNBIASED_NAMES, LM_STEPS)
        # bf16 compute: the tensor-core forward, dQ and dK/dV
        if counts != only(**want):
            raise AssertionError(f"launches {counts}: want {want} of the "
                                 f"unbiased kernels ({LM_STEPS} steps x "
                                 f"{cfg.n_layers} layers, remat "
                                 f"{cfg.remat!r}) and no other")
        losses = [h["loss"] for h in hist]
        if not np.isfinite(losses).all() or any(h["skipped"] for h in hist) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"LM losses not finite and falling: "
                                 f"{losses}")

        # one step by the kernel path and one by the plain path, the same
        # parameters and batch
        batch = task.batches(0)

        def loss_grads(impl):
            loss, _ = lm_loss(model, batch, impl=impl)
            return loss.detach().float(), torch.autograd.grad(loss, params)
        kl, kg = loss_grads(None)
        pl_, pg = loss_grads("plain")
        loss_rel = (abs(kl - pl_) / abs(pl_)).item()
        cos = {n: F.cosine_similarity(a.flatten().float(),
                                      c.flatten().float(), dim=0,
                                      eps=1e-30).item()
               for n, a, c in zip(names, kg, pg)}
        worst = min(cos, key=cos.get)
        log(f"[lm-train] one step, kernel vs plain path: loss "
            f"{kl.item():.6f} vs {pl_.item():.6f} (rel {loss_rel:.3g}, tol "
            f"{TOL_LM_STEP_LOSS_REL}); gradient cosine min {cos[worst]:.6f} "
            f"({worst}; min {MIN_GRAD_COSINE}), layers.0.attn.wq "
            f"{cos['layers.0.attn.wq']:.6f}")
        if not (loss_rel <= TOL_LM_STEP_LOSS_REL
                and cos[worst] >= MIN_GRAD_COSINE):
            raise AssertionError("kernel and plain LM training paths "
                                 "disagree")
        del kg, pg
        torch.cuda.empty_cache()

        # profile one step, against the median wall of three unprofiled
        # steps after a warm-up step (the first after the kernel-vs-plain
        # check regrows the allocator's cache)
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.step("sparse", batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = float(np.median(walls[1:]))
        log(f"[lm-train] unprofiled steps after the check: "
            f"{', '.join(f'{w:.2f}' for w in walls)} ms (median of the "
            f"last 3: {wall:.2f})")
        # the cluster kernels: cluster_sm90 (forward), cluster_bwd_sm90
        # (dQ, dK/dV) in bf16
        prof = device_breakdown(lambda: tr.step("sparse", batch), wall,
                                tag="lm-train", what="one step",
                                focus="cluster")
        # the host copy of the parameters that run() takes before its
        # first step for the re-init rung (part of run_s above)
        t0 = time.perf_counter()
        host_copy(params)
        init_copy_s = time.perf_counter() - t0
        log(f"[lm-train] host copy of the "
            f"{sum(p.numel() * p.element_size() for p in params):,} bytes "
            f"of parameters: {init_copy_s:.4f} s")
        rec = {"launches": counts, "steps": hist, "run_s": run_s,
               "peak_bytes": peak, "loss_rel": loss_rel,
               "min_grad_cosine": [worst, cos[worst]], "step_wall_ms": wall,
               "step_walls_ms": walls, "profile": prof,
               "init_copy_s": init_copy_s}
        del tr, task, model, batch, params
        torch.cuda.empty_cache()
        return rec

    lm_run = train_lm()
    # phase 5's checkpoint, written in the background through phase 6
    train_run["checkpoint"] = train_ckpt_finish()
    del train_ckpt_finish

    # ------------------------------------ 7. tune (slice 4's main path)
    log(f"[phase] 7 starts at {time.perf_counter() - t_start:.1f} s")
    tune_run = tune_phase(dev, reset_counts, read_counts)

    # ------------------- 8. graph-level train and 9. link train (slice 10)
    log(f"[phase] 8 starts at {time.perf_counter() - t_start:.1f} s")
    def remat_step_ab(tr, step, batch, tag):
        """The same run's A/B of the layer recomputation on the trainer's
        sparse step, outside the run's launch counts. STEP_AB_ROUNDS
        rounds, each under "none", then under "block": STEP_AB_REPS steps
        on one mini-batch, and as many on the task's own batches for
        those steps (the graph-level task's mini-batches in turn, the link
        task's pair stream), each step's wall synchronized; the host time
        to issue one forward (the task's sparse loss, to its return) and
        its backward (``autograd.grad``, to its return), neither waiting
        for the device; and a Trainer of its own over the same model and
        task running STEP_AB_LOOP_STEPS sparse steps, as phase 8's loop
        runs them (each step's wall from the Trainer, the first left
        out). Then one profiled step of each (device time, busy share)."""
        model, task = tr.model, tr.task
        base = model.cfg
        loss_fn = task.loss_variants["sparse"]
        params = list(model.parameters())
        keys = ("step_ms", "alternating_ms", "loop_ms", "fwd_issue_ms",
                "bwd_issue_ms")
        out = {remat: {k: [] for k in keys} for remat in ("none", "block")}

        def timed(b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step("sparse", b)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        for _ in range(STEP_AB_ROUNDS):
            for remat, r in out.items():
                model.cfg = base.replace(remat=remat)
                for i in range(STEP_AB_REPS):
                    r["step_ms"].append(timed(batch))
                    r["alternating_ms"].append(timed(task.batches(i)))
                t0 = time.perf_counter()
                loss, _ = loss_fn(model, batch)
                t1 = time.perf_counter()
                torch.autograd.grad(loss, params, allow_unused=True)
                t2 = time.perf_counter()
                torch.cuda.synchronize()
                r["fwd_issue_ms"].append((t1 - t0) * 1e3)
                r["bwd_issue_ms"].append((t2 - t1) * 1e3)
                del loss
                # the task was prepared for the model's own config
                model.cfg = base
                loop = Trainer(model, TrainerConfig(
                    steps=STEP_AB_LOOP_STEPS, lr=1e-3, warmup=2,
                    interleave_period=0, elastic_every=base.elastic_every),
                    task=task)
                model.cfg = base.replace(remat=remat)
                loop.run()
                r["loop_ms"] += [h["seconds"] * 1e3
                                 for h in loop.history[1:]]
                del loop
        for remat, r in out.items():
            model.cfg = base.replace(remat=remat)
            for key in keys:
                r[key + "_median"] = float(np.median(r[key]))
            r["profile"] = device_breakdown(
                lambda: step("sparse", batch), r["step_ms_median"],
                tag=f"{tag} remat={remat}", what="one sparse step")
        model.cfg = base
        n, b = out["none"], out["block"]
        dev_ms = {remat: (r["profile"] or {}).get("device_ms")
                  for remat, r in out.items()}
        log(f"[{tag}] remat A/B, same run, {STEP_AB_ROUNDS} rounds, medians "
            f"none / block: step on one batch {n['step_ms_median']:.3f} / "
            f"{b['step_ms_median']:.3f} ms "
            f"({b['step_ms_median'] / n['step_ms_median']:.4f}x), on the "
            f"task's batches {n['alternating_ms_median']:.3f} / "
            f"{b['alternating_ms_median']:.3f} ms, in a Trainer loop "
            f"{n['loop_ms_median']:.3f} / {b['loop_ms_median']:.3f} ms "
            f"({b['loop_ms_median'] / n['loop_ms_median']:.4f}x); host "
            f"issue of the forward {n['fwd_issue_ms_median']:.3f} / "
            f"{b['fwd_issue_ms_median']:.3f} ms, of the backward "
            f"{n['bwd_issue_ms_median']:.3f} / "
            f"{b['bwd_issue_ms_median']:.3f} ms; device time of a step "
            f"{dev_ms['none']} / {dev_ms['block']} ms")
        return out

    def train_task(cfg, task, steps, tag, sparse_kernels, prep_s):
        """``steps`` steps of ``task`` through the Trainer (dense every
        ``cfg.interleave_period``, an AutoTuner epoch every step), each
        sparse step held to launching ``sparse_kernels`` (the forward, dQ
        and dK/dV names in ``read_counts``) as ``step_launches`` says and
        nothing else, each dense step to launching nothing. Returns the
        run's record."""
        model = GraphModel(cfg, device=dev, seed=0)
        if hasattr(model, "bias_table"):  # a nonzero table and gradient
            gen = torch.Generator().manual_seed(1)
            with torch.no_grad():
                model.bias_table.copy_(
                    torch.randn(model.bias_table.shape, generator=gen) * 0.5)
        n_params = sum(p.numel() for p in model.parameters())
        lay = task.layout
        log(f"[{tag}] {cfg.name}: {n_params:,} params, {cfg.n_layers} "
            f"layers, d_model {cfg.d_model}, heads {cfg.n_heads}/"
            f"{cfg.kv_heads}, d_head {cfg.head_dim}, d_ff {cfg.d_ff}, "
            f"{cfg.dtype} compute; {task.n_batches} mini-batch(es) of "
            f"{task.prep.batch['feat'].shape[0]} sequence(s), S="
            f"{lay.seq_len}, bq=bk={lay.bq}, mb_cap={task.mb_cap}, "
            f"{len(task._preps)} ladder rungs; host prep {prep_s:.2f}s")
        check = step_check(model, lambda m, b, impl: (
            link_loss(m, b, impl=impl) if task.name == "link" else
            graph_loss(m, b, impl=impl)), task.batches(0), tag)
        tr = Trainer(model, TrainerConfig(
            steps=steps, lr=1e-3, warmup=2,
            interleave_period=cfg.interleave_period,
            elastic_every=cfg.elastic_every), task=task)
        per_step = step_launches(cfg, sparse_kernels)
        run_step = tr.step

        def checked_step(variant, batch, **faults):
            before = read_counts()
            m = run_step(variant, batch, **faults)
            now = read_counts()
            got = {n: now[n] - before[n] for n in now}
            want = only(**per_step) if variant == "sparse" else only()
            if got != want:
                raise AssertionError(
                    f"{tag}: a {variant} step launched "
                    f"{ {n: c for n, c in got.items() if c} }, want "
                    f"{ {n: c for n, c in want.items() if c} }")
            return m
        tr.step = checked_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        tr.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        hist = tr.history
        for h in hist:
            log(f"[{tag}] step {h['step']:2d} [{h['variant']:6s}] loss "
                f"{h['loss']:.4f} acc {h['acc']:.4f} "
                f"{h['seconds'] * 1e3:9.2f} ms beta_thre "
                f"{h['beta_thre']:.5f}")
        for m in task.moves:
            log(f"[{tag}] ladder move @ step {m.step}: pos={m.pos} "
                f"beta_thre={m.beta_thre:.5f} (LDR {m.ldr:+.3e})")
        ev = task.eval(model)
        losses = [h["loss"] for h in hist]
        dense_at = [i for i, h in enumerate(hist) if h["dense"]]
        # step 0 carries the first call's start-up (allocator, cuBLAS)
        sparse_ms = [h["seconds"] * 1e3 for h in hist if not h["dense"]]
        dense_ms = [h["seconds"] * 1e3 for h in hist[1:] if h["dense"]]
        n_sparse = len(sparse_ms)
        want_dense = list(range(0, steps, cfg.interleave_period))
        if dense_at != want_dense or not np.isfinite(losses).all() or any(
                h["skipped"] for h in hist) or counts != only(
                **step_launches(cfg, sparse_kernels, n_sparse)):
            raise AssertionError(f"{tag}: dense steps {dense_at} (want "
                                 f"{want_dense}), losses {losses}, "
                                 f"launches {counts}")
        rec = {"config": cfg.name, "params": n_params, "steps": hist,
               "moves": [vars(m) for m in task.moves], "eval": ev,
               "run_s": run_s, "prep_s": prep_s, "peak_bytes": peak,
               "launches": counts, "step0_check": check,
               "sparse_step_ms_median": float(np.median(sparse_ms)),
               "dense_step_ms_median": (float(np.median(dense_ms))
                                        if dense_ms else None),
               "dense_step0_ms": hist[0]["seconds"] * 1e3,
               "S": lay.seq_len, "bq": lay.bq, "profile": {}}
        # one sparse and one dense step on the first mini-batch, profiled
        # against the wall of the same step unprofiled just before
        batch = task.batches(0)
        for variant in ("sparse", "dense"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.step(variant, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            rec["profile"][variant] = device_breakdown(
                lambda: tr.step(variant, batch), wall, tag=tag,
                what=f"one {variant} step", focus="cluster")
        rec["remat_ab"] = remat_step_ab(tr, run_step, batch, tag)
        log(f"[{tag}] {steps} steps in {run_s:.2f}s, dense at {dense_at}; "
            f"sparse step median {rec['sparse_step_ms_median']:.2f} ms, "
            f"dense step median "
            + (f"{rec['dense_step_ms_median']:.2f} ms" if dense_ms else
               "n/a") + f" (step 0 {rec['dense_step0_ms']:.2f} ms); loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; held-out "
            + " ".join(f"{k} {v:.4f}" for k, v in ev.items())
            + f"; peak {peak / 2**30:.2f} GiB; launches "
            f"{ {n: c for n, c in counts.items() if c} }")
        del tr, model, batch
        torch.cuda.empty_cache()
        return rec

    gt = get_config("gt")
    graph_runs = {}
    for cfg_, steps in ((gt, GRAPH_STEPS), (slim, SLIM_GRAPH_STEPS)):
        t0 = time.perf_counter()
        gtask = GraphLevelTask(
            synthetic_graph_level_dataset(GRAPH_TRAIN, cfg_, seed=1), cfg_,
            eval_graphs=synthetic_graph_level_dataset(GRAPH_EVAL, cfg_,
                                                      seed=2),
            batch_graphs=GRAPH_BATCH, device=dev)
        prep_s = time.perf_counter() - t0
        graph_runs[cfg_.name] = train_task(cfg_, gtask, steps, "graph-train",
                                           B16_NAMES, prep_s)
        del gtask

    t0 = time.perf_counter()
    ltask = LinkTask(sbm_graph(LINK_NODES, 4, p_in=0.04, p_out=0.002,
                               feat_dim=gt.feat_dim, n_classes=gt.n_classes,
                               seed=0), gt, n_pairs=LINK_PAIRS, device=dev)
    link_run = train_task(gt, ltask, LINK_STEPS, "link-train", B32_NAMES,
                          time.perf_counter() - t0)
    del ltask

    # ------------- 9b. the paper's three systems (slice 20's main path)
    log(f"[phase] 9b starts at {time.perf_counter() - t_start:.1f} s")
    nc_run = node_classification_runs(dev, reset_counts, read_counts)
    nc_launches = {}
    for counts in nc_run["launches"].values():
        for n, c in counts.items():
            nc_launches[n] = nc_launches.get(n, 0) + c

    # ------------------- 9c. the paper's scale (slice 21's main path)
    log(f"[phase] 9c starts at {time.perf_counter() - t_start:.1f} s")
    scale_rec = scale_phase(dev, reset_counts, read_counts,
                            scale_future.result(), compare_unbiased,
                            bound_unbiased, smi)
    draw_pool.shutdown()

    # ---------- 9d. the fit-and-roofline sweep held to the card (slice 22)
    log(f"[phase] 9d starts at {time.perf_counter() - t_start:.1f} s")
    estimate_rec = estimate_phase(dev, reset_counts, read_counts, smi)

    # ------------------------------------ 10. recovery (slice 11's path)
    log(f"[phase] 10 starts at {time.perf_counter() - t_start:.1f} s")
    def recovery_run():
        """Phase 10 in a child process with deterministic cuBLAS, so the
        setting stays away from phases 1-9; it fails on a non-zero exit or
        any unrecovered case."""
        rec = child_turn(0)
        wall = rec["wall_s"]
        if rec["unrecovered"]:
            raise AssertionError(f"phase 10: unrecovered {rec['unrecovered']}")
        log(f"[recovery] phase 10 child: {wall:.1f}s of wall, every case "
            f"recovered")
        return rec

    recovery = recovery_run()

    # --------------------------- 11. recomputation (slice 12's main path)
    log(f"[phase] 11 starts at {time.perf_counter() - t_start:.1f} s")
    def remat_run():
        """Phase 11 in a child process (``remat_phase``): an empty card
        for Qwen3-4B, deterministic cuBLAS for the A/B."""
        log(f"[remat] parent before phase 11: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        rec = child_turn(1)
        log(f"[remat] phase 11 child: {rec['wall_s']:.1f}s of wall")
        return rec

    remat = remat_run()

    # ------------------------------- 12. token serving (slice 13's path)
    log(f"[phase] 12 starts at {time.perf_counter() - t_start:.1f} s")
    def serve_lm_run():
        """Phase 12 in a child process (``serve_lm_phase``): an empty card,
        and the earlier phases' deterministic settings stay away."""
        rec = child_turn(2)
        log(f"[serve-lm] phase 12 child: {rec['wall_s']:.1f}s of wall")
        return rec

    serve_lm = serve_lm_run()

    # ----------------- 13. the MoE family and the hybrid (slice 14's path)
    log(f"[phase] 13 starts at {time.perf_counter() - t_start:.1f} s")
    def moe_run():
        """Phase 13 in a child process (``moe_phase``): an empty card for
        Qwen3-235B-A22B's ~60 GB of training state."""
        rec = child_turn(3)
        log(f"[moe] phase 13 child: {rec['wall_s']:.1f}s of wall")
        return rec

    moe_rec = moe_run()

    # -- 14. the enc-dec and VLM families, AdamW's moments (slice 15's path)
    log(f"[phase] 14 starts at {time.perf_counter() - t_start:.1f} s")
    def a10_run():
        """Phase 14 in a child process (``a10_phase``): an empty card for
        InternVL2's ~48 GB of training state."""
        rec = child_turn(4)
        log(f"[a10] phase 14 child: {rec['wall_s']:.1f}s of wall")
        return rec

    a10_rec = a10_run()

    # ------------- 15. graph parallelism on the mesh (slice 16's path)
    log(f"[phase] 15 starts at {time.perf_counter() - t_start:.1f} s")
    def gp_run():
        """Phase 15 in a child process (``graph_parallel_phase``), which
        spawns its GP_P ranks on this card over gloo; deterministic
        cuBLAS for (o)'s bitwise resumes."""
        rec = child_turn(5)
        log(f"[graph-parallel] phase 15 child: {rec['wall_s']:.1f}s of "
            f"wall")
        return rec

    gp_rec = gp_run()

    # -------------------------------------------------------- results
    rec = serve_rec["bfloat16"]
    yard8 = yard[str(YARDSTICK_NODES)]
    yard_s = yard[str(SERVE_NODES)]

    def launches(name):
        return (main_path["launches"][name] + train_run["launches"][name]
                + link_run["launches"][name] + nc_launches[name]
                + recovery["launches"][name] + remat["launches"][name]
                + gp_rec["launches"][name])

    rung = train_run["rung"]
    csrc = "src/repro_torch/kernels/csrc/"
    # rows 1, 3 and 4 have a kernel for each dtype: `source` is the bf16
    # tensor-core one, which the bf16 main paths launched; the fp32
    # CUDA-core one is `source_float32`, counted in `launches_float32`
    # (0 on the main paths) and timed under `float32`. Times at the serve
    # shape, under `rung` at the nearly dense training rung and, for dQ,
    # under `sparse_rung` at the sparse one. These entries are the 32 x
    # 32 instantiations (serve, node train, link train); the `_b16`
    # entries below are the same sources' 16 x 16 instantiations, which
    # the graph-level runs launched.
    kernels = [{
        "name": "cluster_attention_fwd", "route": "cuda",
        "source": csrc + "cluster_attention_fwd_sm90.cu",
        "replaces": "src/repro/kernels/cluster_attention.py:127",
        "launches": launches("cluster_attention_fwd_sm90"),
        "launches_by_path": {
            "serve": main_path["launches"]["cluster_attention_fwd_sm90"],
            "train": train_run["launches"]["cluster_attention_fwd_sm90"],
            "link_train": link_run["launches"]["cluster_attention_fwd_sm90"],
            "node_classification": nc_launches["cluster_attention_fwd_sm90"],
            "recovery": recovery["launches"]["cluster_attention_fwd_sm90"],
            "remat": remat["launches"]["cluster_attention_fwd_sm90"],
            "graph_parallel": gp_rec["launches"][
                "cluster_attention_fwd_sm90"]},
        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "exp_floor_ms": rec["exp_floor_ms"],
        # SDPA (cuDNN) with the dense additive mask, at the serve shape
        "library_ms": yard_s["library_ms"],
        "rung": {**rung["fwd"], "library_ms": rung["library_ms"]},
        "source_float32": csrc + "cluster_attention_fwd.cu",
        "launches_float32": launches("cluster_attention_fwd"),
        "float32": {k: v for k, v in serve_rec["float32"].items()
                    if k not in ("bwd", "schedules")},
        "yardstick": yard,
        "serve": {"graphormer_large": main_path,
                  "graphormer_slim": slim_run}}]
    for half, name, line in (
            ("dq", "cluster_attention_bwd_dq", 152),
            ("dkv", "cluster_attention_bwd_dkv", 244)):
        b = rec["bwd"][half]
        kernels.append({
            "name": name, "route": "cuda",
            "source": csrc + f"{name}_sm90.cu",
            "replaces": f"src/repro/kernels/cluster_attention_bwd.py:{line}",
            "launches": launches(name + "_sm90"),
            "launches_node_classification": nc_launches[name + "_sm90"],
            "max_abs_err": b["max_abs_err"], "ms": b["ms"],
            "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "exp_floor_ms": b["exp_floor_ms"],
            "rung": {**rung[half], "library_ms": rung.get("library_bwd_ms")},
            "source_float32": csrc + "cluster_attention_bwd.cu",
            "launches_float32": launches(name),
            # one SDPA backward with the dense mask (dq, dk and dv
            # together) at the serve shape, or null with the error it hit
            "library_ms": yard_s.get("library_bwd_ms"),
            "library_error": yard_s.get("library_bwd_error"),
            "library_ms_8192": yard8.get("library_bwd_ms"),
            "float32": serve_rec["float32"]["bwd"][half],
            **{k: v for k, v in b.items() if k.startswith("ms_without")
               or k == "heavy_row"}})
    # the unbiased kernels of the LM path: times at the Qwen3-0.6B training
    # shape in bf16, launches from the LM training run
    for half, name, src, line in (
            ("fwd", "cluster_attention_fwd_unbiased", "fwd",
             "cluster_attention.py:80"),
            ("dq", "cluster_attention_bwd_dq_unbiased", "bwd",
             "cluster_attention_bwd.py:118"),
            ("dkv", "cluster_attention_bwd_dkv_unbiased", "bwd",
             "cluster_attention_bwd.py:206")):
        b = lm_rec["bfloat16"][half]
        lib = "library" if half == "fwd" else "library_bwd"
        # each has a kernel for each dtype: `source` is the bf16
        # tensor-core one, which the bf16 LM run launched; the fp32
        # CUDA-core one is `source_float32`, timed under `float32`
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/"
                      f"cluster_attention_unbiased_{src}_sm90.cu",
            "replaces": f"src/repro/kernels/{line}",
            "launches": (lm_run["launches"][name + "_sm90"]
                         + remat["launches"][name + "_sm90"]
                         + serve_lm["launches"][name + "_sm90"]
                         + moe_rec["launches"][name + "_sm90"]
                         + a10_rec["launches"][name + "_sm90"]
                         + gp_rec["launches"][name + "_sm90"]),
            "launches_by_path": {
                "lm_train": lm_run["launches"][name + "_sm90"],
                "remat": remat["launches"][name + "_sm90"],
                "serve_prefill": serve_lm["launches"][name + "_sm90"],
                "moe_hybrid": moe_rec["launches"][name + "_sm90"],
                "encdec_vlm": a10_rec["launches"][name + "_sm90"],
                "graph_parallel": gp_rec["launches"][name + "_sm90"]},
            "max_abs_err": b["max_abs_err"], "ms": b["ms"],
            "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"],
            # one SDPA call with the layout as a dense boolean mask and
            # enable_gqa (its backward, dq + dk + dv, for dQ and dK/dV),
            # or null with the error it hit
            "library_ms": lm_yard.get(f"{lib}_ms"),
            "library_error": lm_yard.get("library_error"),
            "causal_dense_ms": lm_yard.get(
                "causal_dense_ms" if half == "fwd" else
                "causal_dense_bwd_ms"),
            "float32": lm_rec["float32"][half],
            **{k: v for k, v in b.items() if k.startswith("ms_without")},
            "source_float32": f"src/repro_torch/kernels/csrc/"
                              f"cluster_attention_unbiased_{src}.cu",
            # the LM run's, phase 13's fp32 Jamba prefill, phase 14's
            # fp32 enc-dec decode check and phase 15 (n)'s fp32 Jamba
            "launches_float32": (lm_run["launches"][name]
                                 + moe_rec["launches"][name]
                                 + a10_rec["launches_float32"][name]
                                 + gp_rec["launches"][name])})
    # the same kernels at the paper's scale run's shapes (phase 9c): the
    # Dh 8 and 24 instantiations on a layout per sequence. Times at
    # Graphormer-Large's heads (B=2, S=16384, Dh 24) in bf16, Slim's
    # (Dh 8) and fp32 beside them; launches from the scale runs
    for half, name, src, line in (
            ("fwd", "cluster_attention_fwd_unbiased", "fwd",
             "cluster_attention.py:80"),
            ("dq", "cluster_attention_bwd_dq_unbiased", "bwd",
             "cluster_attention_bwd.py:118"),
            ("dkv", "cluster_attention_bwd_dkv_unbiased", "bwd",
             "cluster_attention_bwd.py:206")):
        sk = scale_rec["kernels"]
        b = sk["graphormer_large_bfloat16"][half]
        yard_g = sk["graphormer_large_bfloat16"]["yardstick"]
        kernels.append({
            "name": name + "_graph", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/"
                      f"cluster_attention_unbiased_{src}_sm90.cu",
            "replaces": f"src/repro/kernels/{line}",
            "launches": scale_rec["launches"][name + "_sm90"],
            "launches_by_path": {
                run: r["launches"].get(name + "_sm90", 0)
                for run, r in scale_rec["runs"].items()},
            "max_abs_err": b["max_abs_err"], "ms": b["ms"],
            "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"],
            # one SDPA call with the layouts as a dense boolean mask (its
            # backward, dq + dk + dv, for dQ and dK/dV), or null with the
            # error it hit
            "library_ms": yard_g.get("library_ms" if half == "fwd"
                                     else "library_bwd_ms"),
            "library_error": yard_g.get("library_error"),
            "shape": {**scale_rec["kernel_layout"], "H": 32, "Dh": 24},
            "graphormer_slim": {
                **sk["graphormer_slim_bfloat16"][half],
                "library_ms": sk["graphormer_slim_bfloat16"][
                    "yardstick"].get("library_ms" if half == "fwd"
                                     else "library_bwd_ms")},
            "float32": sk["graphormer_large_float32"][half],
            "float32_slim": sk["graphormer_slim_float32"][half],
            "source_float32": f"src/repro_torch/kernels/csrc/"
                              f"cluster_attention_unbiased_{src}.cu",
            "launches_float32": scale_rec["launches"][name]})
    # the flash kernels and the SSD scan: times at full width in bf16,
    # launches from the tune phase, the main path. Rows 7-9 have a
    # kernel for each dtype: `source` is the bf16 tensor-core one, timed
    # here, whose count from the tune phase is 0 (the tuner's cases are
    # fp32; phase 3d, a kernel-vs-plain check, is the only place it runs);
    # `source_float32` is the CUDA-core one the tune phase launched,
    # counted in `launches_float32`, and timed under `float32`. Row 10's
    # one source serves both dtypes (bf16 on the tensor cores, fp32 on
    # CUDA cores); one launch is one call of its four chunk-parallel
    # kernels, each timed under `ms_by_kernel`.
    for half, name, sm90, src32, line in (
            ("fwd", "flash_attention_fwd", True, "flash_attention_fwd.cu",
             "flash_attention.py:34"),
            ("dq", "flash_attention_bwd_dq", True, "flash_attention_bwd.cu",
             "flash_attention.py:175"),
            ("dkv", "flash_attention_bwd_dkv", True, "flash_attention_bwd.cu",
             "flash_attention.py:224"),
            ("ssd", "ssd_fwd", False, "ssd.cu", "ssd.py:29")):
        b = flash_rec["bfloat16"]
        lib = None if half == "ssd" else b.get(
            "library_ms" if half == "fwd" else "library_bwd_ms")
        src = f"{name}_sm90.cu" if sm90 else src32
        rec = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{line}",
            "launches": tune_run["launches"][
                f"{name}_sm90" if sm90 else name],
            "max_abs_err": b[half]["max_abs_err"], "ms": b[half]["ms"],
            "plain_ms": b[half]["plain_ms"], "bound_ms": b[half]["bound_ms"],
            "bound_by": b[half]["bound_by"],
            # one SDPA call with is_causal and enable_gqa (its backward,
            # dq + dk + dv, for dQ and dK/dV); the SSD scan has none
            "library_ms": lib,
            "library_error": None if half == "ssd" else b.get(
                "library_error"),
            "float32": flash_rec["float32"][half]}
        if half == "ssd":
            rec["ms_by_kernel"] = b[half]["ms_by_kernel"]
        if sm90:
            rec["main_path"] = ("none: the tune phase runs fp32 cases only, "
                                "so it launched the float32 source")
            rec["source_float32"] = f"src/repro_torch/kernels/csrc/{src32}"
            rec["launches_float32"] = tune_run["launches"][name]
        kernels.append(rec)
    # the 16 x 16 instantiations of rows 1, 3 and 4: times at the
    # graph-level shape with GT's heads (phase 3e), launches from the GT
    # and Graphormer-Slim graph-level runs (phase 8)
    for half, name, line in (
            ("fwd", "cluster_attention_fwd", "cluster_attention.py:127"),
            ("dq", "cluster_attention_bwd_dq", "cluster_attention_bwd.py:152"),
            ("dkv", "cluster_attention_bwd_dkv",
             "cluster_attention_bwd.py:244")):
        b = b16_rec["gt"]["bfloat16"][half]
        cnt = {run: r["launches"][f"{name}_sm90_b16"]
               for run, r in graph_runs.items()}
        cnt["recovery"] = recovery["launches"][f"{name}_sm90_b16"]
        cnt["graph_parallel"] = gp_rec["launches"][f"{name}_sm90_b16"]
        kernels.append({
            "name": f"{name}_b16", "route": "cuda",
            "source": csrc + f"{name}_sm90.cu",
            "replaces": f"src/repro/kernels/{line}",
            "launches": sum(cnt.values()), "launches_by_path": cnt,
            "max_abs_err": b["max_abs_err"], "ms": b["ms"],
            "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "exp_floor_ms": b["exp_floor_ms"],
            # one SDPA call with the dense (B, H, S, S) mask at the same
            # shape (its backward, dq + dk + dv, for dQ and dK/dV)
            "library_ms": b16_rec["gt"].get(
                "library_ms" if half == "fwd" else "library_bwd_ms"),
            "library_error": b16_rec["gt"].get("library_bwd_error"),
            "shape": {k: v for k, v in b16_rec.items()
                      if not isinstance(v, dict)},
            "graphormer_slim": {
                **b16_rec["graphormer_slim"]["bfloat16"][half],
                "library_ms": b16_rec["graphormer_slim"].get(
                    "library_ms" if half == "fwd" else "library_bwd_ms")},
            "float32": b16_rec["gt"]["float32"][half],
            "source_float32": csrc + ("cluster_attention_fwd.cu"
                                      if half == "fwd" else
                                      "cluster_attention_bwd.cu")})
    # each path's record goes with the first kernel it launched; phase 11
    # ran the unbiased kernels (Qwen3) and the 32 x 32 biased ones
    # (Graphormer-Large), and goes with the first
    by_name = {k["name"]: k for k in kernels}
    for name, key, val in (
            ("cluster_attention_fwd", "train", train_run),
            ("cluster_attention_fwd", "link_train", link_run),
            ("cluster_attention_fwd", "node_classification", nc_run),
            ("cluster_attention_bwd_dq", "sparse_rung",
             train_run["sparse_rung"]),
            ("cluster_attention_fwd_unbiased", "lm_yardstick", lm_yard),
            ("cluster_attention_fwd_unbiased", "lm_train", lm_run),
            ("cluster_attention_fwd_unbiased", "remat", remat),
            ("cluster_attention_fwd_unbiased", "serve_lm", serve_lm),
            ("cluster_attention_fwd_unbiased", "moe_hybrid", moe_rec),
            ("cluster_attention_fwd_unbiased", "encdec_vlm", a10_rec),
            ("cluster_attention_fwd", "graph_parallel", gp_rec),
            ("ssd_fwd", "tune", tune_run),
            ("cluster_attention_fwd_b16", "graph_train", graph_runs),
            ("cluster_attention_fwd_b16", "recovery", recovery),
            ("cluster_attention_fwd_unbiased_graph", "scale",
             {k: v for k, v in scale_rec.items() if k != "kernels"}),
            ("cluster_attention_fwd_unbiased", "estimate", estimate_rec)):
        by_name[name][key] = val
    # the schedule's rewrites held to the plain versions (the same kernels
    # under their flags; fp32 timed under each): rows 1, 3, 4 at the serve
    # shape and at 16 x 16, rows 2, 5, 6 at the Qwen3-0.6B training shape
    by_name["cluster_attention_fwd"]["schedules"] = {
        "serve_" + dt: serve_rec[dt]["schedules"]
        for dt in ("bfloat16", "float32")}
    by_name["cluster_attention_fwd_b16"]["schedules"] = {
        "graphormer_slim_bfloat16":
            b16_rec["graphormer_slim"]["bfloat16"]["schedules"]}
    by_name["cluster_attention_fwd_unbiased"]["schedules"] = {
        dt: lm_rec[dt]["schedules"] for dt in ("bfloat16", "float32")}
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


CHILD_PHASES = {"--recovery": recovery_phase, "--remat": remat_phase,
                "--serve-lm": serve_lm_phase, "--moe": moe_phase,
                "--a10": a10_phase, "--graph-parallel": graph_parallel_phase}


if __name__ == "__main__":
    phase = CHILD_PHASES.get(sys.argv[1] if len(sys.argv) > 1 else "")
    if phase is None:
        sys.exit(main())
    code = phase(sys.argv[2])
    # a child's record is on disk and its ranks joined: leave without the
    # interpreter's teardown of torch, which the parent would wait out
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
