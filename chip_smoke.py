"""Drives the PyTorch port of GraphCast and GenCast (graphcast_tpu_torch) on
one GPU.

Usage: python3 chip_smoke.py            (all phases; needs one CUDA device)
       python3 chip_smoke.py --phases build,k1,k2   (a subset, for debugging)
       python3 chip_smoke.py --profile DIR  (also profile one step of each
                                             timed path)

Phases, each printing one line with its seconds and results:
  build  compile csrc/*.cu with nvcc for sm_90a and load it; print the
         card's name and power limit (nvidia-smi). Beside it, in a thread
         of its own ([prelude]), the host work that needs no card: the
         geometry phase, the geometry artifacts and attention masks the
         later phases take from the per-process caches, and the small
         phases' CPU references (the build's last ptxas keeps one core
         busy for minutes).
  shared_card  SHARED_CARD_WORLD processes on the one card (parallel/
         launch.py, as parallel starts its ranks), which the card
         time-slices: each launches, back to back and with no
         synchronisation in between, K2 and then K5 for at least 20 s each,
         K1, K4 and K6 for at least 10 s each (SHARED_CARD_PLAN, at
         GraphCast_small's shapes: graphcast_tpu_torch/tools/
         shared_card_study.py hammer), then synchronises once. Fails unless
         both processes report no error (a call that launched nothing, a
         non-finite output; a fault raises in the process and so here) and
         each one's last outputs of every kernel equal one call's in this
         process bit for bit. Prints each kernel's launches and device
         seconds per process.
  geometry  the native connectivity library (graphcast_tpu_torch/native/
         geometry_kernels.cc, built with g++ at first use and asked for
         as "native": a failed build fails the phase) and the numpy
         backend at 1.0°/mesh-5 and 0.25°/mesh-6: each artifact's build
         seconds (beside the kernels' build), grid2mesh and the multi-mesh
         edge lists bit-equal between the two, the number of mesh2grid
         rows (and grid nodes) that differ, and the backend that "auto"
         resolves to, which must be native (the later phases' models
         take "auto").
  k1     the fused edge kernel against its plain-PyTorch twin on the card,
         latent 512, bf16: processor mode, We without e' and e' without We
         on the real mesh-6 multi-mesh edge set, encoder mode on the real
         0.25° grid2mesh edge set; the kernels' registers, spills, shared
         memory and any ptxas wgmma advisory from the build log; each mode
         timed in turns with its products as bf16 cuBLAS GEMMs over the
         same rows (gemm_ms, a yardstick, not a library call for its
         function).
  k2     the fused decoder kernel against its twin at 0.25° (1,038,240 grid
         nodes, 227 outputs); its registers, spills, shared memory and any
         ptxas wgmma advisory from the build log; timed in turns with the
         products-only yardstick (its 11 products per node as bf16 cuBLAS
         GEMMs over all nodes, gemm_ms, not a library call for its
         function).
  main   the main path: zoo.graphcast() (0.25°, 37 levels, mesh-6, latent
         512, 16 message-passing steps), random weights from a fixed
         torch.Generator, Autoregressive(InputsAndResiduals(Bfloat16Cast(
         GraphCast))).rollout_final for 4 six-hour steps at batch 1 in bf16
         from an ERA5-shaped series made on the card (data/era5.py); checks
         finiteness and the kernels' launch counts.
  small  zoo.graphcast_small() (message-passing steps cut to
         SMALL_MP_STEPS, for the CPU side's sake) one step on the card
         (bf16, kernels) against the same port on the CPU (twins): per
         variable, rms(card bf16 - cpu f32) <= 2 * rms(cpu bf16 - cpu f32)
         + eps.
  k4     the edge step's backward kernel against torch.autograd.grad of the
         K1 twin, seeded random cotangents: processor mode on the mesh-6
         edge set, encoder mode on the 0.25° grid2mesh edge set; a rerun
         bit-equal in every gradient (fixed-order column sums, weight
         gradients, receiver runs and sender sums); registers, spills and
         shared memory from the build log; the whole backward timed in
         turns with its products as cuBLAS GEMMs (gemm_ms), the per-row
         kernel's own device time from the profiler (kernel_ms).
  k5     the decoder's backward kernel against autograd of the K2 twin on
         the first 131,072 grid nodes of the 0.25° mesh2grid list with all
         mesh-6 nodes (the twin's f32 autograd at all 1,038,240 nodes would
         hold several 6.4 GB tensors); a rerun bit-equal in every
         gradient (fixed-order sums, the sender sums by K3's sender mode);
         the kernel in uneven node chunks against one chunk; then
         the kernel alone at all nodes. Its registers, spills, shared memory
         and ptxas advisories; the whole backward timed in turns with its
         products-only yardstick (25 GEMMs per node, gemm_ms), the per-node
         kernel's own device time from the profiler (kernel_ms).
  wgrad  the weight-gradient reduction that K4 and K5 share
         (csrc/weight_grad.cu) against its plain version at the shapes the
         train step gives it, a rerun bit-equal (fixed-order sums); timed
         in turns with cuBLAS's a.t() @ b (kernel, library, library,
         kernel), its two passes split by torch.profiler; the kernel's
         registers, spills and shared memory from the build log.
  train  the training slice: train.make_train_step over Autoregressive(
         InputsAndResiduals(Bfloat16Cast(GraphCast)), gradient_checkpointing
         =True) at zoo.graphcast(), graphcast_optimizer(peak_lr=1e-3), AR-1,
         batch 1, bf16; one warm-up and 3 timed steps: s/step, peak memory,
         the 4 losses; checks finite losses, changed parameters and the
         kernel launches per step that the model's graph implies (K1 17,
         K2 1; K4 once per row chunk of each of its 17 calls, K5 once per
         node chunk, the weight-gradient reduction once per matrix
         gradient per chunk).
  k6     the block-sparse attention kernel against its plain version on
         random bf16 q, k, v (4 heads of 128) over GenCast's real k-hop-16
         masks: mesh-5 (GenCast 1p0deg) at batch 1 and at batch
         ENSEMBLE_MEMBERS (the ensemble's shape, batch x heads = 16), and
         mesh-6 (GenCast 0p25deg) at batch 1; also
         the host build time of each mask and block map, and
         torch.nn.functional.scaled_dot_product_attention with the dense
         boolean mask as the library yardstick where that mask fits, timed
         in turns with the kernel; the kernel's registers, spills, shared
         memory and any ptxas wgmma advisory from the build log.
  k7k8   the attention's backward kernels, K7 (dq) and K8 (dk, dv), against
         the plain backward on random bf16 q, k, v and cotangent over the
         same masks at k6's three shapes (the kernels' own o and lse from
         K6), a rerun bit-equal, each kernel's registers, spills and shared
         memory from the build log, and the pair timed in turns with the
         backward of scaled_dot_product_attention with the dense boolean
         mask (the library yardstick) where that mask fits.
  sp_attention  K6, K7 and K8 on sequence-parallel shard maps (ops/
         splash.py shard_block_maps) at the mesh-6 k-hop-16 mask, 4 heads of
         128, for S in SP_SHARDS: each shard's kernels against their plain
         twins on its map; the shards' o, lse and dq put together equal the
         unsharded kernels' bit for bit (each q row meets the same kv tiles
         in the same order); their dk and dv partials summed in shard order
         within SP_DKV_RTOL of the unsharded K8; a rerun bit-equal; every
         shard's time beside the unsharded kernels' and its bound; SDPA
         with the first shard's rows of the dense mask as K6's yardstick.
  embed  K1 and K2 in embed mode (GenCast's grid2mesh and mesh2grid, raw
         edge features embedded in the kernel) against their plain versions
         on the real 1.0° GenCast and 0.25° edge sets; each timed in turns
         with its products-only yardstick (K1 3 GEMMs per edge, K2 17 per
         node); K1's registers, spills and shared memory.
  embed_bwd  K4 and K5 in embed mode against torch.autograd.grad of the K1
         and K2 embed twins on the real 1.0° GenCast edge sets (each also a
         rerun bit-equal in every gradient), each kernel alone on the 0.25°
         sets (each in turns with its products-only yardstick, K4 6 GEMMs
         per edge, K5 40 per node, and its own device time), and the
         feature-gradient pass they share against its plain version, a
         rerun bit-equal, timed in turns with its two products as bf16
         cuBLAS calls (x.t() @ d, d @ w0.t(): the library yardstick).
  train_forms  zoo.graphcast()'s training step in the memory forms, each
         from the same seed's weights and the same bf16 batch through
         Autoregressive(InputsAndResiduals(Bfloat16Cast(GraphCast)),
         gradient_checkpointing=True) and graphcast_optimizer(peak_lr=
         1e-3): A (fused, AR-2), A_remat (A with remat_processor), B (the
         JAX package's 0.25° training form, TRAINING_FORM, with
         loss_scan_unroll=4, AR-2), C (B with loss_carry_offload and
         loss_offload_processor_carries) at AR-2 and AR-4 (C_ar4). Two
         steps each: the first (learning rate 0) gives the loss and every
         gradient, the second s/step, peak GB, the launches of K1, K2, K3,
         K4, K5, the sender sums and the weight-gradient reduction, and the
         parameters. Checks A_remat bit-equal to A and C to B (loss,
         gradients, parameters), B within FORMS_RTOL of A (loss relative
         difference, each gradient's relative RMS), finite losses, changed
         parameters, and which kernels each form launches.
  ensemble_0p25_chunked  zoo.gencast_0p25deg().build(**ENSEMBLE_0P25_FORM)
         (chunked encode and decode, unfused; tools/
         bench_train_gencast.py's 0.25° form): (a) one preconditioned
         denoiser evaluation of 2 members at the sampler's first noise
         level, against the same weights unchunked (the general path)
         within FORMS_RTOL per variable, the chunked rerun bit-equal
         without torch's deterministic algorithms; the general path's
         grid2mesh sender gather ([G, 2, 512] bf16 rows onto the 0.25°
         grid2mesh edges) in ns/row; (b) the evaluation at
         ENSEMBLE_0P25_MEMBERS members: s per evaluation and per
         member-evaluation, peak GB (an out-of-memory error fails it);
         (c) one GenCast training step in the same form at batch 1 after
         a warm-up step: s/step, peak GB, finite losses, changed
         parameters, K3 and K6-K8 launches.
  gencast  GenCast's sampling path: zoo.gencast_1p0deg() (1.0°, 13 levels,
         mesh-5, latent 512, 16-layer 4-head k-hop-16 transformer, 20 noise
         levels) at full width, random weights from a fixed generator with
         the near-zero-initialised ones redrawn, NaNCleaner(
         InputsAndResiduals(GenCast)), synthetic batch 1 in bf16; one
         warm-up and GENCAST_STEPS timed 12 h steps: s/step, peak memory;
         checks finite output of the template's shape, that two generators
         give different samples, and the launches per step (K6 once per
         layer per evaluation, K1 and K2 embed once per evaluation; 39
         evaluations).
  gencast_small  zoo.gencast_mini() (mesh-4; its transformer cut to
         MINI_LAYERS layers, for the CPU side's sake and the script's time
         limit, in all the Mini phases): one preconditioned denoiser
         evaluation at three noise levels on the card against the port on
         the CPU, with the small phase's noise-floor rule per variable.
  gencast_train  GenCast's training path: train.make_train_step over
         NaNCleaner(InputsAndResiduals(GenCast)) at zoo.gencast_1p0deg(),
         graphcast_optimizer(peak_lr=1e-3), batch 1, bf16 data with NaN SST
         on SST_NAN_ROWS latitude rows, f32 masters, σ and noise from a
         torch.Generator; one warm-up and TRAIN_STEPS timed steps: s/step,
         peak memory, the losses; checks finite losses, changed parameters
         and the launches per step (K6, K7 and K8 once per layer; K1, K2,
         K4 and K5 once each, all in embed mode).
  gencast_train_small  zoo.gencast_mini(): the stack's loss, per-variable
         losses and every parameter gradient on the card against the port
         on the CPU, on the same σ and numpy noise, with the small phase's
         noise-floor rule.
  train_small  zoo.graphcast_small() (message-passing steps cut to
         TRAIN_SMALL_MP_STEPS, for the CPU side's sake) AR-1 loss and every
         parameter gradient on the card against the CPU port, with the
         small phase's noise-floor rule per variable and per parameter; then
         on the card, AR-2 with gradient_checkpointing on against off.
  k3     the sorted segment sum (K3) against its plain version, bf16: on
         the mesh-5 multimesh and the 1.0 deg GenCast grid2mesh set at
         C = 4 x 512 (the batch-4 paths) and on the 0.25 deg grid2mesh set
         at C = 2 x 512 (in-degrees up to 3,753), with
         torch.segment_reduce over the CSR offsets as the library
         yardstick; then its sender mode (the backward's per-edge sender
         gradients into the sender nodes, bf16 in, f32 out, through the
         edge list's sender-sorted permutation) at the 0.25° train step's
         three calls (mesh-6 multimesh, grid2mesh, mesh2grid, C = 512)
         against its plain version, a rerun bit-equal, timed in turns with
         the f32 index_add_ it replaced (the library yardstick).
  ensemble  the main path of the batch > 1 slice, GenCast's ensemble
         forecast: rollout.chunked_ensemble_prediction over NaNCleaner(
         InputsAndResiduals(GenCast)) at zoo.gencast_1p0deg(), random
         weights as in gencast, ENSEMBLE_MEMBERS members as the batch axis,
         bf16; one warm-up chunk, then ENSEMBLE_STEPS timed 12 h chunks:
         s per step and per member-step, peak memory; checks finite output
         of the template's shape, distinct members, the launches per step
         (K3 twice per evaluation, grid2mesh and mesh2grid; K6 once per
         layer per evaluation; K1 and K2 none) and a rerun of the first
         chunk bit-equal to the timed run's first step (torch's
         deterministic algorithms off).
  ensemble_small  zoo.gencast_mini() at batch 2 on the card: one
         preconditioned denoiser evaluation (the general path, K3) per pair
         of gencast_small's three noise levels, a level per member; each
         member against the port on the CPU at its level (gencast_small's
         own CPU runs, made once) with the small phase's noise-floor rule.
  graphcast_batch  small's model at batch BATCH through Autoregressive(
         InputsAndResiduals(Bfloat16Cast(GraphCast))): the general path with
         K3. Member 0 of one step (the small phase's inputs) against a
         batch-1 card step of its inputs (K1, K2) and against the small
         phase's CPU f32 run, each within the small phase's noise floor;
         then rollout_final over BATCH_STEPS timed steps: s per step, peak
         memory, K3 once per aggregation (2 + SMALL_MP_STEPS a step), K1
         and K2 none, and
         a rerun bit-equal (torch's deterministic algorithms off).
  parallel  PARALLEL_WORLD ranks (processes; nccl with one card each where
         the machine has them, else gloo on the one card; the backend and
         world size on a line of their own) over parallel/sharding.py
         meshes: (a) the zoo.graphcast_small() AR-1 train step, global
         batch PARALLEL_WORLD, one example per rank, through K1, K2, K4 and
         K5; the updated parameters equal, bit for bit, one process that
         averages both examples' batch-1 gradients and steps (constant
         learning rate 1e-3); s/step, peak GB per rank, launches; (b) the
         zoo.gencast_1p0deg() loss and every gradient with its
         transformer split over "sp" (K6-K8 on shard maps, 16 launches
         each) against the unsharded step on the same weights, σ and
         noise, within SP_TRAIN_RTOL; (c) the ENSEMBLE_MEMBERS-member 12 h
         step with the members split over "batch", member by member
         against the unsharded ensemble on the same member streams, with
         torch's deterministic algorithms off (every sum of the general
         path runs in a fixed order): the unsharded ensemble's rerun
         bit-equal, the sharded members bit-equal to it.
  forecast  the GraphCast demo's path (examples/graphcast_demo.py) at
         zoo.graphcast() (0.25°, 37 levels, mesh-6, latent 512, 16 steps):
         the port's random weights written as a reference-format bundle
         (compat/haiku_checkpoint.py) and loaded back, every tensor
         bit-equal; an ERA5-shaped dataset from a seed on the card (2 input
         frames and FORECAST_STEPS targets, 37 levels); the progress
         features and TISR on the card (data/era5.py,
         data/solar_radiation.py), TISR held against the CPU for one
         timestamp (max-abs within 1e-4 of the field's maximum; the points
         that are 0 on one side only, at the terminator, counted) and the
         progress features bit-equal; extraction, a
         FORECAST_STEPS-step forecast (K1 17 and K2 1 a step) and its
         latitude-weighted RMSE and ACC (evaluation.py). Prints the
         seconds of each part and the peak memory.
  gencast_0p25  one 12 h step of zoo.gencast_0p25deg() (0.25°, mesh-6,
         latent 512, 16-layer k-hop-16 transformer, one member, bf16, batch
         1, the fused path) from an ERA5-shaped dataset through data/era5:
         one denoiser evaluation and the SHT basis as the warm-up (the
         host's graph, mask and basis builds), then GENCAST_0P25_STEPS
         timed: s per step, peak memory, launches per step (K1 embed 39,
         K2 embed 39, K6 624).
         Then the card against the CPU at a lower resolution (the
         preset's denoiser on a 1.0° grid, mesh-6, its transformer cut to
         GENCAST_0P25_CHECK_LAYERS layer: a 0.25° evaluation on the CPU
         takes minutes): one preconditioned evaluation at σ = 1 in f32 and
         bf16 on the CPU, then the same module moved to the card, with the
         small phase's noise-floor rule per variable.
  triblock  triblockdiag_mha (models/sparse_transformer.py; plain torch,
         as it is plain XLA in the JAX package) at the GenCast 1.0° shape
         (the mesh-5 k-hop-16 mask in patch order, x [1, 10242, 512], 4
         heads), f32: output and the gradients of x and the attention's
         weights for a random cotangent on the card against the CPU, max-abs
         within 5e-4 of each one's largest element; then the ensemble
         phase's members scored with evaluation.crps_ensemble on the card
         against the CPU (relative 1e-5).
  k1p    the pipelined edge kernel (K1p) against its plain version and
         against K1 on the same inputs: processor mode on the mesh-6
         multi-mesh, encoder mode on the 0.25° grid2mesh set, embed mode on
         the 1.0° GenCast and the 0.25° grid2mesh sets; e' and the receiver
         sums equal to K1's bit for bit; K1p's registers, spills and shared
         memory; K1p ms beside K1 ms and its products as bf16 cuBLAS GEMMs
         (timed in turns: K1p, K1, GEMMs, GEMMs, K1, K1p), plain ms and the
         bound; then one K4 backward behind a K1p forward through
         fused_edge, every gradient equal to the one behind K1.
  main_pipelined  the main path of main with GC_PIPELINED_EDGE=1: the same
         weights, inputs and rollout_final, K1p 16 + 1 launches a step and
         K1 none; the final state against main's, per variable (relative
         RMS within 1e-2; its max-abs difference printed, 0 expected, as
         K1p equals K1 bit for bit); s/step of both runs and the peak
         memory.
  bench  the benchmark mirror's main() (python3 -m graphcast_tpu_torch.bench)
         with BENCH_FALLBACK_ONLY=1, BENCH_NUM_STEPS=BENCH_STEPS and
         GC_PIPELINED_EDGE=1: the GenCast 1.0° 12 h step (K1p in embed mode,
         39 a step) and the 1.0° GraphCast fallback rollout (K1p processor
         and encoder modes); checks its lines' keys and metric names and
         that K1p ran where K1 would have.
  train_curve  the training curve driver (graphcast_tpu_torch/tools/
         train_curve.py) in process: GraphCast 1.0°, 13 levels, mesh-5,
         latent 512, 16 steps in its form (fused processor, √N remat,
         per-step checkpoints, bf16) for CURVE_STEPS steps on a fixed
         batch, and GenCast 1p0deg unfused for CURVE_GENCAST_STEPS; checks
         every loss finite, GraphCast's last CURVE_WINDOW losses' mean
         below its first CURVE_WINDOW's, and each path's kernels launched
         (K1, K4, the weight-gradient reduction, K3 and its sender mode;
         K6, K7, K8 and K3).
  gencast_rollout  the ensemble rollout driver (tools/
         bench_gencast_rollout.py) at 1.0°, ROLLOUT_MEMBERS members x
         GENCAST_ROLLOUT_STEPS 12 h steps after a one-step warm-up: seconds
         per member-step; checks finite output of the template's shape,
         distinct members, K3 and K6 launched, and a rerun bit-equal with
         torch's deterministic algorithms off.
  bench_train  the train-step drivers (tools/bench_train_025.py at 1.0°
         AR-2 in its training form, tools/bench_train_gencast.py at 1.0°),
         one timed step each after a first: seconds, peak GB, their JSON
         records, the kernels each path launched.
  memdump  the memory breakdown driver (tools/memdump_train_025.py) at
         1.0° AR-2 (37 levels, its chunked training form): the step run
         once with the allocator's history on, the blocks live at the
         peak grouped by the port's allocating line; checks that they sum
         to within MEMDUMP_RTOL of the peak torch.cuda reports for the
         step.

  hidden_layers  zoo.graphcast() (0.25°, 37 levels, mesh-6, latent 512, 16
         message-passing steps) with HL_DEPTH hidden layers in every MLP,
         random weights from seed 0, bf16, batch 1: the fused kernels
         compute one hidden layer, so the model runs the general path
         (K3 sums, RowGather gathers). (a) Autoregressive(
         InputsAndResiduals(Bfloat16Cast(GraphCast))).rollout_final over
         ROLLOUT_STEPS steps of main's ERA5-shaped data, in turns with the
         same model at hidden_layers=1 (the fused path): s/step of each
         run, K3 launches and row gathers a step, no fused kernel
         launched, and each model's peak GB in a run of its own (the other
         freed), the reruns' final states bit-equal; (b) the AR-1
         training step in the JAX package's 0.25° form (form B, tools/
         bench_train_025.py: chunked encoder and decoder, processor remat)
         at HL_DEPTH and then at 1: the first step's seconds, a rerun from
         the same parameters bit-equal in the loss and every gradient,
         s/step (least of HL_TRAIN_STEPS), peak GB, K3 launches and row
         gathers a step.
  gencast_hidden_layers  zoo.gencast_1p0deg() with HL_DEPTH hidden layers
         (the general path at batch 1: K3 twice an evaluation, K6 once a
         layer an evaluation): one 12 h step of 39 evaluations after a
         warm-up, s/step, peak GB, launches, finite samples; then a
         training step (NaN SST) after a warm-up step: s, peak GB, finite
         losses, changed parameters, K6, K7 and K8 once a layer and K3.
  hidden_layers_small  on the card against the port on the CPU, with the
         small phases' noise-floor rule: GraphCast at HL_SMALL_MODEL with
         each of HL_SMALL_DEPTHS hidden layers (one step, and the AR-1
         loss with every gradient), GenCast Mini (its transformer cut to
         HL_MINI_LAYERS) at HL_DEPTH (one evaluation, and the loss with
         every gradient at σ = HL_MINI_SIGMA on numpy noise), and a
         DeepGraphNet with each option of HL_GNN_OPTIONS and each
         activation name (its outputs and every gradient, K3 summing the
         receivers).

Kernel-vs-twin tolerances (both sides round at the same points and differ
only in f32 summation order, which flips an occasional bf16 rounding):
relative RMS error <= 1e-2 and max-abs error <= 0.125 on outputs of
magnitude up to ~8 (a few bf16 ulps there). Backward kernels: relative RMS
<= 1e-2 per gradient (the kernels round the cotangents to bf16 where the
TPU backward does, autograd of the twin where the twin's casts are).
Weight-gradient reduction: relative RMS <= 1e-4 (the same exact bf16
products summed in f32, in another order). Block-sparse attention: o at the
forward tolerance (the kernel rounds the unnormalised weights to bf16, the
plain version the normalised ones), lse max-abs <= 1e-3. K1's embed-mode
sums over the real GenCast edge sets may also differ by 2^-8 per summed
edge (``_check_close``): at the poles hundreds of edges that share one raw
feature row meet one mesh node, and a rounding flip in that row's bf16
embedding moves all of them the same way. K1p against K1: e' and the
receiver sums bit-equal (the same wgmma sequence per 64-column chunk, the
same LayerNorm sums, the same fixed-order run sums); each gradient behind
a K1p forward equal to the one behind K1. No kernel sums with atomics:
every rerun check is bit-equal in every output.

Each kernel's line in the JSON carries its bound: the least time the card
could take for the same work, the larger of the bytes it must move (inputs
read once, outputs written once) over 3.35 TB/s and its operations over
989 TFLOP/s (bf16 tensor cores; K3's f32 adds over 67 TFLOP/s), with which
of the two bounds it. K3 against its plain version: the same tolerances (it
sums in f32 in a fixed order, the plain version with atomics in f32, and
both round once to bf16).

Any failed phase exits non-zero. On success the last lines are the total
seconds, the card's name and power limit, a JSON line describing each
kernel, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

KERNEL_RTOL = 1e-2      # relative RMS error, kernel vs twin
KERNEL_ATOL = 0.125     # max-abs error, kernel vs twin
GRAD_RTOL = 1e-2        # relative RMS error per gradient, K4/K5 vs autograd
WGRAD_RTOL = 1e-4       # relative RMS error, weight-gradient reduction
SMALL_EPS = 1e-4        # noise-floor slack, relative to rms(cpu f32)
ROLLOUT_STEPS = 4
TRAIN_STEPS = 3
K5_NODES = 131_072
TRAIN_SMALL_MP_STEPS = 2
LSE_ATOL = 1e-3         # max-abs error of the attention's logsumexp
GENCAST_STEPS = 2
SST_NAN_ROWS = 10       # latitude rows of NaN SST in the GenCast train data
GENCAST_TRAIN_SMALL_SIGMA = 1.0
ENSEMBLE_MEMBERS = 4    # GenCast ensemble members, the batch axis
ENSEMBLE_STEPS = 1      # timed 12 h chunks of the ensemble rollout
BATCH = 4               # GraphCast_small batch of the graphcast_batch phase
BATCH_STEPS = 2         # its timed 6 h steps
MAIN_PIPELINED_RTOL = 1e-2  # relative RMS per variable, vs main's final
BENCH_STEPS = 4         # the bench phase's BENCH_NUM_STEPS
SP_SHARDS = (2, 4)      # sequence-parallel shard counts of sp_attention
SP_DKV_RTOL = 1e-2      # relative RMS, summed dk/dv partials vs whole K8
SHARED_CARD_WORLD = 2   # processes of the shared_card phase, one card
# (kernel, seconds) that each shared_card process launches back to back.
SHARED_CARD_PLAN = (("k2", 20.0), ("k5", 20.0), ("k1", 10.0), ("k4", 10.0),
                    ("k6", 10.0))
PARALLEL_WORLD = 2      # ranks of the parallel phase
PARALLEL_STEPS = 2      # its timed data-parallel train steps
SP_TRAIN_RTOL = 1e-2    # bf16 noise floor: sp vs unsharded loss and grads
PEAK_FLOPS = 989e12     # H100 SXM, dense bf16 tensor cores
PEAK_F32 = 67e12        # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3, bytes/s
DEVICE = "cuda"
PHASES = ("build", "shared_card", "geometry", "k1", "k2", "k4", "k5", "wgrad", "k6",
          "k7k8", "sp_attention", "embed", "embed_bwd", "k3", "main", "small",
          "train", "train_forms", "train_small", "gencast", "gencast_small",
          "gencast_train", "gencast_train_small", "ensemble", "ensemble_small",
          "graphcast_batch", "parallel", "forecast", "gencast_0p25",
          "ensemble_0p25_chunked", "triblock", "k1p", "main_pipelined",
          "bench", "train_curve", "gencast_rollout", "bench_train",
          "memdump", "hidden_layers", "gencast_hidden_layers",
          "hidden_layers_small")


_last_log = [""]  # the last phase line, repeated on stderr if a phase fails


def _log(phase, t0, **fields):
  parts = " ".join(f"{k}={v}" for k, v in fields.items())
  _last_log[0] = f"[{phase}] {time.perf_counter() - t0:.1f}s {parts}"
  print(_last_log[0], flush=True)


def _failed_phase(tb) -> str:
  """The outermost phase function on a traceback, else the outermost named
  function of this script below main and the prelude's threads (a prelude
  part)."""
  here = [f.f_code.co_name for f, _ in traceback.walk_tb(tb)
          if f.f_code.co_filename == __file__]
  named = [n for n in here
           if n not in ("<module>", "<lambda>", "main", "run", "wait")]
  return next((n for n in here if n.startswith("phase_")),
              named[0] if named else "?")


def _errors(got, want):
  d = got.float() - want.float()
  rms_ref = want.float().square().mean().sqrt().item()
  return (d.abs().max().item(),
          d.square().mean().sqrt().item() / max(rms_ref, 1e-30))


def _check_close(name, got, want, shared=None):
  """Kernel vs plain version within KERNEL_RTOL / KERNEL_ATOL. With
  ``shared`` ([N], from ``_shared_feature_rows``), output row n may also
  differ by shared[n]·2^-8, one bf16 ulp of a unit-RMS LayerNorm output
  per edge that shares its raw feature row: embed mode rounds each embedded
  edge row ``en`` to bf16 once, and where many of a receiver's edges carry
  the same raw row (the 360 grid points at a 1.0° pole, all at one place)
  a rounding flip in it shifts all their outputs the same way. Rows with
  no shared features get no allowance."""
  max_abs, rel_rms = _errors(got, want)
  excess = max_abs
  if shared is not None:
    excess = ((got.float() - want.float()).abs()
              - shared.float()[:, None] * 2.0 ** -8).max().item()
  if not (np.isfinite(max_abs) and excess <= KERNEL_ATOL
          and rel_rms <= KERNEL_RTOL):
    raise AssertionError(
        f"{name}: kernel vs twin max_abs={max_abs:.3g} (tol {KERNEL_ATOL}"
        f"{' + 2^-8 per shared-row edge' if shared is not None else ''}) "
        f"rel_rms={rel_rms:.3g} (tol {KERNEL_RTOL})")
  return max_abs, rel_rms


def _shared_feature_rows(torch, edges, features):
  """[num_receivers]: how many of each receiver's edges carry a raw feature
  row, as the kernel reads it (bf16), that another of its edges carries
  too."""
  key = torch.cat([edges.receivers.long()[:, None],
                   features.to(torch.bfloat16).view(torch.int16).long()], 1)
  _, inverse, counts = torch.unique(key, dim=0, return_inverse=True,
                                    return_counts=True)
  return torch.bincount(edges.receivers.long(),
                        weights=(counts[inverse] > 1).float(),
                        minlength=edges.num_receivers)


def _check_grads(phase, got: dict, want: dict, tol=GRAD_RTOL):
  """Relative RMS error of each gradient, all printed; raises if any is
  above ``tol``. Returns (worst max-abs error, {name: rel_rms})."""
  worst, rels = 0.0, {}
  for name, w in want.items():
    max_abs, rel = _errors(got[name], w)
    rels[name] = rel
    worst = max(worst, max_abs)
    print(f"[{phase}] grad {name}: max_abs={max_abs:.4g} rel_rms={rel:.3g}",
          flush=True)
  bad = {k: v for k, v in rels.items() if not (np.isfinite(v) and v <= tol)}
  if bad:
    raise AssertionError(f"{phase} grads above rel_rms {tol}: {bad}")
  return worst, rels


def _time_ms(torch, fn, reps=3):
  """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def _time_in_turns(torch, kernel, library, reps=3):
  """(kernel ms, library ms): ``_time_ms`` of each in turns, kernel,
  library, library, kernel, and the mean of each pair."""
  k1 = _time_ms(torch, kernel, reps)
  l1 = _time_ms(torch, library, reps)
  l2 = _time_ms(torch, library, reps)
  k2 = _time_ms(torch, kernel, reps)
  return (k1 + k2) / 2, (l1 + l2) / 2


def _kernel_usage(name):
  """ptxas's registers and spills of each compiled kernel whose (mangled)
  name holds ``name``, and its performance advisories (wgmma serialised),
  from this run's build log: [(kernel, text)]."""
  from graphcast_tpu_torch.native import build
  usage, kernel = [], None
  for ln in build.build_log().splitlines():
    if "Compiling entry function" in ln:
      kernel = ln.split("'")[1] if "'" in ln else ln
      continue
    if "Performance Loss" in ln and name in ln:  # ptxas's wgmma advisories
      usage.append((name, ln.split(":", 1)[-1].strip()))
      continue
    if kernel is None or name not in kernel:
      continue
    if "spill" in ln or "registers" in ln:
      usage.append((kernel, ln.split(":", 1)[-1].strip()))
  return usage


def _print_usage(phase, name, smem_bytes):
  usage = _kernel_usage(name)
  if not usage:
    print(f"[{phase}] {name}: not in this run's build log (prebuilt "
          "library)", flush=True)
  for kernel, text in usage:
    print(f"[{phase}] ptxas {kernel}: {text}", flush=True)
  print(f"[{phase}] {name} dynamic shared memory {smem_bytes} bytes",
        flush=True)


def _bound(flops, nbytes, peak_flops=PEAK_FLOPS):
  """{bound_ms, bound_by}: the larger of operations over their peak rate
  (bf16 tensor cores unless given) and bytes over the memory rate."""
  t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
  return {"bound_ms": 1e3 * max(t_ops, t_bytes),
          "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _edge_cost(E, n_snd, n_rcv, C, mode, F=4):
  """(FLOPs, bytes) of one K1 call: per edge row 2 (processor, We without
  e'), 1 (encoder, e' without We) or 3 (embed, plus the F-deep first layer)
  C x C products; e read, e' written where the mode writes it."""
  flops = {"processor": 4 * C * C, "we_nowrite": 4 * C * C,
           "encoder": 2 * C * C, "nowe_write": 2 * C * C,
           "embed": 6 * C * C + 2 * F * C}[mode] * E
  rows = {"processor": 2 * E * C * 2, "we_nowrite": E * C * 2,
          "encoder": E * C * 2, "nowe_write": 2 * E * C * 2,
          "embed": E * F * 2}[mode]
  mats = {"processor": 2, "we_nowrite": 2, "encoder": 1, "nowe_write": 1,
          "embed": 3}[mode] * C * C * 2
  nbytes = (rows + 8 * E + (n_snd + n_rcv) * C * 2 + n_rcv * C * 4 + mats
            + (F * C * 2 if mode == "embed" else 0))
  return flops, nbytes


def _decoder_cost(G, M, C, NO, embed, F=4):
  """(FLOPs, bytes) of one K2 call: per grid node gproj once, 3 edge MLPs,
  the node MLP (3 products) and the output MLP; embed mode adds the edge
  embedding and We' per edge slot."""
  flops = G * (16 * C * C + 2 * C * NO)
  const = 3 * G * (F if embed else C) * 2
  mats = (6 * C * C + C * NO) * 2
  if embed:
    flops += 3 * G * (2 * F * C + 4 * C * C)
    mats += (F * C + 2 * C * C) * 2
  nbytes = (G * C * 2 + M * C * 2 + const + 12 * G + G * NO * 2 + mats)
  return flops, nbytes


def _entry(name, source, replaces, **fields):
  return {"name": name, "route": "cuda",
          "source": f"graphcast_tpu_torch/csrc/{source}",
          "replaces": replaces, "library_ms": None, **fields}


def _randn(torch, gen, shape, scale=1.0, dtype=None, offset=0.0):
  x = torch.randn(shape, generator=gen, device=DEVICE) * scale + offset
  return x.to(dtype) if dtype is not None else x


def _edge_case(torch, gen, edges, C, encoder):
  """Random K1 operands at the edge list's shapes (bf16 activations)."""
  bf16 = torch.bfloat16
  w = 1.0 / np.sqrt(C)
  args = dict(
      e=_randn(torch, gen, (edges.num_edges, C), 1.0, bf16),
      sproj=_randn(torch, gen, (edges.num_senders, C), 1.0, bf16),
      rproj=_randn(torch, gen, (edges.num_receivers, C), 1.0, bf16),
      we=None if encoder else _randn(torch, gen, (C, C), w),
      b0=None if encoder else _randn(torch, gen, (C,), 0.1),
      w1=_randn(torch, gen, (C, C), w),
      b1=_randn(torch, gen, (C,), 0.1),
      scale=_randn(torch, gen, (C,), 0.1, offset=1.0),
      offset=_randn(torch, gen, (C,), 0.1))
  return args


def phase_build(torch):
  from graphcast_tpu_torch.native import build
  t0 = time.perf_counter()
  build.load_library()
  usage = [ln.strip() for ln in build.build_log().splitlines()
           if "registers" in ln or "spill" in ln]
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  card = smi.stdout.strip().splitlines()[0]
  _log("build", t0, nvcc="ok", card=repr(card))
  for ln in usage:
    print(f"[build] ptxas {ln}", flush=True)
  units = sorted(build.unit_seconds().items(), key=lambda kv: -kv[1])
  if units:
    print("[build] nvcc_s_by_source " + " ".join(
        f"{name}={s:.1f}" for name, s in units), flush=True)
  return card


def phase_shared_card(torch):
  """Every kernel of SHARED_CARD_PLAN launched back to back in
  SHARED_CARD_WORLD processes that time-share the card (module doc)."""
  import tempfile
  from graphcast_tpu_torch.parallel import launch
  from graphcast_tpu_torch.tools import shared_card_study as study
  t0 = time.perf_counter()
  block_map = _k_hop_block_map(5)[1]
  torch.cuda.empty_cache()
  with tempfile.TemporaryDirectory(dir=os.path.dirname(
      os.path.abspath(__file__))) as out_dir:
    launch.spawn(study.hammer, SHARED_CARD_WORLD,
                 args=(out_dir, SHARED_CARD_PLAN, block_map), device="cuda",
                 timeout_s=300)
    spawn_s = time.perf_counter() - t0
    reports = study.collect(out_dir, SHARED_CARD_WORLD,
                            study.reference(SHARED_CARD_PLAN, block_map))
  torch.cuda.empty_cache()
  per_rank = lambda key, fmt: {  # noqa: E731
      f"{k}_{key}": "/".join(fmt(r["kernels"][k][key]) for r in reports)
      for k, _ in SHARED_CARD_PLAN}
  _log("shared_card", t0, processes=SHARED_CARD_WORLD,
       spawn_s=f"{spawn_s:.1f}", errors=0,
       last_outputs="bit-equal to one process", **per_rank("launches", str),
       **per_rank("device_s", lambda s: f"{s:.1f}"))


def _geometry(resolution, mesh_size):
  """GraphCast's multimesh artifact, the one its models take (built once
  per run: artifact_lib.cached_artifact)."""
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.geometry import artifact as artifact_lib
  lat, lon = synthetic.grid_coords(resolution)
  return artifact_lib.cached_artifact(lat, lon, mesh_size)


def _edge_products(mode, backward):
  """(K, N, transposed) of each C x C product that K1 (or K4) runs per
  edge row: K1 W1, after We (processor, and We without e') and Ew1 (embed);
  K4 the same forward, then W1^T, We^T and Ew1^T."""
  sq, sqt = (512, 512, False), (512, 512, True)
  n = {"processor": 2, "we_nowrite": 2, "encoder": 1, "nowe_write": 1,
       "embed": 3}[mode]
  return [sq] * n + ([sqt] * n if backward else [])


def phase_k1(torch, art, results):
  """K1 against its plain version in every mode at C = 512 (processor and
  the two other We / e' combinations on the mesh-6 multimesh, encoder on
  the 0.25° grid2mesh set), each timed in turns with its products as bf16
  cuBLAS GEMMs (gemm_ms)."""
  from graphcast_tpu_torch.ops.fused_edge import (
      EdgeIndex, fused_edge, fused_edge_reference, smem_layout)
  t0 = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(1)
  C = 512
  g, m = art.num_grid_nodes, art.num_mesh_nodes
  _print_usage("k1", "fused_edge_kernel", smem_layout(C)["total"])
  mesh = EdgeIndex(art.mesh.senders, art.mesh.receivers, m, m, DEVICE)
  # (mode, edge list, has We, writes e')
  cases = [("processor", mesh, True, True),
           ("encoder", EdgeIndex(art.grid2mesh.senders,
                                 art.grid2mesh.receivers, g, m, DEVICE),
            False, False),
           ("we_nowrite", mesh, True, False),
           ("nowe_write", mesh, False, True)]
  for mode, edges, has_we, write in cases:
    args = _edge_case(torch, gen, edges, C, encoder=not has_we)
    with torch.inference_mode():
      got = fused_edge(edges, write_edges=write, **args)
      want = fused_edge_reference(edges, write_edges=write, **args)
      torch.cuda.synchronize()
      pairs = [("agg", got, want)] if not write else [
          ("e_out", got[0], want[0]), ("agg", got[1], want[1])]
      errs = {}
      for name, a, b in pairs:
        errs[name] = _check_close(f"k1 {mode} {name}", a, b)
      del got, want
      gemms = _gemm_yardstick(torch, gen, edges.num_edges,
                              _edge_products(mode, backward=False))
      ms, gemm_ms = _time_in_turns(torch, lambda: fused_edge(
          edges, write_edges=write, **args), gemms)
      del gemms
      plain_ms = _time_ms(torch, lambda: fused_edge_reference(
          edges, write_edges=write, **args))
    key = {"processor": "fused_edge", "encoder": "fused_edge_encoder"}.get(
        mode, "fused_edge_" + mode)
    results[key] = _entry(
        key, "fused_edge.cu" if has_we else "fused_edge_encoder.cu",
        "graphcast_tpu/ops/pallas_edge.py:116", mode=mode, launches=None,
        max_abs_err=max(e[0] for e in errs.values()), ms=ms,
        plain_ms=plain_ms, gemm_ms=gemm_ms, **_bound(*_edge_cost(
            edges.num_edges, edges.num_senders, edges.num_receivers, C,
            mode)))
    _log("k1", t0, mode=mode, edges=edges.num_edges,
         **{f"{n}_max_abs": f"{e[0]:.4g}" for n, e in errs.items()},
         **{f"{n}_rel_rms": f"{e[1]:.3g}" for n, e in errs.items()},
         ms=f"{ms:.3f}", gemm_ms=f"{gemm_ms:.3f}",
         plain_ms=f"{plain_ms:.3f}",
         bound_ms=f"{results[key]['bound_ms']:.4f}")
    del args
    torch.cuda.empty_cache()


def phase_k2(torch, art, results):
  from graphcast_tpu_torch.ops.fused_decoder import (
      MATRICES, VECTORS, fused_decode, fused_decode_reference, smem_layout)
  from graphcast_tpu_torch.ops.fused_edge import EdgeIndex
  t0 = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(2)
  C, num_out = 512, 227
  bf16 = torch.bfloat16
  g, m = art.num_grid_nodes, art.num_mesh_nodes
  edges = EdgeIndex(art.mesh2grid.senders, art.mesh2grid.receivers, m, g,
                    DEVICE)
  w = 1.0 / np.sqrt(C)
  weights = {k: _randn(torch, gen, (C, C), w) for k in MATRICES}
  weights["wd1"] = _randn(torch, gen, (C, num_out), w)
  weights.update({k: _randn(torch, gen, (C,), 0.1) for k in VECTORS})
  weights["bd1"] = _randn(torch, gen, (num_out,), 0.1)
  for k in ("escale", "nscale"):
    weights[k] = weights[k] + 1.0
  grid = _randn(torch, gen, (g, C), 1.0, bf16)
  mesh_proj = _randn(torch, gen, (m, C), 1.0, bf16)
  const = _randn(torch, gen, (3 * g, C), 1.0, bf16)
  _print_usage("k2", "fused_decoder_kernel",
               smem_layout(C, num_out)["total"])
  with torch.inference_mode():
    got = fused_decode(edges, grid, mesh_proj, const, weights)
    want = fused_decode_reference(edges, grid, mesh_proj, const, weights)
    torch.cuda.synchronize()
    max_abs, rel_rms = _check_close("k2 out", got, want)
    del want
    torch.cuda.empty_cache()
    # The products-only yardstick: the kernel's 11 products per node as
    # bf16 cuBLAS GEMMs over all nodes, timed in turns with the kernel.
    gemms = _gemm_yardstick(torch, gen, g, _decoder_products(
        C, 256, embed=False, backward=False))
    ms, gemm_ms = _time_in_turns(torch, lambda: fused_decode(
        edges, grid, mesh_proj, const, weights), gemms)
    del gemms
    torch.cuda.empty_cache()
    plain_ms = _time_ms(torch, lambda: fused_decode_reference(
        edges, grid, mesh_proj, const, weights), reps=1)
  results["fused_decoder"] = _entry(
      "fused_decoder", "fused_decoder.cu",
      "graphcast_tpu/ops/pallas_decoder.py:76", mode="plain", launches=None,
      max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, gemm_ms=gemm_ms,
      **_bound(*_decoder_cost(g, m, C, num_out, embed=False)))
  _log("k2", t0, grid_nodes=g, outputs=num_out, max_abs=f"{max_abs:.4g}",
       rel_rms=f"{rel_rms:.3g}", ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}",
       gemm_ms=f"{gemm_ms:.3f}",
       bound_ms=f"{results['fused_decoder']['bound_ms']:.4f}")
  del grid, mesh_proj, const, got
  torch.cuda.empty_cache()


def _autograd(torch, fn, leaves: dict, cotangents, names):
  """(grads by name, backward ms) of torch.autograd.grad through ``fn``."""
  outs = fn(**leaves)
  outs = outs if isinstance(outs, tuple) else (outs,)
  inputs = [leaves[k] for k in names]
  grads = torch.autograd.grad(outs, inputs, cotangents, retain_graph=True)
  ms = _time_ms(torch, lambda: torch.autograd.grad(
      outs, inputs, cotangents, retain_graph=True), reps=1)
  return dict(zip(names, grads)), ms


def _k4_rerun_bit_equal(torch, phase, run):
  """Runs a backward twice ({name: gradient} each): every output must be
  bit-equal."""
  first, again = run(), run()
  for name, a in first.items():
    if not torch.equal(a, again[name]):
      raise AssertionError(
          f"{phase}: two runs differ in {name} by "
          f"{(a.float() - again[name].float()).abs().max().item():.3g}")


def phase_k4(torch, art, results):
  from graphcast_tpu_torch.ops.fused_edge import (
      EdgeIndex, fused_edge, fused_edge_backward, fused_edge_reference,
      smem_layout)
  t0 = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(4)
  C = 512
  g, m = art.num_grid_nodes, art.num_mesh_nodes
  _print_usage("k4", "fused_edge_bwd_kernel",
               smem_layout(C, backward=True)["total"])
  cases = {
      "processor": (EdgeIndex(art.mesh.senders, art.mesh.receivers, m, m,
                              DEVICE), False),
      "encoder": (EdgeIndex(art.grid2mesh.senders, art.grid2mesh.receivers,
                            g, m, DEVICE), True),
  }
  entry = _entry("fused_edge_bwd", "fused_edge_bwd.cu",
                 "graphcast_tpu/ops/pallas_edge.py:299", launches=None)
  worst = 0.0
  for mode, (edges, encoder) in cases.items():
    args = _edge_case(torch, gen, edges, C, encoder)
    if not encoder:
      args["we"] = args["we"].to(torch.bfloat16)  # as the model passes it
    leaves = {k: None if v is None else v.requires_grad_()
              for k, v in args.items()}
    names = [k for k, v in leaves.items() if v is not None]
    d_agg = _randn(torch, gen, (edges.num_receivers, C))
    d_eout = None if encoder else _randn(torch, gen, (edges.num_edges, C),
                                         1.0, torch.bfloat16)
    cot = (d_agg,) if encoder else (d_eout, d_agg)
    write = not encoder

    def run(fn):
      return lambda **kw: fn(edges, write_edges=write, **kw)

    got, _ = _autograd(torch, run(fused_edge), leaves, cot, names)
    want, plain_ms = _autograd(torch, run(fused_edge_reference), leaves, cot,
                               names)
    torch.cuda.synchronize()
    max_abs, rels = _check_grads(f"k4 {mode}", got, want)
    worst = max(worst, max_abs)
    del want
    torch.cuda.empty_cache()
    det = {k: None if v is None else v.detach() for k, v in args.items()}
    det.pop("offset")

    def k4():
      names = ("e", "sproj", "rproj", "we", "b0", "w1", "b1", "scale",
               "offset")
      out = fused_edge_backward(edges, d_eout=d_eout, d_agg=d_agg, **det)
      return {k: v for k, v in zip(names, out) if v is not None}

    # Every sum in a fixed order: a rerun is bit-equal in every gradient.
    _k4_rerun_bit_equal(torch, f"k4 {mode}", k4)
    # In turns with the kernel's products as bf16 cuBLAS GEMMs over the same
    # rows (gemm_ms); the per-row kernel's own device time (kernel_ms).
    gemms = _gemm_yardstick(torch, gen, edges.num_edges,
                            _edge_products(mode, backward=True))
    ms, gemm_ms = _time_in_turns(torch, k4, gemms)
    del gemms
    kernel_ms = _device_ms(torch, k4, ("fused_edge_bwd_kernel",),
                           reps=3)["fused_edge_bwd_kernel"]
    suffix = "" if mode == "processor" else "_encoder"
    entry["ms" + suffix] = ms
    entry["plain_ms" + suffix] = plain_ms
    entry["gemm_ms" + suffix] = gemm_ms
    entry["kernel_ms" + suffix] = kernel_ms
    # The backward recomputes the forward (processor: 2 products, encoder:
    # 1) and takes 2 products per forward product; it reads the forward's
    # inputs and the cotangents, writes de (dgs), the node and weight grads.
    fwd_flops, fwd_bytes = _edge_cost(edges.num_edges, edges.num_senders,
                                      edges.num_receivers, C, mode)
    bound = _bound(3 * fwd_flops,
                   2 * fwd_bytes + 2 * edges.num_edges * C * 2)
    entry.update({k + suffix: v for k, v in bound.items()})
    _log("k4", t0, mode=mode, edges=edges.num_edges,
         worst_rel_rms=f"{max(rels.values()):.3g}", bit_equal_rerun=True,
         ms=f"{ms:.3f}", kernel_ms=f"{kernel_ms:.3f}",
         gemm_ms=f"{gemm_ms:.3f}", plain_ms=f"{plain_ms:.3f}",
         bound_ms=f"{entry['bound_ms' + suffix]:.4f}")
    del args, leaves, got, det, d_agg, d_eout, cot
    torch.cuda.empty_cache()
  entry["max_abs_err"] = worst
  results["fused_edge_bwd"] = entry


def phase_k5(torch, art, results):
  from graphcast_tpu_torch.ops import fused_decoder
  from graphcast_tpu_torch.ops.fused_decoder import (
      KEYS, MATRICES, VECTORS, fused_decode, fused_decode_backward,
      fused_decode_reference, smem_layout)
  from graphcast_tpu_torch.ops.fused_edge import EdgeIndex
  t0 = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(5)
  C, num_out = 512, 227
  bf16 = torch.bfloat16
  m = art.num_mesh_nodes
  w = 1.0 / np.sqrt(C)
  weights = {k: _randn(torch, gen, (C, C), w) for k in MATRICES}
  weights["wd1"] = _randn(torch, gen, (C, num_out), w)
  weights.update({k: _randn(torch, gen, (C,), 0.1) for k in VECTORS})
  weights["bd1"] = _randn(torch, gen, (num_out,), 0.1)
  for k in ("escale", "nscale"):
    weights[k] = weights[k] + 1.0

  def operands(g):
    edges = EdgeIndex(art.mesh2grid.senders[:3 * g],
                      art.mesh2grid.receivers[:3 * g], m, g, DEVICE)
    return edges, dict(grid=_randn(torch, gen, (g, C), 1.0, bf16),
                       mesh_proj=_randn(torch, gen, (m, C), 1.0, bf16),
                       const=_randn(torch, gen, (3 * g, C), 1.0, bf16))

  edges, acts = operands(K5_NODES)
  leaves = {**acts, **weights}
  leaves = {k: v.requires_grad_() for k, v in leaves.items()}
  names = ["grid", "mesh_proj", "const", *KEYS]
  dout = _randn(torch, gen, (K5_NODES, num_out), 1.0, bf16)

  def run(fn):
    return lambda grid, mesh_proj, const, **w: fn(edges, grid, mesh_proj,
                                                  const, w)

  got, _ = _autograd(torch, run(fused_decode), leaves, (dout,), names)
  want, plain_ms = _autograd(torch, run(fused_decode_reference), leaves,
                             (dout,), names)
  torch.cuda.synchronize()
  max_abs, rels = _check_grads("k5", got, want)
  del want, got, leaves
  torch.cuda.empty_cache()
  det = {k: v.detach() for k, v in weights.items()}
  acts = {k: v.detach() for k, v in acts.items()}

  def k5():
    dgrid, dmesh, dconst, dw = fused_decode_backward(
        edges, acts["grid"], acts["mesh_proj"], acts["const"], det, dout)
    return {"grid": dgrid, "mesh_proj": dmesh, "const": dconst, **dw}

  _print_usage("k5", "fused_decoder_bwd_kernel",
               smem_layout(C, num_out, backward=True)["total"])
  # The products-only yardstick: the per-node kernel's 25 products as bf16
  # cuBLAS GEMMs over the chunk, timed in turns with the whole backward
  # (kernel, 7 weight-gradient reductions, scatter); the kernel's own
  # device time from the profiler.
  gemms = _gemm_yardstick(torch, gen, K5_NODES, _decoder_products(
      C, 256, embed=False, backward=True))
  ms, gemm_ms = _time_in_turns(torch, k5, gemms)
  del gemms
  kernel_ms = _device_ms(torch, k5, ("fused_decoder_bwd_kernel",),
                         reps=3)["fused_decoder_bwd_kernel"]
  # Every sum in a fixed order (mesh_proj's by K3's sender mode): a rerun
  # at the same chunking is bit-equal in every gradient.
  one_chunk = k5()
  again = k5()
  for k in one_chunk:
    if not torch.equal(one_chunk[k], again[k]):
      raise AssertionError(f"k5: two runs differ in {k} by "
                           f"{(one_chunk[k] - again[k]).abs().max().item():.3g}")
  del again
  # The 131,072 nodes above are one of the wrapper's node chunks; the train
  # path runs 8. The same call in uneven chunks (partial last tiles) must
  # agree within the backward tolerance.
  chunk_nodes = fused_decoder.BWD_CHUNK_NODES
  fused_decoder.BWD_CHUNK_NODES = K5_NODES // 3 + 1
  try:
    chunked = k5()
  finally:
    fused_decoder.BWD_CHUNK_NODES = chunk_nodes
  _, chunk_rels = _check_grads("k5 chunked", chunked, one_chunk)
  del edges, acts, dout, one_chunk, chunked
  torch.cuda.empty_cache()
  g = art.num_grid_nodes
  edges, acts = operands(g)
  dout = _randn(torch, gen, (g, num_out), 1.0, bf16)
  ms_full = _time_ms(torch, lambda: fused_decode_backward(
      edges, acts["grid"], acts["mesh_proj"], acts["const"], det, dout))
  _log("k5", t0, grid_nodes=K5_NODES, edges=3 * K5_NODES,
       worst_rel_rms=f"{max(rels.values()):.3g}",
       chunked_worst_rel_rms=f"{max(chunk_rels.values()):.3g}",
       bit_equal_rerun=True, ms=f"{ms:.3f}", kernel_ms=f"{kernel_ms:.3f}",
       gemm_ms=f"{gemm_ms:.3f}", plain_ms=f"{plain_ms:.3f}",
       full_grid_nodes=g, ms_full=f"{ms_full:.3f}")
  # The backward recomputes the forward and takes 2 products per forward
  # product; it reads the forward's inputs and dout, writes dgrid, dconst,
  # dmesh_proj and the weight grads (f32).
  def bound(nodes):
    fwd_flops, fwd_bytes = _decoder_cost(nodes, m, C, num_out, embed=False)
    return _bound(3 * fwd_flops, 2 * fwd_bytes + 4 * nodes * C * 2)

  full = bound(g)
  print(f"[k5] full_grid_nodes={g} ms_full={ms_full:.3f} "
        f"bound_ms_full={full['bound_ms']:.4f} "
        f"bound_by_full={full['bound_by']}", flush=True)
  results["fused_decoder_bwd"] = _entry(
      "fused_decoder_bwd", "fused_decoder_bwd.cu",
      "graphcast_tpu/ops/pallas_decoder.py:160", launches=None,
      max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, ms_full_grid=ms_full,
      bound_ms_full_grid=full["bound_ms"], kernel_ms=kernel_ms,
      gemm_ms=gemm_ms, **bound(K5_NODES))
  del edges, acts, dout, det
  torch.cuda.empty_cache()


def _device_ms(torch, run, names, reps=5):
  """Device ms per call of ``run`` spent in kernels whose names hold each of
  ``names`` (the first that matches), from torch.profiler over ``reps``
  calls after a warm-up."""
  from torch.profiler import ProfilerActivity, profile
  run()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      run()
    torch.cuda.synchronize()
  total = dict.fromkeys(names, 0.0)
  for evt in prof.events():
    if evt.device_type != torch.autograd.DeviceType.CUDA:
      continue
    for name in names:
      if name in evt.name:
        total[name] += evt.time_range.elapsed_us() / 1e3
        break
  return {name: ms / reps for name, ms in total.items()}


def _wgrad_split(torch, run, reps=5):
  """Device ms per call of weight_grad's two kernels, the split-K product
  and the fixed-order reduction."""
  split = _device_ms(torch, run, ("weight_grad_reduce", "weight_grad_kernel"),
                     reps)
  return split["weight_grad_kernel"], split["weight_grad_reduce"]


def _decoder_products(C, NO, embed, backward):
  """(K, N, transposed) of each product that K2 (or K5) runs per grid node:
  K2 10 C x C products and the output layer (embed mode 6 more); K5 the
  forward's C x C ones, then dout @ Wd1^T, Wd0^T, Wn1^T, Wng^T, Wna^T, per
  edge slot Wr, W1, W1^T (embed: We', We'^T, Ew1^T) and Wr^T."""
  sq, sqt = (C, C, False), (C, C, True)
  fwd = [sq] * (16 if embed else 10)
  if not backward:
    return fwd + [(C, NO, False)]
  slot = [sq, sq, sqt] + ([sq, sqt, sqt] if embed else [])
  return fwd + [(NO, C, True)] + [sqt] * 4 + slot * 3 + [sqt]


def _gemm_yardstick(torch, gen, rows, products):
  """The products-only yardstick of a decoder kernel: each of ``products``
  as one bf16 cuBLAS GEMM [rows, K] @ [K, N] (a transposed weight as a
  W.t() view) into preallocated outputs; returns the call."""
  bf16 = torch.bfloat16
  x = _randn(torch, gen, (rows, max(k for k, _, _ in products)), 1.0, bf16)
  ws, outs = {}, {}
  for k, n, t in products:
    if (k, n, t) not in ws:
      w = _randn(torch, gen, (n, k) if t else (k, n), 0.05, bf16)
      ws[(k, n, t)] = w.t() if t else w
    if n not in outs:
      outs[n] = torch.empty(rows, n, dtype=bf16, device=DEVICE)

  def run():
    for k, n, t in products:
      torch.mm(x[:, :k], ws[(k, n, t)], out=outs[n])
  return run


def phase_wgrad(torch, results):
  from graphcast_tpu_torch.native import build
  from graphcast_tpu_torch.ops import fused_decoder, fused_edge
  from graphcast_tpu_torch.ops.weight_grad import (
      weight_grad, weight_grad_reference)
  t0 = time.perf_counter()
  lib = build.load_library()
  for bn in (256, 128):
    _print_usage("wgrad", f"weight_grad_kernelILi{bn}E",
                 lib.gc_weight_grad_smem(bn))
  gen = torch.Generator(device=DEVICE).manual_seed(7)
  C, bf16 = 512, torch.bfloat16
  # (rows, K, N) of the train step's reductions: a K4 row chunk (dW1, dWe),
  # a K5 node chunk's edge rows (w1) and its output layer (wd1, 227
  # outputs padded to 256).
  cases = {"k4_chunk": (fused_edge.BWD_CHUNK_ROWS, C, C),
           "k5_w1": (3 * fused_decoder.BWD_CHUNK_NODES, C, C),
           "k5_wd1": (fused_decoder.BWD_CHUNK_NODES, C, 256)}
  entry = _entry("weight_grad", "weight_grad.cu",
                 "graphcast_tpu/ops/pallas_edge.py:299", launches=None,
                 also_replaces="graphcast_tpu/ops/pallas_decoder.py:160")
  worst = 0.0
  for name, (rows, k, n) in cases.items():
    a = _randn(torch, gen, (rows, k), 1.0, bf16)
    b = _randn(torch, gen, (rows, n), 1.0, bf16)
    got = torch.zeros(k, n, device=DEVICE)
    want = torch.zeros(k, n, device=DEVICE)
    weight_grad(a, b, got)
    weight_grad_reference(a, b, want)
    torch.cuda.synchronize()
    max_abs, rels = _check_grads(f"wgrad {name}", {"dw": got}, {"dw": want},
                                 WGRAD_RTOL)
    worst = max(worst, max_abs)
    # The partials are summed in a fixed order: a second run is bit-equal.
    again = torch.zeros(k, n, device=DEVICE)
    weight_grad(a, b, again)
    if not torch.equal(got, again):
      raise AssertionError(f"wgrad {name}: two runs differ by "
                           f"{(got - again).abs().max().item():.3g}")
    # The library yardstick: one cuBLAS bf16 product (bf16 output), timed
    # in turns with the kernel, 20 calls a turn: the host's ~30 us of
    # preparation per call is hidden behind the queue after the first.
    ms, library_ms = _time_in_turns(
        torch, lambda: weight_grad(a, b, got), lambda: a.t() @ b, reps=20)
    plain_ms = _time_ms(torch, lambda: weight_grad_reference(a, b, want))
    main_ms, reduce_ms = _wgrad_split(torch, lambda: weight_grad(a, b, got))
    suffix = "" if name == "k4_chunk" else "_" + name
    entry["ms" + suffix] = ms
    entry["plain_ms" + suffix] = plain_ms
    entry["library_ms" + suffix] = library_ms
    entry["main_pass_ms" + suffix] = main_ms
    entry["reduce_pass_ms" + suffix] = reduce_ms
    entry.update({key + suffix: v for key, v in _bound(
        2 * rows * k * n, rows * (k + n) * 2 + 2 * k * n * 4).items()})
    _log("wgrad", t0, case=name, rows=rows, k=k, n=n,
         max_abs=f"{max_abs:.4g}", rel_rms=f"{rels['dw']:.3g}",
         bit_equal_rerun=True, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}",
         library_ms=f"{library_ms:.4f}", main_pass_ms=f"{main_ms:.4f}",
         reduce_pass_ms=f"{reduce_ms:.4f}",
         bound_ms=f"{entry['bound_ms' + suffix]:.4f}")
    del a, b, got, want, again
  entry["max_abs_err"] = worst
  results["weight_grad"] = entry
  torch.cuda.empty_cache()


def _label(preset):
  mc = preset.model_config
  return (f"{preset.name}:{mc.resolution}deg/"
          f"{len(preset.task_config.pressure_levels)}lev/mesh{mc.mesh_size}/"
          f"latent{mc.latent_size}/{mc.gnn_msg_steps}mp")


def _wrap(model, task_config, bf16=True, **ar_kw):
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.wrappers import (
      Autoregressive, Bfloat16Cast, InputsAndResiduals)
  stddev, mean, diffs = synthetic.make_norm_stats(task_config)
  return Autoregressive(InputsAndResiduals(
      Bfloat16Cast(model, enabled=bf16), stddev_by_level=stddev,
      mean_by_level=mean, diffs_stddev_by_level=diffs), **ar_kw)


def _stack(torch, preset, seed, bf16=True, device=DEVICE, model_kw=None,
           **ar_kw):
  """(GraphCast, its training stack); ``model_kw``: the constructor's
  forms (chunks, fused_aggregation, remat_processor)."""
  from graphcast_tpu_torch.models.graphcast import GraphCast
  model = GraphCast(preset.model_config, preset.task_config,
                    **(model_kw or {}),
                    generator=torch.Generator().manual_seed(seed),
                    device=device)
  return model, _wrap(model, preset.task_config, bf16, **ar_kw)


def _profile_step(torch, run, out_dir, name="main_step"):
  """One profiled call of ``run``: writes the kernel-time table and chrome
  trace to ``out_dir`` (files named after ``name``) and prints device busy
  time and idle share."""
  import collections
  import pathlib
  from torch.profiler import ProfilerActivity, profile
  out = pathlib.Path(out_dir)
  out.mkdir(parents=True, exist_ok=True)
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  prof.export_chrome_trace(str(out / f"{name}_trace.json"))
  by_name = collections.defaultdict(float)
  spans = []
  for evt in prof.events():
    if evt.device_type == torch.autograd.DeviceType.CUDA:
      by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
      spans.append((evt.time_range.start, evt.time_range.end))
  busy_us, end = 0.0, float("-inf")
  for a, b in sorted(spans):  # union of device intervals
    if b > end:
      busy_us += b - max(a, end)
      end = b
  top = sorted(by_name.items(), key=lambda kv: -kv[1])
  with open(out / f"{name}_kernels.txt", "w") as f:
    f.write(f"wall_ms {wall_ms:.3f} device_busy_ms {busy_us / 1e3:.3f}\n")
    for kernel, ms in top:
      f.write(f"{ms:10.3f} ms  {kernel}\n")
  _log("profile", time.perf_counter(), step=name, wall_ms=f"{wall_ms:.2f}",
       device_busy_ms=f"{busy_us / 1e3:.2f}",
       idle_share=f"{1 - busy_us / 1e3 / wall_ms:.3f}",
       device_events=len(spans), table=str(out / f"{name}_kernels.txt"))
  for kernel, ms in top[:12]:
    print(f"[profile] {ms:9.3f} ms  {kernel[:110]}", flush=True)


@functools.lru_cache(maxsize=None)
def _main_data(torch):
  """The main path's batch-1 bf16 inputs, one-step targets template and
  ROLLOUT_STEPS steps of forcings on the card (main and main_pipelined)."""
  from graphcast_tpu_torch.examples.graphcast_demo import (
      era5_inputs_targets_forcings)
  from graphcast_tpu_torch.models import zoo
  preset = zoo.graphcast()
  # An ERA5-shaped series made from a seed on the card (data/era5.py).
  inputs, targets, forcings = era5_inputs_targets_forcings(
      preset.task_config, preset.model_config.resolution, ROLLOUT_STEPS, 6,
      seed=0, device=DEVICE)
  bf16 = torch.bfloat16
  return (inputs.astype(bf16), targets.isel(time=slice(0, 1)).astype(bf16),
          forcings.astype(bf16))


_MAIN_FINAL = {}  # main's final state, for main_pipelined


def _main_rollout(torch, phase, profile_dir=None):
  """The main path (zoo.graphcast(), weights from seed 0): one warm-up
  step, then rollout_final over ROLLOUT_STEPS steps with every counter set
  to 0 just before it. Checks the final state's shapes and finiteness;
  returns (preset, predictor, final state, {setup_s, warm_s, rollout_s,
  peak_gb}, launch counts)."""
  from graphcast_tpu_torch.models import zoo
  t0 = time.perf_counter()
  preset = zoo.graphcast()
  _, predictor = _stack(torch, preset, seed=0)
  predictor = predictor.to(DEVICE)
  inputs, targets1, forcings_n = _main_data(torch)
  times = {"setup_s": time.perf_counter() - t0}
  # Warm-up: one step builds the graph (host) and its device statics.
  t1 = time.perf_counter()
  predictor.rollout_final(inputs, targets1,
                          forcings_n.isel(time=slice(0, 1)))
  torch.cuda.synchronize()
  times["warm_s"] = time.perf_counter() - t1

  torch.cuda.reset_peak_memory_stats()
  _reset_counters()
  t2 = time.perf_counter()
  final = predictor.rollout_final(inputs, targets1, forcings_n)
  torch.cuda.synchronize()
  times["rollout_s"] = time.perf_counter() - t2
  counts = {**{k: fn.launches for k, fn in _counters().items()},
            **_mode_counts()}
  times["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
  for name in final.var_names:
    f = final[name]
    if f.shape != inputs[name].shape:
      raise AssertionError(f"{phase} {name}: shape {f.shape} != "
                           f"{inputs[name].shape}")
    if not torch.isfinite(f.data.float()).all():
      raise AssertionError(f"{phase} {name}: non-finite values in the final "
                           "state")
  if profile_dir:
    _profile_step(torch, lambda: predictor.rollout_final(
        inputs, targets1, forcings_n.isel(time=slice(0, 1))), profile_dir,
                  f"{phase}_step")
  return preset, predictor, final, times, counts


def _worst_rel_rms(got, want):
  """The largest relative RMS error over the variables of two states."""
  return max(_errors(got.data(n), want.data(n))[1] for n in want.var_names)


def phase_main(torch, results, profile_dir=None):
  t0 = time.perf_counter()
  preset, predictor, final, times, counts = _main_rollout(torch, "main",
                                                          profile_dir)
  # The same rollout again: the kernels sum in a fixed order, so this is
  # the run-to-run noise of the rest of the path (0 expected).
  noise = _worst_rel_rms(predictor.rollout_final(*_main_data(torch)), final)
  del predictor
  _MAIN_FINAL.update(final=final, noise=noise,
                     s_per_step=times["rollout_s"] / ROLLOUT_STEPS)
  k1, k2 = counts["fused_edge"], counts["fused_decoder"]
  k1_encoder = counts["fused_edge_encoder"]
  steps_per = 1 + preset.model_config.gnn_msg_steps
  if (k1 != steps_per * ROLLOUT_STEPS or k2 != ROLLOUT_STEPS
      or k1_encoder != ROLLOUT_STEPS or counts["segment_sum"]
      or counts["fused_edge_pipelined_all"]):
    raise AssertionError(f"launch counts {counts}, expected K1 "
                         f"{steps_per * ROLLOUT_STEPS} ({ROLLOUT_STEPS} "
                         f"encoder), K2 {ROLLOUT_STEPS}, K3 and K1p 0")
  for name, n in (("fused_edge", k1 - k1_encoder),
                  ("fused_edge_encoder", k1_encoder), ("fused_decoder", k2)):
    results[name].update(launches=n, launches_per_step=n / ROLLOUT_STEPS)
  _log("main", t0, config=_label(preset),
       steps=ROLLOUT_STEPS, setup_s=f"{times['setup_s']:.1f}",
       warmup_1step_s=f"{times['warm_s']:.2f}",
       rollout_s=f"{times['rollout_s']:.3f}",
       s_per_step=f"{times['rollout_s'] / ROLLOUT_STEPS:.4f}",
       peak_mem_gb=f"{times['peak_gb']:.2f}", k1_launches=k1,
       k2_launches=k2, rerun_worst_rel_rms=f"{noise:.3g}", finite=True)


def phase_main_pipelined(torch, results, profile_dir=None):
  """main's path with GC_PIPELINED_EDGE=1 (module doc)."""
  import os
  t0 = time.perf_counter()
  if "final" not in _MAIN_FINAL:  # main did not run: its run is the reference
    phase_main(torch, {k: {} for k in ("fused_edge", "fused_edge_encoder",
                                       "fused_decoder")})
  saved = os.environ.get("GC_PIPELINED_EDGE")
  os.environ["GC_PIPELINED_EDGE"] = "1"  # read once, at the model's first call
  try:
    preset, _, final, times, counts = _main_rollout(
        torch, "main_pipelined", profile_dir)
  finally:
    if saved is None:
      del os.environ["GC_PIPELINED_EDGE"]
    else:
      os.environ["GC_PIPELINED_EDGE"] = saved
  steps_per = 1 + preset.model_config.gnn_msg_steps
  expected = {"fused_edge_pipelined_all": steps_per * ROLLOUT_STEPS,
              "fused_edge_pipelined_encoder": ROLLOUT_STEPS,
              "fused_edge_pipelined_embed": 0, "fused_edge": 0,
              "fused_decoder": ROLLOUT_STEPS, "segment_sum": 0}
  if any(counts[k] != n for k, n in expected.items()):
    raise AssertionError(f"main_pipelined launches {counts}, expected "
                         f"{expected}")
  worst = _worst_rel_rms(final, _MAIN_FINAL["final"])
  if not (np.isfinite(worst) and worst <= MAIN_PIPELINED_RTOL):
    raise AssertionError(f"main_pipelined: relative RMS {worst:.3g} against "
                         f"main's final state (tol {MAIN_PIPELINED_RTOL})")
  # K1p equals K1 bit for bit: 0 expected.
  max_abs = max(_errors(final.data(n), _MAIN_FINAL["final"].data(n))[0]
                for n in final.var_names)
  k1p = counts["fused_edge_pipelined_all"]
  k1p_encoder = counts["fused_edge_pipelined_encoder"]
  for name, n in (("fused_edge_pipelined", k1p - k1p_encoder),
                  ("fused_edge_pipelined_encoder", k1p_encoder)):
    results[name].update(launches=n, launches_per_step=n / ROLLOUT_STEPS)
  _log("main_pipelined", t0, config=_label(preset), steps=ROLLOUT_STEPS,
       setup_s=f"{times['setup_s']:.1f}",
       warmup_1step_s=f"{times['warm_s']:.2f}",
       s_per_step=f"{times['rollout_s'] / ROLLOUT_STEPS:.4f}",
       main_s_per_step=f"{_MAIN_FINAL['s_per_step']:.4f}",
       peak_mem_gb=f"{times['peak_gb']:.2f}",
       k1p_per_step=k1p // ROLLOUT_STEPS,
       k1p_encoder_per_step=k1p_encoder // ROLLOUT_STEPS,
       k1_per_step=counts["fused_edge"] // ROLLOUT_STEPS,
       worst_rel_rms_vs_main=f"{worst:.3g}", max_abs_vs_main=f"{max_abs:.3g}",
       main_rerun_worst_rel_rms=f"{_MAIN_FINAL['noise']:.3g}", finite=True)


SMALL_SEED = 3  # weights of the GraphCast_small phases
SMALL_MP_STEPS = 4  # message-passing steps of small and graphcast_batch


def _small_preset():
  """zoo.graphcast_small() with its processor cut to SMALL_MP_STEPS steps
  (for the CPU side's sake and the script's time limit), in the small and
  graphcast_batch phases."""
  from graphcast_tpu_torch.models import zoo
  preset = zoo.graphcast_small()
  return dataclasses.replace(preset, model_config=dataclasses.replace(
      preset.model_config, gnn_msg_steps=SMALL_MP_STEPS))


@functools.lru_cache(maxsize=None)
def _small_references(torch):
  """_small_preset()'s batch-1 synthetic (inputs, targets, forcings) on the
  CPU and one step of the port on the CPU from them, {bf16: out} for f32
  and bf16 (the small phase's noise floor). Built once: the
  graphcast_batch phase holds its member 0 to the same runs."""
  from graphcast_tpu_torch.data import synthetic
  preset = _small_preset()
  data = synthetic.make_example_batch(
      preset.task_config, resolution=preset.model_config.resolution, batch=1,
      device="cpu")
  outs = {}
  for bf16 in (False, True):
    _, cpu = _stack(torch, preset, seed=SMALL_SEED, bf16=bf16, device="cpu")
    with torch.inference_mode():
      outs[bf16] = cpu(*data)
  return data, outs


def _check_noise_floor(torch, phase, got, outs, names, ref=None):
  """The small phases' rule per variable: rms(got - ref) <= 2 * rms(cpu
  bf16 - cpu f32) + SMALL_EPS * rms(cpu f32), ``ref`` the CPU f32 run
  unless given. ``got`` and ``ref`` map each name to a tensor, ``outs`` is
  {bf16: FieldSet} of the CPU runs. Returns the worst error over its
  bound."""
  worst = 0.0
  for name in names:
    f32 = outs[False].data(name).double()
    floor = (outs[True].data(name).double() - f32).square().mean().sqrt()
    want = f32 if ref is None else ref[name].cpu().double()
    err = (got[name].cpu().double() - want).square().mean().sqrt()
    bound = 2 * floor + SMALL_EPS * f32.square().mean().sqrt()
    if not (torch.isfinite(err) and err <= bound):
      raise AssertionError(f"{phase} {name}: rms(card-ref)={err:.4g} > "
                           f"2*floor+eps={bound:.4g}")
    worst = max(worst, float(err / bound))
  return worst


def phase_small(torch):
  from graphcast_tpu_torch.params import flat_params
  t0 = time.perf_counter()
  preset = _small_preset()
  (inputs, targets, forcings), outs = _small_references(torch)
  model, card = _stack(torch, preset, seed=SMALL_SEED)
  card = card.to(DEVICE)
  with torch.inference_mode():
    out_card = card(inputs.to(DEVICE), targets.to(DEVICE),
                    forcings.to(DEVICE))
  torch.cuda.synchronize()
  card_s = time.perf_counter() - t0
  cpu_model, _ = _stack(torch, preset, seed=SMALL_SEED, device="cpu")
  if not all(torch.equal(a, b.cpu()) for a, b in zip(
      flat_params(cpu_model).values(), flat_params(model).values())):
    raise AssertionError("CPU and card models differ in their weights")
  worst = _check_noise_floor(
      torch, "small", {n: out_card.data(n) for n in targets.var_names}, outs,
      targets.var_names)
  _log("small", t0, config=_label(preset),
       card_s=f"{card_s:.1f}", worst_err_over_bound=f"{worst:.3f}")


def _counters():
  from graphcast_tpu_torch.ops.fused_decoder import (
      fused_decode, fused_decode_backward)
  from graphcast_tpu_torch.ops.fused_edge import (
      fused_edge, fused_edge_backward)
  from graphcast_tpu_torch.ops.segment_sum import (
      sender_segment_sum, sorted_segment_sum)
  from graphcast_tpu_torch.ops.splash import (
      block_sparse_attention, splash_dkv, splash_dq)
  from graphcast_tpu_torch.ops.weight_grad import feature_grad, weight_grad
  return {"fused_edge": fused_edge, "fused_decoder": fused_decode,
          "fused_edge_bwd": fused_edge_backward,
          "fused_decoder_bwd": fused_decode_backward,
          "weight_grad": weight_grad, "feature_grad": feature_grad,
          "splash_fwd": block_sparse_attention, "splash_dq": splash_dq,
          "splash_dkv": splash_dkv, "segment_sum": sorted_segment_sum,
          "segment_sum_sender": sender_segment_sum}


def _mode_counts():
  """The per-mode launch counts, K1p's among them: {kernel entry name:
  count}."""
  c = _counters()
  k1 = c["fused_edge"]
  return {"fused_edge_encoder": k1.encoder_launches,
          "fused_edge_embed": k1.embed_launches,
          "fused_edge_pipelined_all": k1.pipelined_launches,
          "fused_edge_pipelined_encoder": k1.pipelined_encoder_launches,
          "fused_edge_pipelined_embed": k1.pipelined_embed_launches,
          "fused_decoder_embed": c["fused_decoder"].embed_launches,
          "fused_edge_bwd_embed": c["fused_edge_bwd"].embed_launches,
          "fused_decoder_bwd_embed": c["fused_decoder_bwd"].embed_launches}


def _reset_counters():
  """Sets every kernel's launch count to 0 (the per-mode ones too)."""
  for fn in _counters().values():
    fn.launches = 0
  c = _counters()
  k1 = c["fused_edge"]
  k1.encoder_launches = k1.embed_launches = 0
  k1.pipelined_launches = k1.pipelined_encoder_launches = 0
  k1.pipelined_embed_launches = 0
  for name in ("fused_decoder", "fused_edge_bwd", "fused_decoder_bwd"):
    c[name].embed_launches = 0


def _train_launches_per_step(art, mp_steps):
  """Kernel launches per AR-1 train step that the graph implies. K1 and K2
  launch once per call (1 + mp_steps edge steps, one decoder). K4 launches
  once per ``BWD_CHUNK_ROWS`` edges of each of its calls (mp_steps on the
  mesh, one on grid2mesh), K5 once per ``BWD_CHUNK_NODES`` grid nodes. The
  reduction runs per chunk: twice per processor K4 chunk (dW1, dWe), once
  per encoder chunk (dW1), 7 times per K5 chunk. K3's sender mode once per
  K4 and K5 call."""
  from graphcast_tpu_torch.ops import fused_decoder, fused_edge
  proc = -(-art.mesh.senders.size // fused_edge.BWD_CHUNK_ROWS)
  enc = -(-art.grid2mesh.senders.size // fused_edge.BWD_CHUNK_ROWS)
  dec = -(-art.num_grid_nodes // fused_decoder.BWD_CHUNK_NODES)
  return {"fused_edge": 1 + mp_steps, "fused_decoder": 1,
          "fused_edge_bwd": mp_steps * proc + enc, "fused_decoder_bwd": dec,
          "weight_grad": 2 * mp_steps * proc + enc + 7 * dec,
          "segment_sum_sender": mp_steps + 2}


def phase_train(torch, results, profile_dir=None):
  from graphcast_tpu_torch import train
  from graphcast_tpu_torch.examples.graphcast_demo import (
      era5_inputs_targets_forcings)
  from graphcast_tpu_torch.models import zoo
  t0 = time.perf_counter()
  preset = zoo.graphcast()
  mc = preset.model_config
  model, predictor = _stack(torch, preset, seed=0,
                            gradient_checkpointing=True)
  predictor = predictor.to(DEVICE)
  data = era5_inputs_targets_forcings(preset.task_config, mc.resolution, 1,
                                      6, seed=0, device=DEVICE)
  data = [fs.astype(torch.bfloat16) for fs in data]
  step = train.make_train_step(
      predictor, train.graphcast_optimizer(model.parameters(), peak_lr=1e-3))
  before = [p.detach().clone() for p in model.parameters()]
  setup_s = time.perf_counter() - t0
  t1 = time.perf_counter()
  losses = [step(*data)[0]]  # warm-up: builds the graph and its statics
  torch.cuda.synchronize()
  warm_s = time.perf_counter() - t1

  expected = _train_launches_per_step(model._artifact, mc.gnn_msg_steps)
  counters = {k: v for k, v in _counters().items() if k in expected}
  torch.cuda.reset_peak_memory_stats()
  _reset_counters()
  t2 = time.perf_counter()
  for _ in range(TRAIN_STEPS):
    losses.append(step(*data)[0])
  torch.cuda.synchronize()
  train_s = time.perf_counter() - t2
  counts = {k: fn.launches for k, fn in counters.items()}
  peak_gb = torch.cuda.max_memory_allocated() / 1e9

  for name, per_step in expected.items():
    if counts[name] != per_step * TRAIN_STEPS:
      raise AssertionError(f"train launches {counts}, expected "
                           f"{per_step} per step for {name}")
  losses = [float(v) for v in losses]
  if not all(np.isfinite(losses)):
    raise AssertionError(f"non-finite training losses {losses}")
  if all(torch.equal(a, p) for a, p in zip(before, model.parameters())):
    raise AssertionError("the train steps changed no parameter")
  del before
  if profile_dir:
    _profile_step(torch, lambda: step(*data), profile_dir, "train_step")
  for name, n in counts.items():
    results.setdefault(name, {"name": name})["train_launches"] = n
  for name in ("fused_edge_bwd", "fused_decoder_bwd", "weight_grad",
               "segment_sum_sender"):
    results[name].update(launches=counts[name],
                         launches_per_step=counts[name] / TRAIN_STEPS)
  _log("train", t0, config=_label(preset) + "/AR1", steps=TRAIN_STEPS,
       setup_s=f"{setup_s:.1f}", warmup_step_s=f"{warm_s:.2f}",
       s_per_step=f"{train_s / TRAIN_STEPS:.4f}",
       peak_mem_gb=f"{peak_gb:.2f}",
       losses="[" + ",".join(f"{v:.6g}" for v in losses) + "]",
       **{f"{k}_per_step": counts[k] // TRAIN_STEPS for k in expected},
       finite=True, params_changed=True)
  del model, predictor, step, data
  torch.cuda.empty_cache()


def _loss_and_grads(torch, stack, model, data, device, **kwargs):
  """Loss, per-variable losses and every parameter gradient (f32, CPU;
  zeros for a parameter the loss does not reach); ``kwargs`` go to the
  loss."""
  from graphcast_tpu_torch.params import flat_params
  model.zero_grad(set_to_none=True)
  loss, diagnostics = stack.loss(*(fs.to(device) for fs in data), **kwargs)
  loss = loss.mean()
  loss.backward()
  grads = {k: torch.zeros(p.shape) if p.grad is None
           else p.grad.detach().float().cpu()
           for k, p in flat_params(model).items()}
  diag = {k: v.detach().mean().double().cpu() for k, v in diagnostics.items()}
  return loss.detach().double().cpu(), diag, grads


def _rms(torch, x):
  return x.double().square().mean().sqrt().item()


def _noise_floor_checks(torch, phase, card_diag, card_grads, cpu):
  """The small phases' rule for each per-variable loss and each parameter
  gradient: rms(card - cpu f32) <= 2 rms(cpu bf16 - cpu f32) + SMALL_EPS
  rms(cpu f32); ``cpu`` maps bf16 (False, True) to _loss_and_grads'
  result. Raises on the first miss; returns {"var"/"param": worst
  err/bound}."""
  worst = {}
  checks = [("var " + k, card_diag[k], cpu[False][1][k], cpu[True][1][k])
            for k in card_diag]
  checks += [("param " + k, card_grads[k], cpu[False][2][k], cpu[True][2][k])
             for k in card_grads]
  for name, got, f32, b16 in checks:
    floor = _rms(torch, b16 - f32)
    bound = 2 * floor + SMALL_EPS * _rms(torch, f32)
    err = _rms(torch, got - f32)
    if not (np.isfinite(err) and err <= bound):
      raise AssertionError(f"{phase} {name}: rms(card-f32)={err:.4g} > "
                           f"2*floor+eps={bound:.4g}")
    kind = name.split()[0]
    worst[kind] = max(worst.get(kind, 0.0), err / bound if bound else 0.0)
  return worst


def _train_small_preset():
  """zoo.graphcast_small() with its processor cut to
  TRAIN_SMALL_MP_STEPS steps (train_small)."""
  from graphcast_tpu_torch.models import zoo
  preset = zoo.graphcast_small()
  return dataclasses.replace(preset, model_config=dataclasses.replace(
      preset.model_config, gnn_msg_steps=TRAIN_SMALL_MP_STEPS))


@functools.lru_cache(maxsize=None)
def _train_small_references(torch):
  """train_small's batch (2 target steps, CPU) and its CPU runs, the AR-1
  loss, per-variable losses and every gradient in f32 and bf16, with
  their seconds."""
  from graphcast_tpu_torch.data import synthetic
  t0 = time.perf_counter()
  preset = _train_small_preset()
  data = synthetic.make_example_batch(
      preset.task_config, resolution=preset.model_config.resolution,
      batch=1, num_target_times=2, device="cpu")
  inputs, targets, forcings = data
  one = (inputs, targets.isel(time=slice(0, 1)),
         forcings.isel(time=slice(0, 1)))
  cpu = {}
  for bf16 in (False, True):
    cpu_model, stack = _stack(torch, preset, seed=6, bf16=bf16,
                              device="cpu")
    cpu[bf16] = _loss_and_grads(torch, stack, cpu_model, one, "cpu")
  return data, cpu, time.perf_counter() - t0


def phase_train_small(torch):
  t0 = time.perf_counter()
  preset = _train_small_preset()
  (inputs, targets, forcings), cpu, cpu_s = _train_small_references(torch)

  def steps(n):
    return (inputs, targets.isel(time=slice(0, n)),
            forcings.isel(time=slice(0, n)))

  model, card = _stack(torch, preset, seed=6)
  card = card.to(DEVICE)
  _, card_diag, card_grads = _loss_and_grads(torch, card, model, steps(1),
                                             DEVICE)
  torch.cuda.synchronize()
  card_s = time.perf_counter() - t0
  worst = _noise_floor_checks(torch, "train_small", card_diag, card_grads,
                              cpu)

  # AR-2 on the card: per-step checkpointing on against off. The kernels'
  # atomics make two runs of the same code differ in the last bits, so
  # "equal" is within that run-to-run noise (two runs without checkpointing).
  runs = {}
  for name, ckpt in (("plain", False), ("plain_again", False),
                     ("ckpt", True)):
    stack = _wrap(model, preset.task_config, gradient_checkpointing=ckpt)
    runs[name] = _loss_and_grads(torch, stack, model, steps(2), DEVICE)
  ar2 = 0.0
  pairs = [("loss", lambda r: r[0])] + [
      (k, lambda r, k=k: r[2][k]) for k in runs["plain"][2]]
  for name, get in pairs:
    noise = _rms(torch, get(runs["plain_again"]) - get(runs["plain"]))
    bound = 2 * noise + 1e-3 * _rms(torch, get(runs["plain"]))
    err = _rms(torch, get(runs["ckpt"]) - get(runs["plain"]))
    if not (np.isfinite(err) and err <= bound):
      raise AssertionError(f"train_small AR-2 {name}: checkpointed vs plain "
                           f"{err:.4g} > 2*noise+eps={bound:.4g}")
    ar2 = max(ar2, err / bound if bound else 0.0)
  _log("train_small", t0, config=_label(preset) + "/AR1",
       mp_steps_cut_to=TRAIN_SMALL_MP_STEPS, card_s=f"{card_s:.1f}",
       cpu_s=f"{cpu_s:.1f}",
       worst_var_err_over_bound=f"{worst['var']:.3f}",
       worst_param_err_over_bound=f"{worst['param']:.3f}",
       ar2_loss=f"{float(runs['ckpt'][0]):.6g}",
       ar2_ckpt_vs_plain_over_bound=f"{ar2:.3f}")
  del model, card, runs
  torch.cuda.empty_cache()


def _k_hop_mask(mesh_size):
  """GenCast's attention mask: the k-hop-16 adjacency of the finest mesh in
  its patch order (512-node BFS patches), as the denoiser builds it."""
  from graphcast_tpu_torch.geometry import artifact, icosahedron
  from graphcast_tpu_torch.models import sparse_transformer, transformer
  mesh = artifact.permute_mesh_to_banded(
      icosahedron.get_mesh_hierarchy(mesh_size)[-1], patch_size=512)
  senders, receivers = icosahedron.faces_to_edges(mesh.faces)
  adj = transformer.adjacency_from_edges(senders, receivers,
                                         mesh.vertices.shape[0])
  return sparse_transformer.k_hop_adjacency_from_matrix(adj, 16)


_BLOCK_MAPS = {}


def _k_hop_block_map(mesh_size):
  """(mask, block map, mask build s, mask + map build s) of GenCast's
  k-hop-16 mask at ``mesh_size``, built once per run (k6 and k7k8)."""
  from graphcast_tpu_torch.ops import splash
  if mesh_size not in _BLOCK_MAPS:
    t1 = time.perf_counter()
    mask = _k_hop_mask(mesh_size)
    mask_s = time.perf_counter() - t1
    bm = splash.build_block_map(mask)
    _BLOCK_MAPS[mesh_size] = (mask, bm, mask_s, time.perf_counter() - t1)
  return _BLOCK_MAPS[mesh_size]


def phase_k6(torch, results):
  from graphcast_tpu_torch.native import build
  from graphcast_tpu_torch.ops import splash
  t0 = time.perf_counter()
  _print_usage("k6", "splash_fwd_kernel",
               build.load_library().gc_splash_fwd_smem())
  gen = torch.Generator(device=DEVICE).manual_seed(8)
  heads, d = 4, 128
  scale = d ** -0.5
  entry = _entry("splash_fwd", "splash_fwd.cu",
                 "graphcast_tpu/ops/splash.py:217", launches=None)
  worst = 0.0
  # (mesh, batch, key suffix): GenCast sampling's shape, the ensemble's
  # (its members as the batch, so batch x heads = 16) and 0.25 deg's mesh-6.
  for mesh_size, batch, suffix in ((5, 1, ""),
                                   (5, ENSEMBLE_MEMBERS, "_ensemble"),
                                   (6, 1, "_mesh6")):
    mask, bm, mask_s, host_s = _k_hop_block_map(mesh_size)
    n = bm.n
    q, k, v = (_randn(torch, gen, (batch, n, heads, d), 1.0, torch.bfloat16)
               for _ in range(3))
    case = f"k6 mesh{mesh_size} batch{batch}"
    with torch.inference_mode():
      got, lse = splash.block_sparse_attention(q, k, v, bm, scale)
      want, want_lse = splash.block_sparse_attention_reference(q, k, v, bm,
                                                               scale)
      torch.cuda.synchronize()
      max_abs, rel_rms = _check_close(f"{case} o", got, want)
      lse_err = (lse - want_lse).abs().max().item()
      if not lse_err <= LSE_ATOL:
        raise AssertionError(f"{case} lse max_abs={lse_err:.3g}"
                             f" (tol {LSE_ATOL})")
      worst = max(worst, max_abs)
      del got, lse, want, want_lse
      def kernel():
        splash.block_sparse_attention(q, k, v, bm, scale)
      plain_ms = _time_ms(torch, lambda: splash.block_sparse_attention_reference(
          q, k, v, bm, scale), reps=1)
      # The library yardstick: SDPA with the dense boolean mask, where it
      # fits on the card, timed in turns with the kernel.
      try:
        dense = torch.as_tensor(mask.toarray(), device=DEVICE)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms, library_ms = _time_in_turns(
            torch, kernel,
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=dense, scale=scale), reps=10)
        del dense, qt, kt, vt
      except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        ms, library_ms = _time_ms(torch, kernel, reps=20), None
      torch.cuda.empty_cache()
    bound = _bound(4 * batch * heads * bm.nnz * d,
                   batch * (4 * n * heads * d * 2 + n * heads * 4))
    entry.update({"ms" + suffix: ms, "plain_ms" + suffix: plain_ms,
                  "library_ms" + suffix: library_ms,
                  **{k + suffix: val for k, val in bound.items()}})
    covered = bm.n_active * splash.TILE ** 2
    _log("k6", t0, mesh=mesh_size, batch=batch, nodes=n, mask_entries=bm.nnz,
         active_tiles=bm.n_active, full_tiles=int(bm.full.sum()),
         covered_entries=covered, set_share=f"{bm.nnz / covered:.3f}",
         mask_build_s=f"{mask_s:.2f}", host_build_s=f"{host_s:.2f}",
         o_max_abs=f"{max_abs:.4g}", o_rel_rms=f"{rel_rms:.3g}",
         lse_max_abs=f"{lse_err:.3g}", ms=f"{ms:.4f}",
         plain_ms=f"{plain_ms:.3f}",
         library_ms="none" if library_ms is None else f"{library_ms:.4f}",
         bound_ms=f"{bound['bound_ms']:.4f}")
    del q, k, v, mask, bm
    torch.cuda.empty_cache()
  entry["max_abs_err"] = worst
  results["splash_fwd"] = entry


def phase_k7k8(torch, results):
  """K7 (dq) and K8 (dk, dv) against the plain backward on the kernels' own
  o and lse over the real k-hop-16 masks, at K6's three shapes; a rerun
  bit-equal; the pair timed in turns with the backward of SDPA with the
  dense boolean mask (the library yardstick) where that mask fits."""
  from graphcast_tpu_torch.native import build
  from graphcast_tpu_torch.ops import splash
  t0 = time.perf_counter()
  lib = build.load_library()
  _print_usage("k7k8", "splash_dq_kernel", lib.gc_splash_dq_smem())
  _print_usage("k7k8", "splash_dkv_kernel", lib.gc_splash_dkv_smem())
  gen = torch.Generator(device=DEVICE).manual_seed(13)
  heads, d = 4, 128
  scale = d ** -0.5
  entries = {
      "splash_dq": _entry("splash_dq", "splash_bwd.cu",
                          "graphcast_tpu/ops/splash.py:382", launches=None),
      "splash_dkv": _entry("splash_dkv", "splash_bwd.cu",
                           "graphcast_tpu/ops/splash.py:437", launches=None)}
  worst = {k: 0.0 for k in entries}
  worst_abs = {k: 0.0 for k in entries}
  # K6's shapes: GenCast training's (mesh-5, batch x heads 4), the
  # ensemble's (batch x heads 16) and 0.25 deg's mesh-6.
  for mesh_size, batch, suffix in ((5, 1, ""),
                                   (5, ENSEMBLE_MEMBERS, "_ensemble"),
                                   (6, 1, "_mesh6")):
    mask, bm, _, _ = _k_hop_block_map(mesh_size)
    n = bm.n
    q, k, v, do = (_randn(torch, gen, (batch, n, heads, d), 1.0,
                          torch.bfloat16) for _ in range(4))
    phase = f"k7k8 mesh{mesh_size} batch{batch}"
    with torch.inference_mode():
      (qh, kh, vh), oh, lseh = splash._launch_splash(q, k, v, bm, scale)
      doh = splash._to_heads(do, bm.n_pad)
      delta = splash.attention_delta(oh, doh)
      args = (qh, kh, vh, doh, lseh, delta, bm, scale)
      got = (splash.splash_dq(*args), *splash.splash_dkv(*args))
      again = (splash.splash_dq(*args), *splash.splash_dkv(*args))
      torch.cuda.synchronize()
      # Each block owns its rows and walks its list in a fixed order.
      for name, a, b in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a, b):
          raise AssertionError(f"{phase} {name}: a rerun is not bit-equal")
      del again
      o, lse = splash._outputs(oh, lseh, batch, n)
      ref = (q, k, v, o, lse, do, bm, scale)
      want_dq = splash._dq_reference(*ref)
      want_dk, want_dv = splash._dkv_reference(*ref)
      dq, dk, dv = (splash._from_heads(g, batch, n) for g in got)
      errs = {"splash_dq": _check_grads(phase, {"dq": dq}, {"dq": want_dq}),
              "splash_dkv": _check_grads(
                  phase, {"dk": dk, "dv": dv},
                  {"dk": want_dk, "dv": want_dv})}
      rels = {**errs["splash_dq"][1], **errs["splash_dkv"][1]}
      del want_dq, want_dk, want_dv, dq, dk, dv, got
      ms = {"splash_dq": _time_ms(torch, lambda: splash.splash_dq(*args),
                                  reps=20),
            "splash_dkv": _time_ms(torch, lambda: splash.splash_dkv(*args),
                                   reps=20)}
      plain = {"splash_dq": _time_ms(torch, lambda: splash._dq_reference(
                   *ref), reps=1),
               "splash_dkv": _time_ms(torch, lambda: splash._dkv_reference(
                   *ref), reps=1)}

    def kernels():
      splash.splash_dq(*args)
      splash.splash_dkv(*args)
    # The library yardstick: the backward of SDPA with the dense boolean
    # mask (dq, dk and dv together: K7 and K8's work), in turns with the
    # pair, where the mask fits on the card.
    try:
      dense = torch.as_tensor(mask.toarray(), device=DEVICE)
      qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                    for x in (q, k, v))
      out = torch.nn.functional.scaled_dot_product_attention(
          qt, kt, vt, attn_mask=dense, scale=scale)
      dot = do.transpose(1, 2)
      pair_ms, library_ms = _time_in_turns(
          torch, kernels, lambda: torch.autograd.grad(
              out, (qt, kt, vt), dot, retain_graph=True), reps=20)
      del dense, qt, kt, vt, out, dot
    except torch.cuda.OutOfMemoryError:
      dense = qt = kt = vt = out = dot = None
      torch.cuda.empty_cache()
      pair_ms, library_ms = _time_ms(torch, kernels, reps=20), None
    torch.cuda.empty_cache()
    # K7: S, dP and dQ per mask entry; reads q, k, v, do, lse and delta,
    # writes dq. K8: S^T, dP^T, dV and dK; writes dk and dv. The tile
    # bound counts the same products over every entry of the active 64 x 64
    # tiles, which the kernels compute whole.
    rows = batch * n * heads
    products = {"splash_dq": 3, "splash_dkv": 4}
    bounds = {"splash_dq": _bound(6 * batch * heads * bm.nnz * d,
                                  5 * rows * d * 2 + 2 * rows * 4),
              "splash_dkv": _bound(8 * batch * heads * bm.nnz * d,
                                   6 * rows * d * 2 + 2 * rows * 4)}
    tile_ms = {name: 1e3 * 2 * c * batch * heads * bm.n_active
               * splash.TILE ** 2 * d / PEAK_FLOPS
               for name, c in products.items()}
    for name, entry in entries.items():
      worst_abs[name] = max(worst_abs[name], errs[name][0])
      worst[name] = max(worst[name], *errs[name][1].values())
      entry.update({"ms" + suffix: ms[name], "plain_ms" + suffix: plain[name],
                    "library_ms" + suffix: library_ms,
                    "pair_ms" + suffix: pair_ms,
                    **{key + suffix: val for key, val in
                       bounds[name].items()}})
      entry["library_covers"] = "SDPA backward: dq, dk and dv"
    union = {"": splash.paired_lists(bm).offsets[-1],
             "_t": splash.paired_lists(bm.transposed).offsets[-1]}
    _log("k7k8", t0, mesh=mesh_size, batch=batch, nodes=n,
         mask_entries=bm.nnz, active_tiles=bm.n_active,
         union_entries=int(union[""]), union_entries_t=int(union["_t"]),
         transposed_full_tiles=int(bm.transposed.full.sum()),
         dq_rel_rms=f"{rels['dq']:.3g}", dk_rel_rms=f"{rels['dk']:.3g}",
         dv_rel_rms=f"{rels['dv']:.3g}",
         k7_max_abs=f"{errs['splash_dq'][0]:.4g}",
         k8_max_abs=f"{errs['splash_dkv'][0]:.4g}", rerun="bit-equal",
         k7_ms=f"{ms['splash_dq']:.4f}", k8_ms=f"{ms['splash_dkv']:.4f}",
         pair_ms=f"{pair_ms:.4f}",
         library_ms="none" if library_ms is None else f"{library_ms:.4f}",
         k7_plain_ms=f"{plain['splash_dq']:.3f}",
         k8_plain_ms=f"{plain['splash_dkv']:.3f}",
         k7_bound_ms=f"{bounds['splash_dq']['bound_ms']:.4f}",
         k8_bound_ms=f"{bounds['splash_dkv']['bound_ms']:.4f}",
         k7_tile_bound_ms=f"{tile_ms['splash_dq']:.4f}",
         k8_tile_bound_ms=f"{tile_ms['splash_dkv']:.4f}")
    del q, k, v, do, qh, kh, vh, oh, lseh, doh, delta, args, ref, o, lse
    torch.cuda.empty_cache()
  for name, entry in entries.items():
    entry["max_abs_err"] = worst_abs[name]
    entry["worst_rel_rms"] = worst[name]
    results[name] = entry


def _sp_bounds(batch, heads, d, rows, n, nnz):
  """The bounds of one shard's K6, K7 and K8 (``rows`` q rows against
  ``n`` kv rows, ``nnz`` mask entries): K6 reads q, k, v, writes o and
  lse; K7 reads q, do, k, v, lse, delta, writes dq; K8 reads the same,
  writes dk and dv for every kv row."""
  b, w = batch * heads * d * 2, batch * heads * 4
  return {"splash_fwd_shard": _bound(4 * batch * heads * nnz * d,
                                     (2 * rows + 2 * n) * b + rows * w),
          "splash_dq_shard": _bound(6 * batch * heads * nnz * d,
                                    (3 * rows + 2 * n) * b + 2 * rows * w),
          "splash_dkv_shard": _bound(8 * batch * heads * nnz * d,
                                     (2 * rows + 4 * n) * b + 2 * rows * w)}


def phase_sp_attention(torch, results):
  """K6, K7 and K8 on sequence-parallel shard maps (module doc), in one
  process: each shard against its plain twins, the shards' o, lse and dq
  put together against the unsharded kernels bit for bit, their dk and dv
  partials summed in shard order against the unsharded K8, a rerun
  bit-equal, each shard timed beside the unsharded kernels."""
  from graphcast_tpu_torch.ops import splash
  t0 = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(21)
  batch, heads, d = 1, 4, 128
  scale = d ** -0.5
  mask, bm, _, _ = _k_hop_block_map(6)
  n = bm.n
  q, k, v, do = (_randn(torch, gen, (batch, n, heads, d), 1.0,
                        torch.bfloat16) for _ in range(4))
  names = ("splash_fwd_shard", "splash_dq_shard", "splash_dkv_shard")
  entries = {
      name: _entry(name, src, at, launches=None)
      for name, src, at in zip(names, ("splash_fwd.cu", "splash_bwd.cu",
                                       "splash_bwd.cu"),
                               ("graphcast_tpu/ops/splash.py:217",
                                "graphcast_tpu/ops/splash.py:382",
                                "graphcast_tpu/ops/splash.py:437"))}
  worst = {name: 0.0 for name in names}

  def run(m, qs, dos):
    (qh, kh, vh), oh, lseh = splash._launch_splash(qs, k, v, m, scale)
    doh = splash._to_heads(dos, m.n_pad)
    args = (qh, kh, vh, doh, lseh, splash.attention_delta(oh, doh), m, scale)
    return (oh, lseh, splash.splash_dq(*args), *splash.splash_dkv(*args)), args

  with torch.inference_mode():
    (oh, lseh, dq, dk, dv), whole = run(bm, q, do)
    o, lse = splash._outputs(oh, lseh, batch, n)
    dq = splash._from_heads(dq, batch, n)
    dk, dv = (splash._from_heads(g, batch, n) for g in (dk, dv))
    whole_ms = [_time_ms(torch, lambda: splash._launch_splash(q, k, v, bm,
                                                              scale), reps=10),
                _time_ms(torch, lambda: splash.splash_dq(*whole), reps=10),
                _time_ms(torch, lambda: splash.splash_dkv(*whole), reps=10)]
    for shards in SP_SHARDS:
      t1 = time.perf_counter()
      maps = splash.shard_block_maps(bm, shards)
      map_s = time.perf_counter() - t1
      parts = {key: [] for key in ("o", "lse", "dq")}
      dk_sum = torch.zeros(dk.shape, device=DEVICE)
      dv_sum = torch.zeros(dv.shape, device=DEVICE)
      shard_ms = []
      for s, (m, (a, b)) in enumerate(zip(maps, splash.shard_rows(n,
                                                                  shards))):
        qs, dos = q[:, a:b], do[:, a:b]
        (ohs, lses, dqs, dks, dvs), args = run(m, qs, dos)
        if s == 0:  # a rerun is bit-equal
          again, _ = run(m, qs, dos)
          for name, x, y in zip(("o", "lse", "dq", "dk", "dv"),
                                (ohs, lses, dqs, dks, dvs), again):
            if not torch.equal(x, y):
              raise AssertionError(f"sp_attention S={shards} shard 0 {name}:"
                                   " a rerun is not bit-equal")
          del again
        os_, ls_ = splash._outputs(ohs, lses, batch, b - a)
        parts["o"].append(os_)
        parts["lse"].append(ls_)
        dqs = splash._from_heads(dqs, batch, b - a)
        parts["dq"].append(dqs)
        dks, dvs = (splash._from_heads(g, batch, n) for g in (dks, dvs))
        dk_sum += dks.float()
        dv_sum += dvs.float()
        # Each shard's kernels against their plain twins on its map.
        want_o, want_lse = splash.block_sparse_attention_reference(
            qs, k, v, m, scale)
        phase = f"sp_attention S={shards} shard {s}"
        err = _check_close(f"{phase} o", os_, want_o)[0]
        if not (ls_ - want_lse).abs().max().item() <= LSE_ATOL:
          raise AssertionError(f"{phase} lse beyond {LSE_ATOL}")
        ref = (qs, k, v, os_, ls_, dos, m, scale)
        e_dq = _check_grads(phase, {"dq": dqs},
                            {"dq": splash._dq_reference(*ref)})
        want_dk, want_dv = splash._dkv_reference(*ref)
        e_dkv = _check_grads(phase, {"dk": dks, "dv": dvs},
                             {"dk": want_dk, "dv": want_dv})
        for name, e in zip(names, (err, e_dq[0], e_dkv[0])):
          worst[name] = max(worst[name], e)
        del want_o, want_lse, want_dk, want_dv
        ms = [_time_ms(torch, lambda: splash._launch_splash(qs, k, v, m,
                                                            scale), reps=10),
              _time_ms(torch, lambda: splash.splash_dq(*args), reps=10),
              _time_ms(torch, lambda: splash.splash_dkv(*args), reps=10)]
        shard_ms.append(ms)
        bounds = _sp_bounds(batch, heads, d, b - a, n, m.nnz)
        print(f"[sp_attention] S={shards} shard={s} rows={a}:{b} "
              f"active_tiles={m.n_active} mask_entries={m.nnz} "
              f"k6_ms={ms[0]:.4f} k7_ms={ms[1]:.4f} k8_ms={ms[2]:.4f} "
              + " ".join(f"{nm.split('_')[1]}_bound_ms="
                         f"{bounds[nm]['bound_ms']:.4f}" for nm in names),
              flush=True)
        if s == 0:
          plain = [_time_ms(
                       torch, lambda: splash.block_sparse_attention_reference(
                           qs, k, v, m, scale), reps=1),
                   _time_ms(torch, lambda: splash._dq_reference(*ref), reps=1),
                   _time_ms(torch, lambda: splash._dkv_reference(*ref),
                            reps=1)]
          first = (a, b, m, args, bounds, plain, ms)
      # Put together: o, lse and dq bit for bit; dk, dv summed in order.
      same = {key: torch.equal(torch.cat(parts[key], 2 if key == "lse"
                                         else 1), want)
              for key, want in (("o", o), ("lse", lse), ("dq", dq))}
      if not all(same.values()):
        raise AssertionError(f"sp_attention S={shards}: assembled shards "
                             f"differ from the unsharded kernels: {same}")
      rel = {name: _errors(got.to(want.dtype), want)[1]
             for name, got, want in (("dk", dk_sum, dk), ("dv", dv_sum, dv))}
      if not all(r <= SP_DKV_RTOL for r in rel.values()):
        raise AssertionError(f"sp_attention S={shards}: summed partials "
                             f"vs unsharded K8 rel_rms {rel} (tol "
                             f"{SP_DKV_RTOL})")
      # The library yardsticks of the first shard: SDPA with its rows of
      # the dense mask for K6, and that SDPA's backward (dq, dk and dv) for
      # K7 and K8 together, in turns with the pair, where they fit.
      a, b, m, args, bounds, plain, ms = first
      library_ms = library_bwd_ms = pair_ms = None
      try:
        dense = torch.as_tensor(mask[a:b].toarray(), device=DEVICE)
        with torch.inference_mode(False), torch.enable_grad():
          qt, kt, vt = (x.transpose(1, 2).clone().requires_grad_()
                        for x in (q[:, a:b], k, v))
          library_ms = _time_ms(
              torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                  qt, kt, vt, attn_mask=dense, scale=scale), reps=5)
          out = torch.nn.functional.scaled_dot_product_attention(
              qt, kt, vt, attn_mask=dense, scale=scale)
          dot = do[:, a:b].transpose(1, 2).clone()

          def pair():
            with torch.inference_mode():
              splash.splash_dq(*args)
              splash.splash_dkv(*args)

          pair_ms, library_bwd_ms = _time_in_turns(
              torch, pair, lambda: torch.autograd.grad(
                  out, (qt, kt, vt), dot, retain_graph=True), reps=5)
          del out, dot
        del dense, qt, kt, vt
      except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
      slowest = [max(col) for col in zip(*shard_ms)]
      suffix = f"_s{shards}"
      for i, name in enumerate(names):
        e = entries[name]
        e.update({"ms" + suffix: slowest[i], "shard0_ms" + suffix: ms[i],
                  "plain_ms" + suffix: plain[i],
                  "unsharded_ms": whole_ms[i],
                  **{key + suffix: val for key, val in bounds[name].items()}})
        e["library_ms" + suffix] = library_ms if i == 0 else library_bwd_ms
        if i:
          e["pair_ms" + suffix] = pair_ms
          e["library_covers"] = ("SDPA backward on shard 0's rows of the "
                                 "dense mask: dq, dk and dv (K7 + K8)")
        if shards == SP_SHARDS[0]:
          e.update(ms=ms[i], plain_ms=plain[i], library_ms=e["library_ms"
                                                             + suffix],
                   **bounds[name])
      _log("sp_attention", t0, shards=shards, nodes=n,
           rows_per_shard=maps[0].n_pad, shard_map_s=f"{map_s:.2f}",
           assembled_o_lse_dq="bit-equal", rerun="bit-equal",
           dk_rel_rms=f"{rel['dk']:.3g}", dv_rel_rms=f"{rel['dv']:.3g}",
           unsharded_ms="/".join(f"{t:.4f}" for t in whole_ms),
           slowest_shard_ms="/".join(f"{t:.4f}" for t in slowest),
           library_ms="none" if library_ms is None else f"{library_ms:.4f}",
           k7k8_pair_ms="none" if pair_ms is None else f"{pair_ms:.4f}",
           library_bwd_ms=("none" if library_bwd_ms is None
                           else f"{library_bwd_ms:.4f}"))
  for name in names:
    entries[name]["max_abs_err"] = worst[name]
    results[name] = entries[name]
  del q, k, v, do, o, lse, dq, dk, dv
  torch.cuda.empty_cache()


@functools.lru_cache(maxsize=None)
def _gencast_artifact(resolution, mesh_size):
  """GenCast's banded artifact, the one its models take (built once per
  run: artifact_lib.cached_artifact)."""
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.geometry import artifact as artifact_lib
  lat, lon = synthetic.grid_coords(resolution)
  return artifact_lib.cached_artifact(lat, lon, mesh_size, multimesh=False,
                                      permute_banded=True,
                                      banded_patch_size=512)


def _embed_weights(torch, gen, C, F=4):
  return (_randn(torch, gen, (F, C), 0.5), _randn(torch, gen, (C,), 0.1),
          _randn(torch, gen, (C, C), 1.0 / np.sqrt(C)),
          _randn(torch, gen, (C,), 0.1))


def phase_embed(torch, art025, results):
  from graphcast_tpu_torch.ops.fused_decoder import (
      MATRICES, VECTORS, fused_decode, fused_decode_reference)
  from graphcast_tpu_torch.ops.fused_edge import (
      EdgeIndex, fused_edge, fused_edge_reference, smem_layout)
  t0 = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(9)
  C, num_out, bf16 = 512, 84, torch.bfloat16
  w = 1.0 / np.sqrt(C)
  arts = {"1p0": _gencast_artifact(1.0, 5), "0p25": art025}
  _print_usage("embed", "fused_edge_kernelILb1ELb0ELb1E",
               smem_layout(C)["total"])
  edge = _entry("fused_edge_embed", "fused_edge_embed.cu",
                "graphcast_tpu/ops/pallas_edge.py:116", mode="embed",
                launches=None)
  dec = _entry("fused_decoder_embed", "fused_decoder.cu",
               "graphcast_tpu/ops/pallas_decoder.py:76", mode="embed",
               launches=None)
  worst = {"edge": 0.0, "dec": 0.0}
  for res, art in arts.items():
    suffix = "" if res == "1p0" else "_0p25"
    g, m = art.num_grid_nodes, art.num_mesh_nodes
    # K1 embed: the grid2mesh step on the raw edge features.
    edges = EdgeIndex(art.grid2mesh.senders, art.grid2mesh.receivers, g, m,
                      DEVICE)
    args = _edge_case(torch, gen, edges, C, encoder=False)
    args["e"] = torch.as_tensor(art.grid2mesh.features, device=DEVICE)
    args["we"] = args["we"].to(bf16)
    embed = _embed_weights(torch, gen, C)
    run = lambda f: f(edges, write_edges=False, embed_weights=embed,  # noqa
                      **args)
    with torch.inference_mode():
      got, want = run(fused_edge), run(fused_edge_reference)
      torch.cuda.synchronize()
      shared = _shared_feature_rows(torch, edges, args["e"])
      e_abs, e_rel = _check_close(f"embed k1 {res}", got, want,
                                  shared=shared)
      del got, want
      gemms = _gemm_yardstick(torch, gen, edges.num_edges,
                              _edge_products("embed", backward=False))
      e_ms, e_gemm = _time_in_turns(torch, lambda: run(fused_edge), gemms)
      del gemms
      e_plain = _time_ms(torch, lambda: run(fused_edge_reference), reps=1)
    worst["edge"] = max(worst["edge"], e_abs)
    edge.update({"ms" + suffix: e_ms, "plain_ms" + suffix: e_plain,
                 "gemm_ms" + suffix: e_gemm,
                 **{k + suffix: v for k, v in _bound(*_edge_cost(
                     edges.num_edges, g, m, C, "embed")).items()}})
    del args, embed
    torch.cuda.empty_cache()
    # K2 embed: the whole mesh2grid decoder on the raw edge features.
    edges = EdgeIndex(art.mesh2grid.senders, art.mesh2grid.receivers, m, g,
                      DEVICE)
    weights = {k: _randn(torch, gen, (C, C), w) for k in MATRICES}
    weights["wd1"] = _randn(torch, gen, (C, num_out), w)
    weights.update({k: _randn(torch, gen, (C,), 0.1) for k in VECTORS})
    weights["bd1"] = _randn(torch, gen, (num_out,), 0.1)
    for k in ("escale", "nscale"):
      weights[k] = weights[k] + 1.0
    weights.update(zip(("ew0", "eb0", "ew1", "eb1"),
                       _embed_weights(torch, gen, C)))
    weights.update(we=_randn(torch, gen, (C, C), w),
                   b0=_randn(torch, gen, (C,), 0.1))
    grid = _randn(torch, gen, (g, C), 1.0, bf16)
    mesh_proj = _randn(torch, gen, (m, C), 1.0, bf16)
    feats = torch.as_tensor(art.mesh2grid.features, device=DEVICE)
    with torch.inference_mode():
      got = fused_decode(edges, grid, mesh_proj, feats, weights)
      want = fused_decode_reference(edges, grid, mesh_proj, feats, weights)
      torch.cuda.synchronize()
      d_abs, d_rel = _check_close(f"embed k2 {res}", got, want)
      del got, want
      torch.cuda.empty_cache()
      gemms = _gemm_yardstick(torch, gen, g, _decoder_products(
          C, 128, embed=True, backward=False))
      d_ms, d_gemm = _time_in_turns(torch, lambda: fused_decode(
          edges, grid, mesh_proj, feats, weights), gemms)
      del gemms
      d_plain = _time_ms(torch, lambda: fused_decode_reference(
          edges, grid, mesh_proj, feats, weights), reps=1)
    worst["dec"] = max(worst["dec"], d_abs)
    dec.update({"ms" + suffix: d_ms, "plain_ms" + suffix: d_plain,
                "gemm_ms" + suffix: d_gemm,
                **{k + suffix: v for k, v in _bound(*_decoder_cost(
                    g, m, C, num_out, embed=True)).items()}})
    _log("embed", t0, grid=res, g2m_edges=art.grid2mesh.senders.size,
         k1_max_shared=int(shared.max().item()),
         k1_max_abs=f"{e_abs:.4g}", k1_rel_rms=f"{e_rel:.3g}",
         k1_ms=f"{e_ms:.3f}", k1_gemm_ms=f"{e_gemm:.3f}",
         k1_plain_ms=f"{e_plain:.3f}",
         grid_nodes=g, k2_max_abs=f"{d_abs:.4g}", k2_rel_rms=f"{d_rel:.3g}",
         k2_ms=f"{d_ms:.3f}", k2_gemm_ms=f"{d_gemm:.3f}",
         k2_plain_ms=f"{d_plain:.3f}")
    del weights, grid, mesh_proj, feats
    torch.cuda.empty_cache()
  edge["max_abs_err"] = worst["edge"]
  dec["max_abs_err"] = worst["dec"]
  results["fused_edge_embed"] = edge
  results["fused_decoder_embed"] = dec


def _embed_bwd_bounds(edges_or_nodes, kind, C, F=4, M=None, N=None,
                      NO=None):
  """{bound_ms, bound_by} of K4's (kind "edge": E edges, M senders, N
  receivers) or K5's (kind "decoder": G grid nodes, M mesh nodes) embed
  backward: the recomputed forward plus two products per forward product;
  inputs read once, gradients written once."""
  if kind == "edge":
    E = edges_or_nodes
    flops, nbytes = _edge_cost(E, M, N, C, "embed", F)
    nbytes += N * C * 4 + (M + N) * C * 4 + 3 * C * C * 4 + E * F * 4
  else:
    G = edges_or_nodes
    flops, nbytes = _decoder_cost(G, M, C, NO, embed=True, F=F)
    nbytes += (G * NO * 2 + G * C * 2 + M * C * 4 + 3 * G * F * 4
               + (9 * C * C + C * NO + F * C) * 4)
  return _bound(3 * flops, nbytes)


def _decoder_weights(torch, gen, C, num_out, embed):
  from graphcast_tpu_torch.ops.fused_decoder import MATRICES, VECTORS
  w = 1.0 / np.sqrt(C)
  weights = {k: _randn(torch, gen, (C, C), w) for k in MATRICES}
  weights["wd1"] = _randn(torch, gen, (C, num_out), w)
  weights.update({k: _randn(torch, gen, (C,), 0.1) for k in VECTORS})
  weights["bd1"] = _randn(torch, gen, (num_out,), 0.1)
  for k in ("escale", "nscale"):
    weights[k] = weights[k] + 1.0
  if embed:
    weights.update(zip(("ew0", "eb0", "ew1", "eb1"),
                       _embed_weights(torch, gen, C)))
    weights.update(we=_randn(torch, gen, (C, C), w, torch.bfloat16),
                   b0=_randn(torch, gen, (C,), 0.1))
  return weights


def phase_embed_bwd(torch, art025, results):
  """K4 and K5 in embed mode against autograd of their twins on the real
  1.0° GenCast edge sets; each kernel alone on the 0.25° sets; the
  feature-gradient pass they share against its plain version."""
  from graphcast_tpu_torch.ops.fused_decoder import (
      EMBED_KEYS, KEYS, fused_decode, fused_decode_backward,
      fused_decode_reference)
  from graphcast_tpu_torch.ops.fused_edge import (
      EdgeIndex, fused_edge, fused_edge_embed_backward, fused_edge_reference,
      smem_layout)
  from graphcast_tpu_torch.ops.weight_grad import (
      feature_grad, feature_grad_reference)
  t0 = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(14)
  C, num_out, F, bf16 = 512, 84, 4, torch.bfloat16
  _print_usage("embed_bwd", "fused_edge_bwd_kernelILb0ELb1E",
               smem_layout(C, backward=True, embed=True)["total"])
  edge = _entry("fused_edge_bwd_embed", "fused_edge_bwd_embed.cu",
                "graphcast_tpu/ops/pallas_edge.py:299", mode="embed",
                launches=None)
  dec = _entry("fused_decoder_bwd_embed", "fused_decoder_bwd.cu",
               "graphcast_tpu/ops/pallas_decoder.py:160", mode="embed",
               launches=None)
  fg = _entry("feature_grad", "weight_grad.cu",
              "graphcast_tpu/ops/pallas_edge.py:299", launches=None,
              also_replaces="graphcast_tpu/ops/pallas_decoder.py:160")
  worst = {"edge": 0.0, "dec": 0.0, "fg": 0.0}
  for res, art in (("1p0", _gencast_artifact(1.0, 5)), ("0p25", art025)):
    suffix = "" if res == "1p0" else "_0p25"
    g, m = art.num_grid_nodes, art.num_mesh_nodes
    # K4 embed: the grid2mesh step's backward.
    edges = EdgeIndex(art.grid2mesh.senders, art.grid2mesh.receivers, g, m,
                      DEVICE)
    args = _edge_case(torch, gen, edges, C, encoder=False)
    args["e"] = torch.as_tensor(art.grid2mesh.features, device=DEVICE)
    args["we"] = args["we"].to(bf16)
    embed = dict(zip(("ew0", "eb0", "ew1", "eb1"),
                     _embed_weights(torch, gen, C)))
    d_agg = _randn(torch, gen, (m, C))
    if res == "1p0":
      leaves = {k: v.requires_grad_() for k, v in {**args, **embed}.items()}

      def run(fn):
        return lambda ew0, eb0, ew1, eb1, **kw: fn(
            edges, write_edges=False, embed_weights=(ew0, eb0, ew1, eb1),
            **kw)

      got, _ = _autograd(torch, run(fused_edge), leaves, (d_agg,),
                         list(leaves))
      want, e_plain = _autograd(torch, run(fused_edge_reference), leaves,
                                (d_agg,), list(leaves))
      torch.cuda.synchronize()
      e_abs, e_rels = _check_grads("embed_bwd k4 1p0", got, want)
      worst["edge"] = e_abs
      edge["plain_ms"] = e_plain
      del leaves, got, want
      torch.cuda.empty_cache()
    det = {k: v.detach() for k, v in args.items()}

    def k4():
      *grads, doff, dembed = fused_edge_embed_backward(
          edges, det["e"], det["sproj"], det["rproj"], det["we"], det["b0"],
          det["w1"], det["b1"], det["scale"],
          tuple(v.detach() for v in embed.values()), d_agg)
      names = ("e", "sproj", "rproj", "we", "b0", "w1", "b1", "scale",
               "offset", "ew0", "eb0", "ew1", "eb1")
      return dict(zip(names, (*grads, doff, *dembed)))

    if res == "1p0":
      # Every sum in a fixed order: a rerun is bit-equal in every gradient.
      _k4_rerun_bit_equal(torch, "embed_bwd k4", k4)
    gemms = _gemm_yardstick(torch, gen, edges.num_edges,
                            _edge_products("embed", backward=True))
    e_ms, e_gemm = _time_in_turns(torch, k4, gemms)
    del gemms
    e_kernel = _device_ms(torch, k4, ("fused_edge_bwd_kernel",),
                          reps=3)["fused_edge_bwd_kernel"]
    edge.update({"ms" + suffix: e_ms, "gemm_ms" + suffix: e_gemm,
                 "kernel_ms" + suffix: e_kernel, **{k + suffix: v for k, v in
                 _embed_bwd_bounds(edges.num_edges, "edge", C, F, M=g,
                                   N=m).items()}})
    n_g2m = edges.num_edges
    del args, det, embed, d_agg, edges
    torch.cuda.empty_cache()
    # K5 embed: the mesh2grid decoder's backward.
    edges = EdgeIndex(art.mesh2grid.senders, art.mesh2grid.receivers, m, g,
                      DEVICE)
    weights = _decoder_weights(torch, gen, C, num_out, embed=True)
    acts = dict(grid=_randn(torch, gen, (g, C), 1.0, bf16),
                mesh_proj=_randn(torch, gen, (m, C), 1.0, bf16),
                const=torch.as_tensor(art.mesh2grid.features, device=DEVICE))
    dout = _randn(torch, gen, (g, num_out), 1.0, bf16)
    if res == "1p0":
      leaves = {k: v.requires_grad_() for k, v in {**acts, **weights}.items()}

      def run_dec(fn):
        return lambda grid, mesh_proj, const, **w: fn(edges, grid, mesh_proj,
                                                      const, w)

      names = ["grid", "mesh_proj", "const", *KEYS, *EMBED_KEYS]
      got, _ = _autograd(torch, run_dec(fused_decode), leaves, (dout,),
                         names)
      want, d_plain = _autograd(torch, run_dec(fused_decode_reference),
                                leaves, (dout,), names)
      torch.cuda.synchronize()
      d_abs, d_rels = _check_grads("embed_bwd k5 1p0", got, want)
      worst["dec"] = d_abs
      dec["plain_ms"] = d_plain
      del leaves, got, want
      torch.cuda.empty_cache()
    det = {k: v.detach() for k, v in weights.items()}
    acts = {k: v.detach() for k, v in acts.items()}

    def k5():
      return fused_decode_backward(edges, acts["grid"], acts["mesh_proj"],
                                   acts["const"], det, dout)

    if res == "1p0":
      # Every sum in a fixed order: a rerun is bit-equal in every gradient.
      _k4_rerun_bit_equal(torch, "embed_bwd k5", lambda: (
          lambda out: {"grid": out[0], "mesh_proj": out[1], "const": out[2],
                       **out[3]})(k5()))
    # Products-only yardstick (40 GEMMs per node) in turns with the whole
    # backward; the kernel's own device time from the profiler.
    gemms = _gemm_yardstick(torch, gen, g, _decoder_products(
        C, 128, embed=True, backward=True))
    d_ms, d_gemm = _time_in_turns(torch, k5, gemms)
    del gemms
    d_kernel = _device_ms(torch, k5, ("fused_decoder_bwd_kernel",),
                          reps=3)["fused_decoder_bwd_kernel"]
    dec.update({"ms" + suffix: d_ms, "gemm_ms" + suffix: d_gemm,
                "kernel_ms" + suffix: d_kernel,
                **{k + suffix: v for k, v in
                _embed_bwd_bounds(g, "decoder", C, F, M=m,
                                  NO=num_out).items()}})
    _log("embed_bwd", t0, grid=res, g2m_edges=n_g2m, grid_nodes=g,
         **({"k4_worst_rel_rms": f"{max(e_rels.values()):.3g}",
             "k4_plain_ms": f"{e_plain:.3f}", "k4_bit_equal_rerun": True,
             "k5_worst_rel_rms": f"{max(d_rels.values()):.3g}",
             "k5_bit_equal_rerun": True,
             "k5_plain_ms": f"{d_plain:.3f}"} if res == "1p0" else {}),
         k4_ms=f"{e_ms:.3f}", k4_kernel_ms=f"{e_kernel:.3f}",
         k4_gemm_ms=f"{e_gemm:.3f}", k5_ms=f"{d_ms:.3f}",
         k5_kernel_ms=f"{d_kernel:.3f}", k5_gemm_ms=f"{d_gemm:.3f}",
         k4_bound_ms=f"{edge['bound_ms' + suffix]:.4f}",
         k5_bound_ms=f"{dec['bound_ms' + suffix]:.4f}")
    del weights, det, acts, dout, edges
    torch.cuda.empty_cache()
  # The feature-gradient pass at the 1.0° step's shapes: K4's rows (the
  # grid2mesh edges) and K5's (3 per grid node).
  art = _gencast_artifact(1.0, 5)
  for name, rows in (("k4", art.grid2mesh.senders.size),
                     ("k5", 3 * art.num_grid_nodes)):
    x = _randn(torch, gen, (rows, F), 1.0, bf16)
    dxe = _randn(torch, gen, (rows, C), 1.0, bf16)
    w0 = _randn(torch, gen, (F, C), 0.5, bf16)
    got_w, want_w = (torch.zeros(F, C, device=DEVICE) for _ in range(2))
    got_x = feature_grad(x, dxe, w0, got_w)
    want_x = feature_grad_reference(x, dxe, w0, want_w)
    torch.cuda.synchronize()
    f_abs, f_rels = _check_grads(f"embed_bwd feature_grad {name}",
                                 {"dw0": got_w, "dx": got_x},
                                 {"dw0": want_w, "dx": want_x}, WGRAD_RTOL)
    worst["fg"] = max(worst["fg"], f_abs)
    # The block partials are added in a fixed order: a rerun is bit-equal.
    again_w = torch.zeros(F, C, device=DEVICE)
    if not (torch.equal(feature_grad(x, dxe, w0, again_w), got_x)
            and torch.equal(again_w, got_w)):
      raise AssertionError(f"embed_bwd feature_grad {name}: two runs differ")
    # In turns with its two products as bf16 cuBLAS calls (the library
    # yardstick), 20 calls a turn.
    ms, library_ms = _time_in_turns(
        torch, lambda: feature_grad(x, dxe, w0, got_w),
        lambda: (x.t() @ dxe, dxe @ w0.t()), reps=20)
    suffix = "" if name == "k4" else "_k5"
    fg.update({"ms" + suffix: ms, "library_ms" + suffix: library_ms,
               "plain_ms" + suffix: _time_ms(torch, lambda: (
                   feature_grad_reference(x, dxe, w0, want_w))),
               **{k + suffix: v for k, v in _bound(
                   4 * rows * F * C,
                   rows * (C + F) * 2 + F * C * 2 + 2 * F * C * 4
                   + rows * F * 4).items()}})
    _log("embed_bwd", t0, feature_grad=name, rows=rows,
         worst_rel_rms=f"{max(f_rels.values()):.3g}", bit_equal_rerun=True,
         ms=f"{fg['ms' + suffix]:.4f}",
         library_ms=f"{fg['library_ms' + suffix]:.4f}",
         plain_ms=f"{fg['plain_ms' + suffix]:.3f}",
         bound_ms=f"{fg['bound_ms' + suffix]:.4f}")
    del x, dxe, w0, got_w, want_w, got_x, want_x, again_w
  edge["max_abs_err"] = worst["edge"]
  dec["max_abs_err"] = worst["dec"]
  fg["max_abs_err"] = worst["fg"]
  results.update(fused_edge_bwd_embed=edge, fused_decoder_bwd_embed=dec,
                 feature_grad=fg)
  torch.cuda.empty_cache()


_DEGENERATE = ("norm_conditioning", "mha_final", "ffw_down")


def _redraw_degenerate(model, seed):
  """Redraws the weights that the released init makes about zero (every
  norm conditioning, mha_final, ffw_down) as seeded normal draws of stddev
  1/sqrt(fan_in), carried in by params.load_params: otherwise attention
  and the noise conditioning would vanish from the output."""
  from graphcast_tpu_torch import params
  flat = {k: p.detach().cpu().numpy()
          for k, p in params.flat_params(model).items()}
  rng = np.random.RandomState(seed)
  for key in sorted(flat):
    if any(part in key for part in _DEGENERATE):
      fan_in = flat[key.rsplit("/", 1)[0] + "/w"].shape[0]
      flat[key] = (rng.randn(*flat[key].shape)
                   / np.sqrt(fan_in)).astype(np.float32)
  params.load_params(model, flat)


def _gencast_stack(torch, preset, seed, device=None, sequence_parallel=None,
                   **forms):
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.wrappers import InputsAndResiduals, NaNCleaner
  device = device or DEVICE
  model = preset.build(generator=torch.Generator().manual_seed(seed),
                       device=device, sequence_parallel=sequence_parallel,
                       **forms)
  _redraw_degenerate(model, seed)
  stats = synthetic.make_norm_stats(preset.task_config, device=device)
  return model, NaNCleaner(InputsAndResiduals(model, *stats),
                           var_to_clean="sea_surface_temperature",
                           fill_value=0.0)


def _gencast_label(preset):
  a = preset.denoiser_architecture_config
  st = a.sparse_transformer_config
  return (f"{preset.name}:{preset.resolution}deg/"
          f"{len(preset.task_config.pressure_levels)}lev/mesh{a.mesh_size}/"
          f"latent{a.latent_size}/{st.num_layers}x{st.num_heads}heads/"
          f"khop{st.attention_k_hop}/{preset.sampler_config.num_noise_levels}"
          "levels")


def phase_gencast(torch, results, profile_dir=None):
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  t0 = time.perf_counter()
  preset = zoo.gencast_1p0deg()
  model, stack = _gencast_stack(torch, preset, seed=0)
  data = synthetic.make_example_batch(
      preset.task_config, resolution=preset.resolution, batch=1,
      num_target_times=1, time_step_hours=12, device=DEVICE)
  inputs, targets, forcings = (fs.astype(torch.bfloat16) for fs in data)
  setup_s = time.perf_counter() - t0

  def step(seed):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    with torch.inference_mode():
      return stack(inputs, targets, forcings, generator=gen)

  t1 = time.perf_counter()
  step(100)  # warm-up: builds the graph, the attention mask, the SHT basis
  torch.cuda.synchronize()
  warm_s = time.perf_counter() - t1
  torch.cuda.reset_peak_memory_stats()
  _reset_counters()
  t2 = time.perf_counter()
  samples = [step(1 + i) for i in range(GENCAST_STEPS)]
  torch.cuda.synchronize()
  steps_s = time.perf_counter() - t2
  counts = {k: fn.launches for k, fn in _counters().items()}
  from graphcast_tpu_torch.ops.fused_decoder import fused_decode
  from graphcast_tpu_torch.ops.fused_edge import fused_edge
  embed = {"fused_edge_embed": fused_edge.embed_launches,
           "fused_decoder_embed": fused_decode.embed_launches}
  peak_gb = torch.cuda.max_memory_allocated() / 1e9

  evals = 2 * preset.sampler_config.num_noise_levels - 1
  layers = preset.denoiser_architecture_config.sparse_transformer_config
  expected = {"splash_fwd": evals * layers.num_layers,
              "fused_edge_embed": evals, "fused_decoder_embed": evals}
  got = {"splash_fwd": counts["splash_fwd"], **embed}
  if (any(got[k] != n * GENCAST_STEPS for k, n in expected.items())
      or counts["fused_edge"] != embed["fused_edge_embed"]
      or counts["fused_decoder"] != embed["fused_decoder_embed"]
      or counts["segment_sum"]):
    raise AssertionError(f"gencast launches {got} (all {counts}), expected "
                         f"{expected} per step")
  for name in targets.var_names:
    for sample in samples:
      f = sample[name]
      if f.shape != targets[name].shape:
        raise AssertionError(f"{name}: shape {f.shape} != "
                             f"{targets[name].shape}")
      if not torch.isfinite(f.data.float()).all():
        raise AssertionError(f"{name}: non-finite values in the sample")
  if torch.equal(samples[0].data("temperature"),
                 samples[1].data("temperature")):
    raise AssertionError("two generators gave the same sample")
  if profile_dir:
    _profile_step(torch, lambda: step(7), profile_dir, "gencast_step")
  for name, n in got.items():
    results[name].update(launches=n, launches_per_step=n / GENCAST_STEPS)
  spread = (samples[0].data("temperature").float()
            - samples[1].data("temperature").float()).square().mean().sqrt()
  _log("gencast", t0, config=_gencast_label(preset), steps=GENCAST_STEPS,
       setup_s=f"{setup_s:.1f}", warmup_step_s=f"{warm_s:.2f}",
       s_per_12h_step=f"{steps_s / GENCAST_STEPS:.4f}",
       peak_mem_gb=f"{peak_gb:.2f}",
       **{f"{k}_per_step": n // GENCAST_STEPS for k, n in got.items()},
       member_spread_t_rms=f"{float(spread):.4g}", finite=True)
  del model, stack, samples
  torch.cuda.empty_cache()


MINI_SEED = 12             # weights of the GenCast Mini phases
MINI_SIGMAS = (80.0, 1.0, 0.03)
MINI_LAYERS = 2            # their transformer depth (the preset has 16)


def _mini_preset():
  """zoo.gencast_mini() with its transformer cut to MINI_LAYERS layers:
  the Mini phases' CPU references cost about a third less."""
  from graphcast_tpu_torch.models import zoo
  preset = zoo.gencast_mini()
  arch = preset.denoiser_architecture_config
  return dataclasses.replace(preset, denoiser_architecture_config=(
      dataclasses.replace(arch, sparse_transformer_config=dataclasses.replace(
          arch.sparse_transformer_config, num_layers=MINI_LAYERS))))


def _denoise(torch, model, inputs, noisy, levels, forcings, dtype, device):
  """One preconditioned denoiser evaluation in ``dtype`` on ``device``."""
  cast = lambda fs: fs.astype(dtype).to(device)  # noqa: E731
  with torch.inference_mode():
    return model._preconditioned_denoiser(
        cast(inputs), cast(noisy), levels.to(dtype).to(device),
        cast(forcings))


@functools.lru_cache(maxsize=None)
def _mini_references(torch):
  """zoo.gencast_mini()'s batch-1 synthetic (inputs, targets, forcings) on
  the CPU, and per noise level of MINI_SIGMAS the noisy targets and one
  preconditioned evaluation of the port on the CPU from them, {bf16: out}
  in f32 and bf16. Built once: ensemble_small holds its members to the
  same runs."""
  from graphcast_tpu_torch.data import synthetic
  preset = _mini_preset()
  data = synthetic.make_example_batch(
      preset.task_config, resolution=preset.resolution, batch=1,
      num_target_times=1, time_step_hours=12, device="cpu")
  inputs, targets, forcings = data
  cpu, _ = _gencast_stack(torch, preset, seed=MINI_SEED, device="cpu")
  rng = np.random.RandomState(11)
  refs = {}
  for sigma in MINI_SIGMAS:
    noisy = targets.map_data(
        lambda x: x + sigma * torch.from_numpy(
            rng.randn(*x.shape).astype(np.float32)))
    refs[sigma] = noisy, {bf16: _denoise(
        torch, cpu, inputs, noisy, torch.tensor([sigma]), forcings,
        torch.bfloat16 if bf16 else torch.float32, "cpu")
                          for bf16 in (False, True)}
  return data, refs


def _card_mini(torch, preset):
  """The GenCast Mini phases' model on the card, checked to carry the
  same weights as the CPU references' model."""
  from graphcast_tpu_torch import params
  card, _ = _gencast_stack(torch, preset, seed=MINI_SEED)
  cpu, _ = _gencast_stack(torch, preset, seed=MINI_SEED, device="cpu")
  if not all(torch.equal(a.cpu(), b) for a, b in zip(
      params.flat_params(card).values(), params.flat_params(cpu).values())):
    raise AssertionError("CPU and card models differ in their weights")
  return card


def phase_gencast_small(torch):
  t0 = time.perf_counter()
  preset = _mini_preset()
  (inputs, targets, forcings), refs = _mini_references(torch)
  card = _card_mini(torch, preset)
  worst = 0.0
  for sigma, (noisy, outs) in refs.items():
    out_card = _denoise(torch, card, inputs, noisy, torch.tensor([sigma]),
                        forcings, torch.bfloat16, DEVICE)
    worst = max(worst, _check_noise_floor(
        torch, f"gencast_small sigma={sigma}",
        {n: out_card.data(n) for n in targets.var_names}, outs,
        targets.var_names))
  _log("gencast_small", t0, config=_gencast_label(preset),
       sigmas="80,1,0.03", worst_err_over_bound=f"{worst:.3f}")
  del card
  torch.cuda.empty_cache()


def _gencast_train_data(torch, preset, device, dtype):
  """Synthetic batch-1 (inputs, targets, forcings) in ``dtype`` on
  ``device``, with sea-surface temperature NaN on the first
  SST_NAN_ROWS latitude rows of the inputs and targets, for the NaN
  cleaner to fill."""
  from graphcast_tpu_torch.data import synthetic
  data = synthetic.make_example_batch(
      preset.task_config, resolution=preset.resolution, batch=1,
      num_target_times=1, time_step_hours=12, device=device)
  data = [fs.astype(dtype) for fs in data]
  for fs in data[:2]:
    fs.data("sea_surface_temperature")[..., :SST_NAN_ROWS, :] = float("nan")
  return data


def _gencast_train_launches_per_step(preset, art):
  """Kernel launches per GenCast train step that the graph implies: one
  denoiser evaluation (K6 once per transformer layer, K1 and K2 in embed
  mode once, K1p never) and its backward (K7 and K8 once per layer; K4 in
  embed mode once per BWD_CHUNK_ROWS grid2mesh edges, K5 once per
  BWD_CHUNK_NODES grid nodes; per chunk the weight-gradient reduction 3
  times for K4 (dW1, dWe', dEw1) and 9 for K5 (its 7, dWe', dEw1), and the
  feature pass once; K3's sender mode once per K4 and K5 call). Every
  launch of K1, K2, K4 and K5 is an embed-mode one."""
  from graphcast_tpu_torch.ops import fused_decoder, fused_edge
  layers = preset.denoiser_architecture_config.sparse_transformer_config
  enc = -(-art.grid2mesh.senders.size // fused_edge.BWD_CHUNK_ROWS)
  dec = -(-art.num_grid_nodes // fused_decoder.BWD_CHUNK_NODES)
  return {"fused_edge": 1, "fused_edge_encoder": 0, "fused_edge_embed": 1,
          "fused_edge_pipelined_all": 0, "fused_edge_pipelined_encoder": 0,
          "fused_edge_pipelined_embed": 0,
          "fused_decoder": 1, "fused_decoder_embed": 1,
          "fused_edge_bwd": enc, "fused_edge_bwd_embed": enc,
          "fused_decoder_bwd": dec, "fused_decoder_bwd_embed": dec,
          "weight_grad": 3 * enc + 9 * dec, "feature_grad": enc + dec,
          "splash_fwd": layers.num_layers, "splash_dq": layers.num_layers,
          "splash_dkv": layers.num_layers, "segment_sum": 0,
          "segment_sum_sender": 2}


def phase_gencast_train(torch, results, profile_dir=None):
  from graphcast_tpu_torch import train
  from graphcast_tpu_torch.models import zoo
  t0 = time.perf_counter()
  preset = zoo.gencast_1p0deg()
  model, stack = _gencast_stack(torch, preset, seed=0)
  data = _gencast_train_data(torch, preset, DEVICE, torch.bfloat16)
  step = train.make_train_step(
      stack, train.graphcast_optimizer(model.parameters(), peak_lr=1e-3))
  gen = torch.Generator(device=DEVICE).manual_seed(5)
  before = [p.detach().clone() for p in model.parameters()]
  setup_s = time.perf_counter() - t0
  t1 = time.perf_counter()
  # Warm-up: builds the graph, the attention mask, the SHT basis.
  losses = [step(*data, generator=gen)[0]]
  torch.cuda.synchronize()
  warm_s = time.perf_counter() - t1

  expected = _gencast_train_launches_per_step(
      preset, model.architecture._artifact)
  torch.cuda.reset_peak_memory_stats()
  _reset_counters()
  t2 = time.perf_counter()
  for _ in range(TRAIN_STEPS):
    losses.append(step(*data, generator=gen)[0])
  torch.cuda.synchronize()
  train_s = time.perf_counter() - t2
  counts = {**{k: fn.launches for k, fn in _counters().items()},
            **_mode_counts()}
  peak_gb = torch.cuda.max_memory_allocated() / 1e9

  if counts != {k: n * TRAIN_STEPS for k, n in expected.items()}:
    raise AssertionError(f"gencast_train launches {counts}, expected "
                         f"{expected} per step")
  losses = [float(v) for v in losses]
  if not all(np.isfinite(losses)):
    raise AssertionError(f"non-finite GenCast training losses {losses}")
  if all(torch.equal(a, p) for a, p in zip(before, model.parameters())):
    raise AssertionError("the GenCast train steps changed no parameter")
  del before
  if profile_dir:
    _profile_step(torch, lambda: step(*data, generator=gen), profile_dir,
                  "gencast_train_step")
  for name in ("splash_dq", "splash_dkv", "fused_edge_bwd_embed",
               "fused_decoder_bwd_embed", "feature_grad"):
    results[name].update(launches=counts[name],
                         launches_per_step=counts[name] / TRAIN_STEPS)
  for name in ("splash_fwd", "fused_edge_embed", "fused_decoder_embed",
               "weight_grad", "segment_sum_sender"):
    results[name]["gencast_train_launches"] = counts[name]
  _log("gencast_train", t0, config=_gencast_label(preset),
       steps=TRAIN_STEPS, sst_nan_rows=SST_NAN_ROWS,
       setup_s=f"{setup_s:.1f}", warmup_step_s=f"{warm_s:.2f}",
       s_per_step=f"{train_s / TRAIN_STEPS:.4f}",
       peak_mem_gb=f"{peak_gb:.2f}",
       losses="[" + ",".join(f"{v:.6g}" for v in losses) + "]",
       **{f"{k}_per_step": n for k, n in expected.items() if n},
       finite=True, params_changed=True)
  del model, stack, step, data
  torch.cuda.empty_cache()


def _fix_noise_draw(torch, model, sigma, seed):
  """Makes ``model``'s training draw return σ = ``sigma`` and numpy noise
  from ``seed``, the same on every device and in every dtype: the card's
  and the CPU's generators draw different numbers."""
  from graphcast_tpu_torch.fields import Field, FieldSet

  def draw(targets, generator):
    del generator
    rng = np.random.RandomState(seed)
    fields = {}
    for n in targets.var_names:
      f = targets[n]
      x = torch.from_numpy(rng.randn(*f.shape).astype(np.float32))
      fields[n] = Field(x.to(f.data.device, f.dtype), f.dims)
    noise = FieldSet(fields, coords=targets.coords)
    f = targets[targets.var_names[0]]
    return (torch.full((targets.sizes["batch"],), sigma, dtype=f.dtype,
                       device=f.data.device), noise)

  model._draw_noise = draw


@functools.lru_cache(maxsize=None)
def _gencast_train_small_references(torch):
  """gencast_train_small's CPU runs, the loss, per-variable losses and
  every gradient in f32 and bf16 on fixed σ and numpy noise; the CPU
  model's parameters; their seconds."""
  from graphcast_tpu_torch import params
  t0 = time.perf_counter()
  preset = _mini_preset()
  cpu = {}
  for bf16 in (False, True):
    cpu_model, stack = _gencast_stack(torch, preset, seed=16, device="cpu")
    _fix_noise_draw(torch, cpu_model, GENCAST_TRAIN_SMALL_SIGMA, seed=17)
    data = _gencast_train_data(
        torch, preset, "cpu", torch.bfloat16 if bf16 else torch.float32)
    cpu[bf16] = _loss_and_grads(torch, stack, cpu_model, data, "cpu",
                                generator=torch.Generator())
  weights = {k: p.detach() for k, p in params.flat_params(cpu_model).items()}
  return cpu, weights, time.perf_counter() - t0


def phase_gencast_train_small(torch):
  from graphcast_tpu_torch import params
  t0 = time.perf_counter()
  preset = _mini_preset()
  cpu, weights, cpu_s = _gencast_train_small_references(torch)
  card_model, card = _gencast_stack(torch, preset, seed=16)
  if not all(torch.equal(p.cpu(), weights[k]) for k, p in
             params.flat_params(card_model).items()):
    raise AssertionError("CPU and card models differ in their weights")
  _fix_noise_draw(torch, card_model, GENCAST_TRAIN_SMALL_SIGMA, seed=17)
  data = _gencast_train_data(torch, preset, "cpu", torch.bfloat16)
  card_loss, card_diag, card_grads = _loss_and_grads(
      torch, card, card_model, data, DEVICE,
      generator=torch.Generator(device=DEVICE))
  torch.cuda.synchronize()
  card_s = time.perf_counter() - t0
  worst = _noise_floor_checks(
      torch, "gencast_train_small", {"loss": card_loss, **card_diag},
      card_grads, {k: (None, {"loss": v[0], **v[1]}, v[2])
                   for k, v in cpu.items()})
  _log("gencast_train_small", t0, config=_gencast_label(preset),
       sigma=GENCAST_TRAIN_SMALL_SIGMA, sst_nan_rows=SST_NAN_ROWS,
       card_loss=f"{float(card_loss):.6g}",
       cpu_f32_loss=f"{float(cpu[False][0]):.6g}",
       card_s=f"{card_s:.1f}", cpu_s=f"{cpu_s:.1f}",
       worst_var_err_over_bound=f"{worst['var']:.3f}",
       worst_param_err_over_bound=f"{worst['param']:.3f}")
  del card_model, card, cpu
  torch.cuda.empty_cache()


def _segment_sum_cost(E, N, C, itemsize=2):
  """(f32 adds, bytes) of one K3 call: each message read once, each output
  row written once, the CSR offsets read once."""
  return E * C, (E + N) * C * itemsize + 4 * (N + 1)


def _segment_library_ms(torch, edges, msgs, want):
  """(ms, call, max-abs vs the plain version) of one PyTorch call for the
  same function: torch.segment_reduce over the CSR offsets; where it
  refuses bf16 on the card, index_add_ into f32 and its casts."""
  offsets = torch.as_tensor(edges.row_offsets, device=DEVICE).long()
  recv = edges.receivers.long()
  try:
    got = torch.segment_reduce(msgs, "sum", offsets=offsets, axis=0)
    fn = lambda: torch.segment_reduce(  # noqa: E731
        msgs, "sum", offsets=offsets, axis=0)
    call = "torch.segment_reduce"
  except RuntimeError as err:
    print(f"[k3] torch.segment_reduce refuses {msgs.dtype}: "
          f"{str(err).splitlines()[0][:120]}", flush=True)
    fn = lambda: torch.zeros(  # noqa: E731
        edges.num_receivers, msgs.shape[1], dtype=torch.float32,
        device=DEVICE).index_add_(0, recv, msgs.float()).to(msgs.dtype)
    got, call = fn(), "index_add_ (f32) + casts"
  err = (got.float() - want.float()).abs().max().item()
  return _time_ms(torch, fn, reps=5), call, err


def phase_k3(torch, art025, results):
  """K3 against its plain version on the real edge sets, bf16: the mesh-5
  multi-mesh and the 1.0° GenCast grid2mesh at C = 4 x 512 (the batch-4
  paths), the 0.25° grid2mesh at C = 2 x 512 (its 3,753-edge receivers)."""
  from graphcast_tpu_torch.ops.fused_edge import EdgeIndex
  from graphcast_tpu_torch.ops.segment_sum import (
      segment_sum_reference, sorted_segment_sum)
  t0 = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(21)
  mesh5 = _geometry(1.0, 5)
  g2m1 = _gencast_artifact(1.0, 5)
  cases = {"": (g2m1.grid2mesh, g2m1.num_grid_nodes, g2m1.num_mesh_nodes,
                2048),
           "_mesh5": (mesh5.mesh, mesh5.num_mesh_nodes, mesh5.num_mesh_nodes,
                      2048),
           "_g2m_0p25": (art025.grid2mesh, art025.num_grid_nodes,
                         art025.num_mesh_nodes, 1024)}
  entry = _entry("segment_sum", "segment_sum.cu",
                 "graphcast_tpu/ops/pallas_mp.py:39", launches=None)
  worst = 0.0
  for suffix, (es, num_snd, num_rcv, C) in cases.items():
    edges = EdgeIndex(es.senders, es.receivers, num_snd, num_rcv, DEVICE)
    msgs = _randn(torch, gen, (edges.num_edges, C), 1.0, torch.bfloat16)
    with torch.inference_mode():
      got = sorted_segment_sum(edges, msgs)
      want = segment_sum_reference(edges, msgs)
      torch.cuda.synchronize()
      max_abs, rel_rms = _check_close(f"k3 {suffix or '_g2m_1p0'}", got, want)
      worst = max(worst, max_abs)
      ms = _time_ms(torch, lambda: sorted_segment_sum(edges, msgs), reps=20)
      plain_ms = _time_ms(torch, lambda: segment_sum_reference(edges, msgs))
      library_ms, library, library_err = _segment_library_ms(
          torch, edges, msgs, want)
    bound = _bound(*_segment_sum_cost(edges.num_edges, num_rcv, C),
                   peak_flops=PEAK_F32)
    entry.update({"ms" + suffix: ms, "plain_ms" + suffix: plain_ms,
                  "library_ms" + suffix: library_ms,
                  **{k + suffix: v for k, v in bound.items()}})
    degrees = np.diff(edges.row_offsets)
    plan = edges.segment_plan()
    _log("k3", t0, edges_set=(suffix or "_g2m_1p0")[1:],
         edges=edges.num_edges, receivers=num_rcv, channels=C,
         max_in_degree=int(degrees.max()), empty=int((degrees == 0).sum()),
         work_items=plan.items.shape[0], split_receivers=plan.splits.shape[0],
         max_abs=f"{max_abs:.4g}", rel_rms=f"{rel_rms:.3g}", ms=f"{ms:.4f}",
         plain_ms=f"{plain_ms:.4f}", library=repr(library),
         library_ms=f"{library_ms:.4f}", library_max_abs=f"{library_err:.4g}",
         bound_ms=f"{bound['bound_ms']:.4f}",
         bound_share=f"{bound['bound_ms'] / ms:.3f}")
    del msgs, got, want, edges
    torch.cuda.empty_cache()
  entry["library"] = library
  entry["max_abs_err"] = worst
  results["segment_sum"] = entry
  _sender_sums(torch, art025, gen, results)


def _sender_sums(torch, art025, gen, results):
  """K3's sender mode against its plain version at the 0.25° AR-1 train
  step's three calls (K4 processor on the mesh-6 multimesh, K4 encoder on
  grid2mesh, K5 on mesh2grid; C = 512): f32 sums of bf16 per-edge
  gradients into the senders, a rerun bit-equal, timed in turns with the
  f32 index_add_ it replaced."""
  from graphcast_tpu_torch.ops.fused_edge import EdgeIndex
  from graphcast_tpu_torch.ops.segment_sum import (
      sender_segment_sum, sender_sum_reference)
  t0 = time.perf_counter()
  g, m, C = art025.num_grid_nodes, art025.num_mesh_nodes, 512
  cases = {"": (art025.mesh, m, m), "_g2m": (art025.grid2mesh, g, m),
           "_m2g": (art025.mesh2grid, m, g)}
  entry = _entry("segment_sum_sender", "segment_sum.cu",
                 "graphcast_tpu/ops/pallas_mp.py:39", launches=None,
                 mode="sender", library="index_add_ (f32)")
  worst = 0.0
  for suffix, (es, num_snd, num_rcv) in cases.items():
    edges = EdgeIndex(es.senders, es.receivers, num_snd, num_rcv, DEVICE)
    t1 = time.perf_counter()
    edges.sender_plan()
    plan_s = time.perf_counter() - t1
    msgs = _randn(torch, gen, (edges.num_edges, C), 1.0, torch.bfloat16)
    senders = edges.senders.long()
    with torch.inference_mode():
      got = sender_segment_sum(edges, msgs)
      want = sender_sum_reference(edges, msgs)
      again = sender_segment_sum(edges, msgs)
      torch.cuda.synchronize()
      max_abs, rel_rms = _check_close(f"k3 sender{suffix or '_mesh'}", got,
                                      want)
      if not torch.equal(got, again):
        raise AssertionError(f"k3 sender{suffix}: two runs differ")
      worst = max(worst, max_abs)
      ms, library_ms = _time_in_turns(
          torch, lambda: sender_segment_sum(edges, msgs),
          lambda: torch.zeros(num_snd, C, device=DEVICE).index_add_(
              0, senders, msgs.float()), reps=10)
      plain_ms = _time_ms(torch, lambda: sender_sum_reference(edges, msgs))
    # Each message read once, each f32 sender row written once, the
    # permutation and the plan's offsets read once; E C f32 adds.
    bound = _bound(edges.num_edges * C,
                   edges.num_edges * (C * 2 + 4) + num_snd * (C * 4 + 4),
                   peak_flops=PEAK_F32)
    entry.update({"ms" + suffix: ms, "plain_ms" + suffix: plain_ms,
                  "library_ms" + suffix: library_ms,
                  **{k + suffix: v for k, v in bound.items()}})
    degrees = np.bincount(es.senders, minlength=num_snd)
    _log("k3", t0, sender_set=(suffix or "_mesh")[1:],
         edges=edges.num_edges, senders=num_snd, channels=C,
         max_out_degree=int(degrees.max()), host_plan_s=f"{plan_s:.2f}",
         max_abs=f"{max_abs:.4g}", rel_rms=f"{rel_rms:.3g}",
         bit_equal_rerun=True, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
         library_ms=f"{library_ms:.4f}",
         bound_ms=f"{bound['bound_ms']:.4f}",
         bound_share=f"{bound['bound_ms'] / ms:.3f}")
    del msgs, got, want, again, edges, senders
    torch.cuda.empty_cache()
  entry["max_abs_err"] = worst
  results["segment_sum_sender"] = {
      **results.get("segment_sum_sender", {}), **entry}


def _check_fieldset(torch, name, fs, template):
  """Every variable of ``template`` finite in ``fs`` and of its shape."""
  for var in template.var_names:
    f = fs[var]
    if f.shape != template[var].shape:
      raise AssertionError(f"{name} {var}: shape {f.shape} != "
                           f"{template[var].shape}")
    if not torch.isfinite(f.data.float()).all():
      raise AssertionError(f"{name} {var}: non-finite values")


def phase_ensemble(torch, results, profile_dir=None):
  """GenCast's ensemble forecast, this slice's main path (module doc)."""
  from graphcast_tpu_torch import rollout
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  from graphcast_tpu_torch.rollout import tile_batch
  t0 = time.perf_counter()
  preset = zoo.gencast_1p0deg()
  model, stack = _gencast_stack(torch, preset, seed=0)
  data = synthetic.make_example_batch(
      preset.task_config, resolution=preset.resolution, batch=1,
      num_target_times=ENSEMBLE_STEPS, time_step_hours=12, device=DEVICE)
  inputs, targets, forcings = (fs.astype(torch.bfloat16) for fs in data)
  setup_s = time.perf_counter() - t0

  def run(seed, steps):
    part = slice(0, steps)
    return rollout.chunked_ensemble_prediction(
        stack, torch.Generator(device=DEVICE).manual_seed(seed), inputs,
        targets.isel(time=part), forcings.isel(time=part),
        num_samples=ENSEMBLE_MEMBERS, pull_to_host=False)

  t1 = time.perf_counter()
  run(100, 1)  # warm-up: one chunk; builds the graph, mask, SHT basis, plan
  torch.cuda.synchronize()
  warm_s = time.perf_counter() - t1
  torch.cuda.reset_peak_memory_stats()
  _reset_counters()
  t2 = time.perf_counter()
  preds = run(1, ENSEMBLE_STEPS)
  torch.cuda.synchronize()
  steps_s = time.perf_counter() - t2
  counts = {k: fn.launches for k, fn in _counters().items()}
  counts.update(_mode_counts())
  peak_gb = torch.cuda.max_memory_allocated() / 1e9

  evals = 2 * preset.sampler_config.num_noise_levels - 1
  layers = preset.denoiser_architecture_config.sparse_transformer_config
  expected = {"segment_sum": 2 * evals,
              "splash_fwd": evals * layers.num_layers,
              "fused_edge": 0, "fused_decoder": 0, "fused_edge_embed": 0,
              "fused_decoder_embed": 0}
  if any(counts[k] != n * ENSEMBLE_STEPS for k, n in expected.items()):
    raise AssertionError(f"ensemble launches {counts}, expected {expected} "
                         "per 12 h step")
  _check_fieldset(torch, "ensemble", preds, tile_batch(targets, ENSEMBLE_MEMBERS))
  again = run(1, 1)
  differ = [n for n in preds.var_names
            if not torch.equal(again.data(n), preds.data(n)[:, :1])]
  if differ:
    raise AssertionError(f"ensemble: the rerun of the first chunk differs "
                         f"in {differ}")
  t = preds.data("temperature").float()
  spread = (t[0] - t[1]).square().mean().sqrt().item()
  if not all((t[0] - t[m]).abs().max().item() > 0
             for m in range(1, ENSEMBLE_MEMBERS)):
    raise AssertionError("ensemble members are not all distinct")
  if profile_dir:
    _profile_step(torch, lambda: run(7, 1), profile_dir, "ensemble_step")
  for name in ("segment_sum", "splash_fwd"):
    results[name]["ensemble_launches"] = counts[name]
  _ENSEMBLE_OUT.update(preds=preds, targets=targets)
  results["segment_sum"].update(
      launches=counts["segment_sum"],
      launches_per_step=counts["segment_sum"] / ENSEMBLE_STEPS)
  _log("ensemble", t0, config=_gencast_label(preset),
       members=ENSEMBLE_MEMBERS, steps=ENSEMBLE_STEPS,
       setup_s=f"{setup_s:.1f}", warmup_chunk_s=f"{warm_s:.2f}",
       s_per_12h_step=f"{steps_s / ENSEMBLE_STEPS:.4f}",
       s_per_member_step=f"{steps_s / ENSEMBLE_STEPS / ENSEMBLE_MEMBERS:.4f}",
       peak_mem_gb=f"{peak_gb:.2f}",
       **{f"{k}_per_step": counts[k] // ENSEMBLE_STEPS for k in expected},
       member_spread_t_rms=f"{spread:.4g}", rerun="bit-equal", finite=True)
  del model, stack, preds, again
  torch.cuda.empty_cache()


def _concat_batch(torch, sets):
  """FieldSets joined along "batch"; variables without a batch axis (the
  statics) are taken from the first."""
  from graphcast_tpu_torch.fields import Field, FieldSet
  first = sets[0]
  fields = {}
  for name in first.var_names:
    f = first[name]
    if "batch" in f.dims:
      f = Field(torch.cat([fs[name].data for fs in sets],
                          dim=f.dims.index("batch")), f.dims)
    fields[name] = f
  return FieldSet(fields, coords=first.coords)


def phase_ensemble_small(torch):
  """zoo.gencast_mini() at batch 2 on the card: one preconditioned denoiser
  evaluation (the general path, K3) per pair of MINI_SIGMAS, a noise level
  per member, each member held to the port on the CPU at its level (the
  gencast_small phase's runs) with the small phase's noise-floor rule."""
  from graphcast_tpu_torch.rollout import tile_batch
  t0 = time.perf_counter()
  preset = _mini_preset()
  (inputs, targets, forcings), refs = _mini_references(torch)
  card = _card_mini(torch, preset)
  k3 = _counters()["segment_sum"]
  launches_before = k3.launches
  pairs = list(zip(MINI_SIGMAS, MINI_SIGMAS[1:] + MINI_SIGMAS[:1]))
  worst = 0.0
  for pair in pairs:
    noisy = _concat_batch(torch, [refs[sigma][0] for sigma in pair])
    out = _denoise(torch, card, tile_batch(inputs, 2), noisy,
                   torch.tensor(pair), tile_batch(forcings, 2),
                   torch.bfloat16, DEVICE)
    for member, sigma in enumerate(pair):
      worst = max(worst, _check_noise_floor(
          torch, f"ensemble_small member {member} sigma={sigma}",
          {n: out.data(n)[member:member + 1] for n in targets.var_names},
          refs[sigma][1], targets.var_names))
  if k3.launches - launches_before != 2 * len(pairs):
    raise AssertionError(f"ensemble_small: K3 launched "
                         f"{k3.launches - launches_before} times, expected "
                         f"{2 * len(pairs)}")
  _log("ensemble_small", t0, config=_gencast_label(preset), batch=2,
       sigma_pairs=",".join(f"({a:g},{b:g})" for a, b in pairs),
       k3_launches=2 * len(pairs), worst_err_over_bound=f"{worst:.3f}")
  del card
  torch.cuda.empty_cache()


def phase_graphcast_batch(torch, results, profile_dir=None):
  """GraphCast_small at batch BATCH (module doc): member 0 of one step
  (the small phase's inputs) against the small phase's CPU runs and a
  batch-1 card step, then the timed rollout."""
  from graphcast_tpu_torch.data import synthetic
  t0 = time.perf_counter()
  preset = _small_preset()
  mc = preset.model_config
  _, card = _stack(torch, preset, seed=SMALL_SEED)
  card = card.to(DEVICE)
  member0, outs = _small_references(torch)
  others = synthetic.make_example_batch(
      preset.task_config, resolution=mc.resolution, batch=BATCH - 1, seed=1,
      device="cpu")
  one_step = [_concat_batch(torch, pair).astype(torch.bfloat16).to(DEVICE)
              for pair in zip(member0, others)]
  data = synthetic.make_example_batch(
      preset.task_config, resolution=mc.resolution, batch=BATCH,
      num_target_times=BATCH_STEPS, device="cpu")
  inputs, targets, forcings = (fs.astype(torch.bfloat16).to(DEVICE)
                               for fs in data)
  one = slice(0, 1)
  setup_s = time.perf_counter() - t0

  # One step at batch BATCH (also the warm-up) and member 0 alone.
  t1 = time.perf_counter()
  with torch.inference_mode():
    step = card(*one_step)
  torch.cuda.synchronize()
  warm_s = time.perf_counter() - t1
  with torch.inference_mode():
    single = card(*(fs.astype(torch.bfloat16).to(DEVICE) for fs in member0))
  names = member0[1].var_names
  got = {n: step.data(n)[:1] for n in names}
  worst = _check_noise_floor(torch, "graphcast_batch member 0 vs batch 1",
                             got, outs, names,
                             ref={n: single.data(n) for n in names})
  worst_cpu = _check_noise_floor(torch, "graphcast_batch member 0 vs cpu",
                                 got, outs, names)

  torch.cuda.reset_peak_memory_stats()
  _reset_counters()
  t2 = time.perf_counter()
  final = card.rollout_final(inputs, targets.isel(time=one), forcings)
  torch.cuda.synchronize()
  rollout_s = time.perf_counter() - t2
  counts = {k: fn.launches for k, fn in _counters().items()}
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  expected = {"segment_sum": 2 + mc.gnn_msg_steps, "fused_edge": 0,
              "fused_decoder": 0}
  if any(counts[k] != n * BATCH_STEPS for k, n in expected.items()):
    raise AssertionError(f"graphcast_batch launches {counts}, expected "
                         f"{expected} per step")
  _check_fieldset(torch, "graphcast_batch", final,
                  inputs.select(list(final.var_names)))
  again = card.rollout_final(inputs, targets.isel(time=one), forcings)
  differ = [n for n in final.var_names
            if not torch.equal(again.data(n), final.data(n))]
  if differ:
    raise AssertionError(f"graphcast_batch: the rerun differs in {differ}")
  if profile_dir:
    _profile_step(torch, lambda: card.rollout_final(
        inputs, targets.isel(time=one), forcings.isel(time=one)), profile_dir,
                  "graphcast_batch_step")
  results["segment_sum"]["graphcast_batch_launches"] = counts["segment_sum"]
  _log("graphcast_batch", t0, config=_label(preset), batch=BATCH,
       steps=BATCH_STEPS, setup_s=f"{setup_s:.1f}",
       warmup_1step_s=f"{warm_s:.2f}", rollout_s=f"{rollout_s:.3f}",
       s_per_step=f"{rollout_s / BATCH_STEPS:.4f}",
       peak_mem_gb=f"{peak_gb:.2f}",
       **{f"{k}_per_step": counts[k] // BATCH_STEPS for k in expected},
       member0_vs_batch1_over_bound=f"{worst:.3f}",
       member0_vs_cpu_over_bound=f"{worst_cpu:.3f}", rerun="bit-equal",
       finite=True)
  del card, step, single, final, again
  torch.cuda.empty_cache()


FORECAST_STEPS = 2          # 6 h steps of the forecast phase
FORECAST_SEED = 5           # its ERA5-shaped dataset
TISR_ATOL = 1e-4            # TISR card vs CPU, relative to the field's max
GENCAST_0P25_STEPS = 1      # timed 12 h steps of the 0.25° GenCast step
TRIBLOCK_ATOL = 5e-4        # triblockdiag_mha card vs CPU, f32, of the max
CRPS_RTOL = 1e-5            # crps_ensemble card vs CPU, relative


def _const_lr_optimizer(model):
  """ClippedAdamW at a constant learning rate of 1e-3: the first step
  moves every parameter (graphcast_optimizer's warmup starts at 0)."""
  from graphcast_tpu_torch import train
  return train.ClippedAdamW(model.parameters(), lambda count: 1e-3, b1=0.9,
                            b2=0.95, eps=1e-8, weight_decay=0.1,
                            clip_norm=32.0)


def _dp_data(torch):
  """GraphCast_small's global batch of PARALLEL_WORLD examples (bf16)."""
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  preset = zoo.graphcast_small()
  data = synthetic.make_example_batch(
      preset.task_config, resolution=preset.model_config.resolution,
      batch=PARALLEL_WORLD, num_target_times=1, device=DEVICE)
  return preset, [fs.astype(torch.bfloat16) for fs in data]


def _parallel_rank(rank, out_dir):
  """One rank of the parallel phase (module doc): (a) the data-parallel
  GraphCast_small train step, (b) the GenCast 1.0° train step with its
  transformer split over "sp", (c) the ensemble's members split over
  "batch". Writes its numbers to out_dir/rank<r>.json and, from rank 0,
  the tensors the parent checks."""
  import torch
  from graphcast_tpu_torch import rollout, train
  from graphcast_tpu_torch.models import zoo
  from graphcast_tpu_torch.parallel import sharding
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  out = {"rank": rank}
  # (a) Data parallelism: one example per rank.
  t0 = time.perf_counter()
  mesh = sharding.make_mesh({"batch": PARALLEL_WORLD})
  preset, data = _dp_data(torch)
  local = train.shard_batch(mesh, *data)
  model, stack = _stack(torch, preset, seed=0, device=DEVICE,
                        gradient_checkpointing=True)
  step = train.make_train_step(stack, _const_lr_optimizer(model), mesh)
  losses = [float(step(*local)[0])]
  torch.cuda.synchronize()
  out["dp_first_step_s"] = time.perf_counter() - t0
  if rank == 0:
    torch.save({k: p.detach().cpu() for k, p in model.named_parameters()},
               os.path.join(out_dir, "dp_params.pt"))
  torch.cuda.reset_peak_memory_stats()
  _reset_counters()
  t1 = time.perf_counter()
  for _ in range(PARALLEL_STEPS):
    losses.append(float(step(*local)[0]))
  torch.cuda.synchronize()
  out["dp_s_per_step"] = (time.perf_counter() - t1) / PARALLEL_STEPS
  out["dp_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
  out["dp_losses"] = losses
  out["dp_counts"] = {**{k: fn.launches for k, fn in _counters().items()},
                      **_mode_counts()}
  del model, stack, step, data, local
  torch.cuda.empty_cache()

  # (b) Sequence parallelism: GenCast 1.0°, the transformer's nodes split.
  t0 = time.perf_counter()
  mesh = sharding.make_mesh({"sp": PARALLEL_WORLD})
  preset = zoo.gencast_1p0deg()
  model, stack = _gencast_stack(torch, preset, seed=0,
                                sequence_parallel=(mesh, "sp"))
  data = _gencast_train_data(torch, preset, DEVICE, torch.bfloat16)

  def sp_step(m, s):
    return _loss_and_grads(torch, s, m, data, DEVICE,
                           generator=torch.Generator(
                               device=DEVICE).manual_seed(5))

  sp_step(model, stack)  # warm-up: mask, shard maps, SHT basis
  torch.cuda.synchronize()
  out["sp_setup_s"] = time.perf_counter() - t0
  torch.cuda.reset_peak_memory_stats()
  _reset_counters()
  t1 = time.perf_counter()
  loss, _, grads = sp_step(model, stack)
  torch.cuda.synchronize()
  out["sp_s_per_step"] = time.perf_counter() - t1
  out["sp_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
  out["sp_counts"] = {k: fn.launches for k, fn in _counters().items()}
  out["sp_loss"] = float(loss)
  out["sp_config"] = _gencast_label(preset)
  out["sp_layers"] = (preset.denoiser_architecture_config
                      .sparse_transformer_config.num_layers)
  del model, stack
  torch.cuda.empty_cache()
  if rank == 0:  # the unsharded step on the same σ, noise and weights
    model, stack = _gencast_stack(torch, preset, seed=0)
    want, _, want_grads = sp_step(model, stack)
    out["sp_unsharded_loss"] = float(want)
    out["sp_grad_rel_rms"] = {k: _errors(grads[k], w)[1]
                              for k, w in want_grads.items()}
    del model, stack, want_grads
  del grads, data
  torch.cuda.empty_cache()

  # (c) The ensemble's members split over "batch": every sum of the
  # general path runs in a fixed order, so the sharded and unsharded
  # ensembles can be held bit for bit.
  t0 = time.perf_counter()
  mesh = sharding.make_mesh({"batch": PARALLEL_WORLD})
  model, stack = _gencast_stack(torch, preset, seed=0)
  inputs, targets, forcings = (
      fs.astype(torch.bfloat16) for fs in _gencast_step_data(preset))

  def ensemble(m):
    return rollout.chunked_ensemble_prediction(
        stack, torch.Generator(device=DEVICE).manual_seed(1), inputs,
        targets, forcings, num_samples=ENSEMBLE_MEMBERS, mesh=m,
        pull_to_host=False)

  _reset_counters()
  sharded = ensemble(mesh)
  torch.cuda.synchronize()
  out["ens_s"] = time.perf_counter() - t0
  out["ens_counts"] = {k: fn.launches for k, fn in _counters().items()}
  if rank == 0:  # the unsharded ensemble, and its rerun
    runs = [ensemble(None) for _ in range(2)]
    torch.save({key: {n: fs.data(n).float().cpu() for n in fs.var_names}
                for key, fs in zip(("sharded", "whole", "again"),
                                   (sharded, *runs))},
               os.path.join(out_dir, "ensemble.pt"))
  with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)


def _gencast_step_data(preset):
  """GenCast's batch-1 inputs, one 12 h target and its forcings."""
  from graphcast_tpu_torch.data import synthetic
  return synthetic.make_example_batch(
      preset.task_config, resolution=preset.resolution, batch=1,
      num_target_times=1, time_step_hours=12, device=DEVICE)


def _parallel_launches(dp_preset, sp_layers):
  """The launches the parallel phase's ranks must count: per data-parallel
  step (per PARALLEL_STEPS), per sequence-parallel step, and the kernels
  the ensemble must have launched."""
  mc = dp_preset.model_config
  dp = _train_launches_per_step(_geometry(mc.resolution, mc.mesh_size),
                                mc.gnn_msg_steps)
  return {"dp": dp,
          "sp": {k: sp_layers for k in ("splash_fwd", "splash_dq",
                                         "splash_dkv")},
          "ensemble": ("splash_fwd", "segment_sum")}


def phase_parallel(torch, results):
  """Data, sequence and ensemble parallelism over torch.distributed
  (module doc): PARALLEL_WORLD ranks, one per card over nccl where there
  are enough cards, else all on the one card over gloo."""
  import tempfile
  from graphcast_tpu_torch import train
  from graphcast_tpu_torch.parallel import launch
  t0 = time.perf_counter()
  backend = launch.default_backend(PARALLEL_WORLD, "cuda")
  staging = ("; gloo runs all-reduce, all-gather and broadcast on CUDA "
             "tensors itself, the port stages nothing through the host"
             if backend == "gloo" else "")
  print(f"[parallel] backend={backend} world_size={PARALLEL_WORLD} "
        f"cards={torch.cuda.device_count()}{staging}", flush=True)
  torch.cuda.empty_cache()
  with tempfile.TemporaryDirectory(dir=os.path.dirname(
      os.path.abspath(__file__))) as out_dir:
    launch.spawn(_parallel_rank, PARALLEL_WORLD, args=(out_dir,),
                 device="cuda", timeout_s=300)
    ranks = []
    for r in range(PARALLEL_WORLD):
      with open(os.path.join(out_dir, f"rank{r}.json")) as f:
        ranks.append(json.load(f))
    got = torch.load(os.path.join(out_dir, "dp_params.pt"))
    ens = torch.load(os.path.join(out_dir, "ensemble.pt"))
  spawn_s = time.perf_counter() - t0

  # (a) One process: both examples' batch-1 gradients, averaged, stepped.
  preset, data = _dp_data(torch)
  model, stack = _stack(torch, preset, seed=0, device=DEVICE,
                        gradient_checkpointing=True)
  opt = _const_lr_optimizer(model)
  loss_fn = train.make_loss_fn(stack)
  grads = []
  for r in range(PARALLEL_WORLD):
    opt.zero_grad()
    loss_fn(*(fs.isel(batch=slice(r, r + 1)) for fs in data))[0].backward()
    opt.fill_grads()
    grads.append([p.grad for p in opt.params])
  for p, *gs in zip(opt.params, *grads):
    total = gs[0].clone()
    for g in gs[1:]:
      total += g
    p.grad = total.div_(PARALLEL_WORLD)
  opt.step()
  differ = [k for k, p in model.named_parameters()
            if not torch.equal(p.detach().cpu(), got[k])]
  if differ:
    raise AssertionError(f"parallel dp: {len(differ)} parameters differ "
                         f"from the averaged single-process step: "
                         f"{differ[:3]}")
  del model, stack, opt, grads, got, data
  torch.cuda.empty_cache()
  expected = _parallel_launches(preset, ranks[0]["sp_layers"])
  for r in ranks:
    for name, per_step in expected["dp"].items():
      if r["dp_counts"][name] != per_step * PARALLEL_STEPS:
        raise AssertionError(f"parallel dp rank {r['rank']} launches "
                             f"{r['dp_counts']}, expected {expected}")
    if not np.isfinite(r["dp_losses"]).all():
      raise AssertionError(f"parallel dp non-finite losses {r['dp_losses']}")
  if len({tuple(r["dp_losses"]) for r in ranks}) != 1:
    raise AssertionError("parallel dp: ranks report different losses")
  dp = ranks[0]

  # (b) Sequence parallelism against the unsharded step.
  layers = ranks[0]["sp_layers"]
  for r in ranks:
    for name, n in expected["sp"].items():
      if r["sp_counts"][name] != n:
        raise AssertionError(f"parallel sp rank {r['rank']}: {name} "
                             f"launched {r['sp_counts'][name]} times, "
                             f"expected {n}")
  loss_rel = abs(ranks[0]["sp_loss"] - ranks[0]["sp_unsharded_loss"]
                 ) / abs(ranks[0]["sp_unsharded_loss"])
  worst_grad = max(ranks[0]["sp_grad_rel_rms"].values())
  if not (loss_rel <= SP_TRAIN_RTOL and worst_grad <= SP_TRAIN_RTOL):
    bad = {k: v for k, v in ranks[0]["sp_grad_rel_rms"].items()
           if not v <= SP_TRAIN_RTOL}
    raise AssertionError(f"parallel sp: loss rel {loss_rel:.3g}, grads "
                         f"beyond {SP_TRAIN_RTOL}: {bad}")
  for name in ("splash_fwd_shard", "splash_dq_shard", "splash_dkv_shard"):
    key = name.rsplit("_", 1)[0]
    results.setdefault(name, {"name": name}).update(
        launches=ranks[0]["sp_counts"][key], launches_per_step=layers)

  # (c) The sharded ensemble member by member against the unsharded one.
  for r in ranks:
    if any(r["ens_counts"][name] == 0 for name in expected["ensemble"]):
      raise AssertionError(f"parallel ensemble rank {r['rank']} ran no "
                           f"kernel: {r['ens_counts']}")
  member_rel, rerun_rel, differ = [], [], []
  for name, whole in ens["whole"].items():
    for m in range(ENSEMBLE_MEMBERS):
      member_rel.append(_errors(ens["sharded"][name][m], whole[m])[1])
      rerun_rel.append(_errors(ens["again"][name][m], whole[m])[1])
      if not torch.equal(ens["sharded"][name][m], whole[m]):
        differ.append(f"{name}[{m}]")
    if not torch.equal(ens["again"][name], whole):
      raise AssertionError(
          f"parallel ensemble: the unsharded ensemble's rerun differs in "
          f"{name} (rel_rms {max(rerun_rel):.3g})")
  if differ:
    raise AssertionError(
        f"parallel ensemble: {len(differ)} member fields differ from the "
        f"unsharded ensemble ({differ[:4]}), worst rel_rms "
        f"{max(member_rel):.3g}")
  _log("parallel", t0, backend=backend, world_size=PARALLEL_WORLD,
       spawn_s=f"{spawn_s:.1f}",
       dp_config=_label(preset) + "/AR1",
       dp_global_batch=PARALLEL_WORLD, dp_params="bit-equal",
       dp_s_per_step=f"{dp['dp_s_per_step']:.4f}",
       dp_peak_gb_per_rank="/".join(f"{r['dp_peak_gb']:.2f}" for r in ranks),
       dp_losses="[" + ",".join(f"{v:.6g}" for v in dp["dp_losses"]) + "]",
       dp_launches_per_step="/".join(f"{k}:{n}" for k, n in
                                     expected["dp"].items()),
       sp_config=ranks[0]["sp_config"], sp=PARALLEL_WORLD,
       sp_s_per_step=f"{ranks[0]['sp_s_per_step']:.4f}",
       sp_peak_gb_per_rank="/".join(f"{r['sp_peak_gb']:.2f}" for r in ranks),
       sp_loss=f"{ranks[0]['sp_loss']:.6g}",
       unsharded_loss=f"{ranks[0]['sp_unsharded_loss']:.6g}",
       sp_loss_rel=f"{loss_rel:.3g}", sp_worst_grad_rel_rms=f"{worst_grad:.3g}",
       sp_k6_k7_k8_per_step=layers,
       ens_members=ENSEMBLE_MEMBERS, ens_s=f"{ranks[0]['ens_s']:.2f}",
       ens_members_bit_equal=True, ens_rerun_bit_equal=True)


def phase_forecast(torch, results):
  """The GraphCast demo's path at full width (module doc)."""
  import io
  from graphcast_tpu_torch import evaluation
  from graphcast_tpu_torch.compat import haiku_checkpoint
  from graphcast_tpu_torch.data import era5, solar_radiation, synthetic
  from graphcast_tpu_torch.fields import Field, FieldSet
  from graphcast_tpu_torch.models import zoo
  from graphcast_tpu_torch.models.graphcast import GraphCast
  from graphcast_tpu_torch.params import flat_params
  t0 = time.perf_counter()
  torch.cuda.reset_peak_memory_stats()
  preset = zoo.graphcast()
  mc, tc = preset.model_config, preset.task_config
  parts = {}

  def part(name, t):
    torch.cuda.synchronize()
    parts[name] = time.perf_counter() - t

  # 1. The port's random weights through a reference-format bundle.
  model = GraphCast(mc, tc, generator=torch.Generator().manual_seed(0),
                    device=DEVICE)
  t = time.perf_counter()
  bundle = io.BytesIO()
  haiku_checkpoint.save_graphcast_checkpoint(
      bundle, model, mc, tc, description="GraphCast, random weights")
  part("bundle_write_s", t)
  bundle_mb = bundle.tell() / 1e6
  bundle.seek(0)
  t = time.perf_counter()
  loaded, mc2, tc2, _, _ = haiku_checkpoint.load_graphcast_checkpoint(
      bundle, device=DEVICE)
  part("bundle_load_s", t)
  if (mc2, tc2) != (mc, tc):
    raise AssertionError(f"bundle configs differ: {mc2} {tc2}")
  written, read = flat_params(model), flat_params(loaded)
  if set(written) != set(read) or not all(
      torch.equal(written[k], read[k]) for k in written):
    raise AssertionError("the loaded bundle's weights differ from the "
                         "written ones")
  del model

  # 2. An ERA5-shaped dataset on the card: 2 input frames, the targets.
  t = time.perf_counter()
  dataset = synthetic.make_era5_dataset(
      tc, mc.resolution, num_times=2 + FORECAST_STEPS, seed=FORECAST_SEED,
      device=DEVICE)
  part("dataset_s", t)

  # 3. Derived variables and TISR on the card, held against the CPU.
  t = time.perf_counter()
  dataset = era5.add_derived_vars(dataset)
  part("derived_s", t)
  t = time.perf_counter()
  dataset = era5.add_tisr_var(dataset)
  part("tisr_s", t)
  coords = dataset.coords
  t = time.perf_counter()
  tisr_cpu = solar_radiation.get_toa_incident_solar_radiation(
      coords["datetime"][0, :1], coords["lat"], coords["lon"],
      device="cpu")[0]
  tisr_cpu_s = time.perf_counter() - t
  tisr_card = dataset.data(era5.TISR)[0, 0].cpu()
  tisr_err = float((tisr_card - tisr_cpu).abs().max() / tisr_cpu.max())
  # Where the window ends at the terminator, one side's last samples may
  # round to just above 0 and the other's to 0: such points are counted,
  # and held to the tolerance with the rest.
  zeros_differ = int(((tisr_card == 0) != (tisr_cpu == 0)).sum())
  if not tisr_err <= TISR_ATOL:
    raise AssertionError(f"forecast: TISR card vs CPU max-abs {tisr_err:.3g}"
                         f" of the max (tol {TISR_ATOL})")
  probe = FieldSet({"x": Field(torch.zeros(1), ("batch",))},
                   coords={"datetime": coords["datetime"],
                           "lon": coords["lon"]})
  derived_cpu = era5.add_derived_vars(probe)
  for name in era5.DERIVED_VARS:
    if not torch.equal(dataset.data(name).cpu(), derived_cpu.data(name)):
      raise AssertionError(f"forecast: {name} card != CPU")

  # 4. Extract, forecast, score.
  t = time.perf_counter()
  inputs, targets, forcings = era5.extract_inputs_targets_forcings(
      dataset, input_variables=tc.input_variables,
      target_variables=tc.target_variables,
      forcing_variables=tc.forcing_variables,
      pressure_levels=tc.pressure_levels, input_duration=tc.input_duration,
      target_lead_times=slice("6h", f"{6 * FORECAST_STEPS}h"))
  part("extract_s", t)
  del dataset
  stddev, mean, diffs = synthetic.make_norm_stats(tc, device=DEVICE)
  predictor = _wrap(loaded, tc)
  t = time.perf_counter()
  predictor(inputs, targets, forcings)  # builds the graph on the host
  part("first_forecast_s", t)
  _reset_counters()
  t = time.perf_counter()
  preds = predictor(inputs, targets, forcings)
  part("forecast_s", t)
  counts = {k: fn.launches for k, fn in _counters().items()}
  counts.update(_mode_counts())
  steps_per = 1 + mc.gnn_msg_steps
  expected = {"fused_edge": steps_per * FORECAST_STEPS,
              "fused_edge_encoder": FORECAST_STEPS,
              "fused_decoder": FORECAST_STEPS, "segment_sum": 0}
  if any(counts[k] != n for k, n in expected.items()):
    raise AssertionError(f"forecast launches {counts}, expected {expected}")
  _check_fieldset(torch, "forecast", preds, targets)
  t = time.perf_counter()
  rmse = evaluation.rmse(preds, targets)
  acc = evaluation.acc(preds, targets, mean)
  part("scores_s", t)
  for metric, scores in (("rmse", rmse), ("acc", acc)):
    for name, s in scores.items():
      want = targets[name].shape[:2] + (
          (len(tc.pressure_levels),) if "level" in targets[name].dims
          else ())
      if tuple(s.shape) != want or not torch.isfinite(s).all():
        raise AssertionError(f"forecast {metric} {name}: shape "
                             f"{tuple(s.shape)} (want {want}) or not finite")
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  for name in ("fused_edge", "fused_edge_encoder", "fused_decoder"):
    results.setdefault(name, {"name": name})["forecast_launches"] = (
        counts[name] - (counts["fused_edge_encoder"]
                        if name == "fused_edge" else 0))
  _log("forecast", t0, config=_label(preset), steps=FORECAST_STEPS,
       bundle_mb=f"{bundle_mb:.1f}",
       **{k: f"{v:.3f}" for k, v in parts.items()},
       tisr_cpu_1stamp_s=f"{tisr_cpu_s:.2f}",
       tisr_err_of_max=f"{tisr_err:.3g}", tisr_zeros_differ=zeros_differ,
       rmse_t2m=f"{float(rmse['2m_temperature'].mean()):.4f}",
       acc_t2m=f"{float(acc['2m_temperature'].mean()):.4f}",
       peak_mem_gb=f"{peak_gb:.2f}",
       k1_per_step=counts["fused_edge"] // FORECAST_STEPS,
       k2_per_step=counts["fused_decoder"] // FORECAST_STEPS, finite=True)
  del loaded, predictor, preds, inputs, targets, forcings
  torch.cuda.empty_cache()


GENCAST_0P25_CHECK_RES = 1.0   # grid of the 0.25° step's CPU check
GENCAST_0P25_CHECK_LAYERS = 1  # its transformer depth


def _gencast_0p25_check_preset():
  """zoo.gencast_0p25deg()'s denoiser (mesh-6, latent 512, k-hop 16, 4
  heads) on a 1.0° grid with its transformer cut to one layer: the
  card-vs-CPU check of the 0.25° step at a size the CPU runs in about ten
  seconds an evaluation (a 0.25° evaluation would take minutes)."""
  from graphcast_tpu_torch.models import zoo
  preset = zoo.gencast_0p25deg()
  arch = preset.denoiser_architecture_config
  return dataclasses.replace(
      preset, resolution=GENCAST_0P25_CHECK_RES,
      denoiser_architecture_config=dataclasses.replace(
          arch, sparse_transformer_config=dataclasses.replace(
              arch.sparse_transformer_config,
              num_layers=GENCAST_0P25_CHECK_LAYERS)))


@functools.lru_cache(maxsize=None)
def _gencast_0p25_check_references(torch):
  """gencast_0p25's card-vs-CPU check on the CPU: (the check preset, its
  model on the CPU, (inputs, noisy targets at σ = 1, the level,
  forcings), {bf16: one preconditioned evaluation}, seconds). One model:
  its graph and attention mask are built once, here, and the phase then
  moves the same module to the card."""
  from graphcast_tpu_torch.data import synthetic
  t0 = time.perf_counter()
  check = _gencast_0p25_check_preset()
  inputs, targets, forcings = synthetic.make_example_batch(
      check.task_config, resolution=check.resolution, batch=1,
      num_target_times=1, time_step_hours=12, device="cpu")
  model, _ = _gencast_stack(torch, check, seed=MINI_SEED, device="cpu")
  rng = np.random.RandomState(13)
  sigma = 1.0
  noisy = targets.map_data(lambda x: x + sigma * torch.from_numpy(
      rng.randn(*x.shape).astype(np.float32)))
  level = torch.tensor([sigma])
  outs = {bf16: _denoise(torch, model, inputs, noisy, level, forcings,
                         torch.bfloat16 if bf16 else torch.float32, "cpu")
          for bf16 in (False, True)}
  return (check, model, (inputs, noisy, level, forcings), outs,
          time.perf_counter() - t0)


def phase_gencast_0p25(torch, results, profile_dir=None):
  """One 12 h step of zoo.gencast_0p25deg() (module doc)."""
  from graphcast_tpu_torch.examples.graphcast_demo import (
      era5_inputs_targets_forcings)
  from graphcast_tpu_torch.models import zoo
  t0 = time.perf_counter()
  preset = zoo.gencast_0p25deg()
  model, stack = _gencast_stack(torch, preset, seed=0)
  data = era5_inputs_targets_forcings(preset.task_config, preset.resolution,
                                      1, 12, seed=0, device=DEVICE)
  inputs, targets, forcings = (fs.astype(torch.bfloat16) for fs in data)
  del data
  setup_s = time.perf_counter() - t0

  def step(seed):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    with torch.inference_mode():
      return stack(inputs, targets, forcings, generator=gen)

  # Warm-up: one denoiser evaluation builds the graph, its device statics
  # and the attention mask; the sampler's SHT basis is built beside it.
  t1 = time.perf_counter()
  with torch.inference_mode():
    model.noise_basis(targets)
    _denoise(torch, model, inputs, targets, torch.tensor([1.0]), forcings,
             torch.bfloat16, DEVICE)
  torch.cuda.synchronize()
  warm_s = time.perf_counter() - t1
  torch.cuda.reset_peak_memory_stats()
  _reset_counters()
  t2 = time.perf_counter()
  samples = [step(1 + i) for i in range(GENCAST_0P25_STEPS)]
  torch.cuda.synchronize()
  steps_s = time.perf_counter() - t2
  counts = {k: fn.launches for k, fn in _counters().items()}
  counts.update(_mode_counts())
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  evals = 2 * preset.sampler_config.num_noise_levels - 1
  layers = preset.denoiser_architecture_config.sparse_transformer_config
  expected = {"splash_fwd": evals * layers.num_layers,
              "fused_edge_embed": evals, "fused_decoder_embed": evals,
              "fused_edge": evals, "fused_decoder": evals, "segment_sum": 0}
  if any(counts[k] != n * GENCAST_0P25_STEPS for k, n in expected.items()):
    raise AssertionError(f"gencast_0p25 launches {counts}, expected "
                         f"{expected} per step")
  for sample in samples:
    _check_fieldset(torch, "gencast_0p25", sample, targets)
  if profile_dir:
    _profile_step(torch, lambda: step(7), profile_dir, "gencast_0p25_step")
  for name in ("splash_fwd", "fused_edge_embed", "fused_decoder_embed"):
    results.setdefault(name, {"name": name})[
        "gencast_0p25_launches_per_step"] = counts[name] // GENCAST_0P25_STEPS
  del model, stack, samples, inputs, targets, forcings
  torch.cuda.empty_cache()

  # The card against the CPU on the same weights, one preconditioned
  # denoiser evaluation, at a lower resolution.
  t3 = time.perf_counter()
  check, model, (inputs, noisy, level, forcings), outs, cpu_s = (
      _gencast_0p25_check_references(torch))
  out_card = _denoise(torch, model.to(DEVICE), inputs, noisy, level,
                      forcings, torch.bfloat16, DEVICE)
  worst = _check_noise_floor(
      torch, f"gencast_0p25 check sigma={float(level[0])}",
      {n: out_card.data(n) for n in noisy.var_names}, outs, noisy.var_names)
  check_s = time.perf_counter() - t3 + cpu_s
  _log("gencast_0p25", t0, config=_gencast_label(preset),
       steps=GENCAST_0P25_STEPS, setup_s=f"{setup_s:.1f}",
       warmup_evaluation_s=f"{warm_s:.2f}",
       s_per_12h_step=f"{steps_s / GENCAST_0P25_STEPS:.4f}",
       peak_mem_gb=f"{peak_gb:.2f}",
       **{f"{k}_per_step": counts[k] // GENCAST_0P25_STEPS
          for k in ("splash_fwd", "fused_edge_embed",
                    "fused_decoder_embed")},
       check=_gencast_label(check), check_s=f"{check_s:.1f}",
       check_worst_err_over_bound=f"{worst:.3f}", finite=True)
  del model
  _gencast_0p25_check_references.cache_clear()  # its model is on the card
  torch.cuda.empty_cache()


# ----- the memory forms (train_forms, ensemble_0p25_chunked) -----

# The JAX package's 0.25° training form (tools/bench_train_025.py:55-83).
TRAINING_FORM = dict(fused_aggregation="processor", remat_processor=True,
                     encode_chunks=50, decode_chunks=64)
OFFLOAD_FORM = dict(loss_carry_offload=True,
                    loss_offload_processor_carries=True)
# (name, GraphCast forms, Autoregressive forms, AR steps)
TRAIN_FORMS = (
    ("A", {}, {}, 2),
    ("A_remat", {"remat_processor": True}, {}, 2),
    ("B", TRAINING_FORM, {"loss_scan_unroll": 4}, 2),
    ("C", TRAINING_FORM, {"loss_scan_unroll": 4, **OFFLOAD_FORM}, 2),
    ("C_ar4", TRAINING_FORM, {"loss_scan_unroll": 4, **OFFLOAD_FORM}, 4),
)
FORMS_RTOL = 1e-2  # bf16 noise floor: B vs A loss and gradient rel RMS
# The 0.25° GenCast form of tools/bench_train_gencast.py:34-39.
ENSEMBLE_0P25_FORM = dict(encode_chunks=32, decode_chunks=32,
                          fused_aggregation=False)
ENSEMBLE_0P25_MEMBERS = 8
FORM_KERNELS = ("fused_edge", "fused_edge_encoder", "fused_decoder",
                "fused_edge_bwd", "fused_decoder_bwd", "weight_grad",
                "segment_sum", "segment_sum_sender")


def _launches():
  counts = {k: fn.launches for k, fn in _counters().items()}
  counts.update(_mode_counts())
  return counts


def _rel_rms(torch, got, want):
  """rms(got - want) / rms(want), 0 where both are all zero."""
  den = _rms(torch, want)
  num = _rms(torch, got.double() - want.double())
  return num / den if den else (0.0 if num == 0 else float("inf"))


def phase_train_forms(torch, results):
  """zoo.graphcast()'s AR training step in the memory forms (module doc):
  A (fused, no remat), A_remat, B (the JAX package's 0.25° training form),
  C (B with both host offloads) at AR-2 and AR-4, from one seed and one
  batch. Each form takes two steps: the first (learning rate 0) gives the
  loss and gradients compared, the second is timed (s/step, peak GB,
  launches) and gives the parameters compared."""
  from graphcast_tpu_torch import train
  from graphcast_tpu_torch.examples.graphcast_demo import (
      era5_inputs_targets_forcings)
  from graphcast_tpu_torch.params import flat_params
  from graphcast_tpu_torch.models import zoo
  t0 = time.perf_counter()
  preset = zoo.graphcast()
  mc = preset.model_config
  # An ERA5-shaped batch made from a seed on the card (data/era5.py).
  data = era5_inputs_targets_forcings(
      preset.task_config, mc.resolution, max(n for *_, n in TRAIN_FORMS), 6,
      seed=0, device=DEVICE)
  data = [fs.astype(torch.bfloat16) for fs in data]
  setup_s = time.perf_counter() - t0
  got = {}
  for name, model_kw, ar_kw, steps in TRAIN_FORMS:
    t1 = time.perf_counter()
    model, predictor = _stack(torch, preset, seed=0, device=DEVICE,
                              model_kw=model_kw, gradient_checkpointing=True,
                              **ar_kw)
    batch = (data[0], *(fs.isel(time=slice(0, steps)) for fs in data[1:]))
    step = train.make_train_step(predictor, train.graphcast_optimizer(
        model.parameters(), peak_lr=1e-3))
    before = {k: p.detach().to("cpu", copy=True)
              for k, p in flat_params(model).items()}
    loss = float(step(*batch)[0].mean())
    grads = {k: torch.zeros(p.shape) if p.grad is None
             else p.grad.detach().to("cpu", torch.float32, copy=True)
             for k, p in flat_params(model).items()}
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t2 = time.perf_counter()
    loss2 = float(step(*batch)[0].mean())
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t2
    counts = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    params = {k: p.detach().to("cpu", copy=True)
              for k, p in flat_params(model).items()}
    if not (np.isfinite(loss) and np.isfinite(loss2)):
      raise AssertionError(f"train_forms {name}: losses {loss}, {loss2}")
    if all(torch.equal(before[k], params[k]) for k in params):
      raise AssertionError(f"train_forms {name} changed no parameter")
    # Every form runs the fused processor; A's encoder and decoder are
    # fused too, B's and C's chunked (K3 sums and gathers).
    fused_ends = "fused_aggregation" not in model_kw
    ends = {"fused_edge_encoder", "fused_decoder", "fused_decoder_bwd"}
    must = {"fused_edge", "fused_edge_bwd", "weight_grad",
            "segment_sum_sender"} | (ends if fused_ends else {"segment_sum"})
    never = {"segment_sum"} if fused_ends else ends
    if (any(counts[k] == 0 for k in must)
        or any(counts[k] for k in never)):
      raise AssertionError(f"train_forms {name}: launches {counts}")
    got[name] = dict(loss=loss, grads=grads, params=params)
    for k in FORM_KERNELS:
      results.setdefault(k, {"name": k}).setdefault(
          "train_forms_launches_per_step", {})[name] = counts[k]
    _log("train_forms", t1, form=name, ar_steps=steps,
         model_forms=json.dumps(model_kw, sort_keys=True).replace(" ", ""),
         loss_forms=json.dumps(ar_kw, sort_keys=True).replace(" ", ""),
         first_step_s=f"{first_s:.2f}", s_per_step=f"{step_s:.4f}",
         peak_mem_gb=f"{peak_gb:.2f}", loss=f"{loss:.6g}",
         **{f"{k}_launches": counts[k] for k in FORM_KERNELS})
    del model, predictor, step, grads, params, before
    torch.cuda.empty_cache()

  def bit_equal(a, b):
    same = (got[a]["loss"] == got[b]["loss"]
            and all(torch.equal(got[a][part][k], got[b][part][k])
                    for part in ("grads", "params") for k in got[a][part]))
    if not same:
      raise AssertionError(f"train_forms: {a} is not bit-equal to {b}")

  bit_equal("A_remat", "A")
  bit_equal("C", "B")
  loss_rel = abs(got["B"]["loss"] - got["A"]["loss"]) / abs(got["A"]["loss"])
  grad_rel = {k: _rel_rms(torch, got["B"]["grads"][k], g)
              for k, g in got["A"]["grads"].items()}
  worst = max(grad_rel, key=grad_rel.get)
  if not (loss_rel <= FORMS_RTOL and grad_rel[worst] <= FORMS_RTOL):
    raise AssertionError(f"train_forms B vs A: loss rel {loss_rel:.3g}, "
                         f"worst gradient {worst} rel RMS "
                         f"{grad_rel[worst]:.3g} (tol {FORMS_RTOL})")
  _log("train_forms", t0, config=_label(preset), setup_s=f"{setup_s:.1f}",
       A_remat_vs_A="bit-equal (loss, gradients, parameters)",
       C_vs_B="bit-equal (loss, gradients, parameters)",
       B_vs_A_loss_rel=f"{loss_rel:.3g}",
       B_vs_A_worst_grad_rel_rms=f"{grad_rel[worst]:.3g}",
       B_vs_A_worst_grad=worst, tol=FORMS_RTOL)
  del got
  torch.cuda.empty_cache()


def phase_ensemble_0p25_chunked(torch, results):
  """zoo.gencast_0p25deg() in the chunked unfused form (module doc): (a) a
  2-member evaluation against the unchunked general path, rerun bit-equal;
  (b) an 8-member evaluation; (c) a training step; and the general path's
  grid2mesh sender gather in ns/row."""
  from graphcast_tpu_torch import train
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  from graphcast_tpu_torch.rollout import tile_batch
  t0 = time.perf_counter()
  preset = zoo.gencast_0p25deg()
  model, stack = _gencast_stack(torch, preset, seed=0, **ENSEMBLE_0P25_FORM)
  data = synthetic.make_example_batch(
      preset.task_config, resolution=preset.resolution, batch=1,
      num_target_times=1, time_step_hours=12, device=DEVICE)
  inputs, targets, forcings = (fs.astype(torch.bfloat16) for fs in data)
  del data
  sigma = preset.sampler_config.max_noise_level  # the first noise level
  gen = torch.Generator(device=DEVICE).manual_seed(31)

  def members(count):
    """(inputs, noisy targets, forcings) of ``count`` members, each with
    its own noise at σ."""
    tiled = [tile_batch(fs, count) for fs in (inputs, targets, forcings)]
    noisy = tiled[1].map_data(lambda x: x + sigma * torch.randn(
        x.shape, generator=gen, device=DEVICE, dtype=x.dtype))
    return tiled[0], noisy, tiled[2]

  def evaluate(m, batch):
    ins, noisy, frc = batch
    levels = torch.full((noisy.sizes["batch"],), sigma)
    return _denoise(torch, m, ins, noisy, levels, frc, torch.bfloat16,
                    DEVICE)

  two = members(2)
  setup_s = time.perf_counter() - t0
  t1 = time.perf_counter()
  out = evaluate(model, two)  # warm-up: graph, chunk plans, mask
  torch.cuda.synchronize()
  warm_s = time.perf_counter() - t1
  _reset_counters()
  again = evaluate(model, two)
  k3_per_eval = _launches()["segment_sum"]
  names = list(targets.var_names)
  if not all(torch.equal(out.data(n), again.data(n)) for n in names):
    raise AssertionError("ensemble_0p25_chunked: the chunked rerun is not "
                         "bit-equal")
  del again
  plain, _ = _gencast_stack(torch, preset, seed=0, fused_aggregation=False)
  torch.cuda.synchronize()
  t2 = time.perf_counter()
  want = evaluate(plain, two)
  torch.cuda.synchronize()
  unchunked_s = time.perf_counter() - t2
  rel = {n: _rel_rms(torch, out.data(n).float(), want.data(n).float())
         for n in names}
  worst = max(rel, key=rel.get)
  _check_fieldset(torch, "ensemble_0p25_chunked", out, two[1])
  if rel[worst] > FORMS_RTOL:
    raise AssertionError(f"ensemble_0p25_chunked: {worst} chunked vs "
                         f"unchunked rel RMS {rel[worst]:.3g} (tol "
                         f"{FORMS_RTOL})")
  # The general path's grid2mesh sender gather, [G, 2, 512] rows onto the
  # 0.25° grid2mesh edges (the gather the TPU's window_gather speeds up).
  st = plain.architecture._statics(out.data(names[0]).device)
  table = torch.randn((plain.architecture._artifact.num_grid_nodes, 2, 512),
                      generator=gen, device=DEVICE, dtype=torch.bfloat16)
  senders = st["g2m"].senders
  gather_ms = _time_ms(torch, lambda: table.index_select(0, senders), reps=10)
  gather_ns_per_row = gather_ms * 1e6 / senders.numel()
  del plain, want, out, two, table
  torch.cuda.empty_cache()

  # (b) 8 members.
  eight = members(ENSEMBLE_0P25_MEMBERS)
  torch.cuda.reset_peak_memory_stats()
  torch.cuda.synchronize()
  t3 = time.perf_counter()
  out8 = evaluate(model, eight)
  torch.cuda.synchronize()
  eval8_s = time.perf_counter() - t3
  peak8_gb = torch.cuda.max_memory_allocated() / 1e9
  _check_fieldset(torch, "ensemble_0p25_chunked", out8, eight[1])
  del out8, eight
  torch.cuda.empty_cache()

  # (c) a training step in the same form, batch 1.
  batch = _gencast_train_data(torch, preset, DEVICE, torch.bfloat16)
  step = train.make_train_step(
      stack, train.graphcast_optimizer(model.parameters(), peak_lr=1e-3))
  before = [p.detach().clone() for p in model.parameters()]
  tgen = torch.Generator(device=DEVICE).manual_seed(5)
  losses = [float(step(*batch, generator=tgen)[0].mean())]
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _reset_counters()
  t4 = time.perf_counter()
  losses.append(float(step(*batch, generator=tgen)[0].mean()))
  torch.cuda.synchronize()
  train_s = time.perf_counter() - t4
  train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
  counts = _launches()
  if not all(np.isfinite(losses)):
    raise AssertionError(f"ensemble_0p25_chunked train losses {losses}")
  if all(torch.equal(a, p) for a, p in zip(before, model.parameters())):
    raise AssertionError("ensemble_0p25_chunked: the train step changed no "
                         "parameter")
  layers = preset.denoiser_architecture_config.sparse_transformer_config
  if (counts["segment_sum"] == 0 or counts["fused_edge"]
      or counts["fused_decoder"] or counts["splash_dq"] != layers.num_layers):
    raise AssertionError(f"ensemble_0p25_chunked train launches {counts}")
  results.setdefault("segment_sum", {"name": "segment_sum"}).update(
      ensemble_0p25_chunked_launches_per_evaluation=k3_per_eval,
      ensemble_0p25_chunked_train_launches_per_step=counts["segment_sum"])
  for name in ("splash_fwd", "splash_dq", "splash_dkv"):
    results.setdefault(name, {"name": name})[
        "ensemble_0p25_chunked_train_launches_per_step"] = counts[name]
  _log("ensemble_0p25_chunked", t0, config=_gencast_label(preset),
       forms=json.dumps(ENSEMBLE_0P25_FORM, sort_keys=True).replace(" ", ""),
       setup_s=f"{setup_s:.1f}", warmup_evaluation_s=f"{warm_s:.2f}",
       sigma=sigma, rerun="bit-equal",
       chunked_vs_unchunked_worst_rel_rms=f"{rel[worst]:.3g}",
       worst_variable=worst, unchunked_2_member_s=f"{unchunked_s:.3f}",
       k3_per_evaluation=k3_per_eval, members=ENSEMBLE_0P25_MEMBERS,
       s_per_evaluation=f"{eval8_s:.4f}",
       s_per_member_evaluation=f"{eval8_s / ENSEMBLE_0P25_MEMBERS:.4f}",
       peak_mem_gb=f"{peak8_gb:.2f}", train_s_per_step=f"{train_s:.4f}",
       train_peak_mem_gb=f"{train_peak_gb:.2f}",
       train_losses="[" + ",".join(f"{v:.6g}" for v in losses) + "]",
       **{f"train_{k}_launches": counts[k]
          for k in ("segment_sum", "splash_fwd", "splash_dq", "splash_dkv",
                    "weight_grad")},
       general_g2m_sender_gather_ns_per_row=f"{gather_ns_per_row:.3f}",
       finite=True, params_changed=True)
  del model, stack, step, batch, before
  torch.cuda.empty_cache()


_ENSEMBLE_OUT = {}  # the ensemble phase's members and targets, for triblock


def _triblock_run(torch, block, cfg, x, cot, masks, n, pad, size):
  """(output, {name: gradient}) of triblockdiag_mha for the cotangent."""
  from graphcast_tpu_torch.models.sparse_transformer import triblockdiag_mha
  x = x.detach().requires_grad_(True)
  out = triblockdiag_mha(block, cfg, x, masks, n, pad, size)
  leaves = {"x": x, **{k: p for k, p in block.named_parameters()
                       if k.startswith("mha_")}}
  grads = torch.autograd.grad((out * cot).sum(), list(leaves.values()))
  return out.detach(), dict(zip(leaves, grads))


@functools.lru_cache(maxsize=None)
def _triblock_case(torch):
  """triblock's CPU side: the block (seeded weights), its config, inputs,
  cotangent and masks, and the CPU output and gradients with their
  seconds."""
  from graphcast_tpu_torch.models import sparse_transformer as st
  mask = _k_hop_block_map(5)[0]
  size = st.get_mask_block_size(mask)
  host_masks, pad = st.build_triblock_masks(mask, size)
  cfg = st.SparseTransformerConfig(attention_k_hop=16, d_model=512,
                                   num_layers=1, num_heads=4,
                                   attention_type="triblockdiag_mha")
  rng = np.random.RandomState(17)
  n = mask.shape[0]
  x = torch.from_numpy(rng.randn(1, n, 512).astype(np.float32))
  cot = torch.from_numpy(rng.randn(1, n, 512).astype(np.float32))
  transformer = st.Transformer(cfg, cond_size=16)
  block = transformer.block_00
  with torch.no_grad():
    for name, p in block.named_parameters():
      p.copy_(torch.from_numpy(
          (rng.randn(*p.shape) / np.sqrt(p.shape[0])).astype(np.float32)))
  t1 = time.perf_counter()
  want, want_grads = _triblock_run(torch, block, cfg, x, cot,
                                   torch.from_numpy(host_masks), n, pad,
                                   size)
  return dict(block=block, cfg=cfg, x=x, cot=cot, host_masks=host_masks,
              n=n, pad=pad, size=size, want=want, want_grads=want_grads,
              cpu_s=time.perf_counter() - t1)


def phase_triblock(torch, results):
  """triblockdiag_mha at the GenCast 1.0° shape, card against CPU, and the
  ensemble's CRPS card against CPU (module doc)."""
  from graphcast_tpu_torch import evaluation
  t0 = time.perf_counter()
  case = _triblock_case(torch)
  block, cfg, x, cot, host_masks, n, pad, size = (case[k] for k in (
      "block", "cfg", "x", "cot", "host_masks", "n", "pad", "size"))
  want, want_grads, cpu_s = (case[k] for k in ("want", "want_grads",
                                                "cpu_s"))
  block.to(DEVICE)
  args = (cfg, x.to(DEVICE), cot.to(DEVICE),
          torch.from_numpy(host_masks).to(DEVICE), n, pad, size)
  torch.cuda.reset_peak_memory_stats()
  _triblock_run(torch, block, *args)  # warm-up
  torch.cuda.synchronize()
  t2 = time.perf_counter()
  got, got_grads = _triblock_run(torch, block, *args)
  torch.cuda.synchronize()
  card_ms = (time.perf_counter() - t2) * 1e3
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  worst = 0.0
  for name, g, w in [("out", got, want)] + [
      (k, got_grads[k], want_grads[k]) for k in want_grads]:
    err = float((g.cpu() - w).abs().max() / w.abs().max())
    if not err <= TRIBLOCK_ATOL:
      raise AssertionError(f"triblock {name}: card vs CPU max-abs {err:.3g}"
                           f" of the max (tol {TRIBLOCK_ATOL})")
    worst = max(worst, err)
  del case, block, args, got, got_grads
  _triblock_case.cache_clear()  # its block is on the card
  torch.cuda.empty_cache()

  # The ensemble's members scored on the card and on the CPU.
  if "preds" not in _ENSEMBLE_OUT:
    phase_ensemble(torch, {k: {"name": k} for k in ("segment_sum",
                                                     "splash_fwd")})
  preds, targets = _ENSEMBLE_OUT["preds"], _ENSEMBLE_OUT["targets"]
  targets = targets.isel(time=slice(0, preds.sizes["time"]))
  crps_card = evaluation.crps_ensemble(preds, targets)
  crps_cpu = evaluation.crps_ensemble(preds.to("cpu"), targets.to("cpu"))
  crps_worst = 0.0
  for name, c in crps_cpu.items():
    err = float(((crps_card[name].cpu() - c).abs()
                 / c.abs().clamp(min=1e-12)).max())
    if not (torch.isfinite(c).all() and err <= CRPS_RTOL):
      raise AssertionError(f"triblock crps {name}: card vs CPU relative "
                           f"{err:.3g} (tol {CRPS_RTOL})")
    crps_worst = max(crps_worst, err)
  _log("triblock", t0, shape=f"1x{n}x512/4heads", block=size,
       blocks=host_masks.shape[1], cpu_fwd_bwd_s=f"{cpu_s:.1f}",
       card_fwd_bwd_ms=f"{card_ms:.2f}", card_peak_gb=f"{peak_gb:.2f}",
       worst_err_of_max=f"{worst:.3g}", crps_members=preds.sizes["batch"],
       crps_t2m=f"{float(crps_card['2m_temperature'].mean()):.4f}",
       crps_worst_rel=f"{crps_worst:.3g}")


def _k1p_entry(mode):
  name = {"processor": "fused_edge_pipelined",
          "encoder": "fused_edge_pipelined_encoder",
          "embed": "fused_edge_pipelined_embed"}[mode]
  return _entry(name, "fused_edge_pipelined.cu",
                "graphcast_tpu/ops/pallas_edge.py:201", mode=mode,
                launches=None)


def phase_k1p(torch, art025, results):
  """K1p against its plain version and K1 on the real edge sets (module
  doc), then K4 behind a K1p forward against K4 behind K1."""
  from graphcast_tpu_torch.ops.fused_edge import (
      EdgeIndex, fused_edge, fused_edge_reference, pipelined_smem_layout)
  t0 = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(22)
  C, bf16 = 512, torch.bfloat16
  g, m = art025.num_grid_nodes, art025.num_mesh_nodes
  art1 = _gencast_artifact(1.0, 5)
  _print_usage("k1p", "fused_edge_pipelined_kernel",
               pipelined_smem_layout()["total"])
  # (mode, key suffix, edge list)
  cases = [
      ("processor", "", EdgeIndex(art025.mesh.senders, art025.mesh.receivers,
                                  m, m, DEVICE)),
      ("encoder", "", EdgeIndex(art025.grid2mesh.senders,
                                art025.grid2mesh.receivers, g, m, DEVICE)),
      ("embed", "", EdgeIndex(art1.grid2mesh.senders, art1.grid2mesh.receivers,
                              art1.num_grid_nodes, art1.num_mesh_nodes,
                              DEVICE)),
      ("embed", "_0p25", EdgeIndex(art025.grid2mesh.senders,
                                   art025.grid2mesh.receivers, g, m, DEVICE)),
  ]
  entries = {}
  for mode, suffix, edges in cases:
    entry = entries.setdefault(mode, _k1p_entry(mode))
    args = _edge_case(torch, gen, edges, C, encoder=mode == "encoder")
    args["write_edges"] = mode == "processor"
    shared = None
    if mode == "embed":
      feats = (art1 if suffix == "" else art025).grid2mesh.features
      args["e"] = torch.as_tensor(feats, device=DEVICE)
      args["we"] = args["we"].to(bf16)
      args["embed_weights"] = _embed_weights(torch, gen, C)
      shared = _shared_feature_rows(torch, edges, args["e"])
    run = {"k1p": lambda: fused_edge(edges, pipelined=True, **args),
           "k1": lambda: fused_edge(edges, pipelined=False, **args),
           "plain": lambda: fused_edge_reference(edges, **args)}
    with torch.inference_mode():
      got, k1, want = run["k1p"](), run["k1"](), run["plain"]()
      torch.cuda.synchronize()
      outs = ([("e_out", got[0], k1[0], want[0]), ("agg", got[1], k1[1],
                                                    want[1])]
              if mode == "processor" else [("agg", got, k1, want)])
      max_abs = 0.0
      for name, a, b, w in outs:
        # K1p equals K1 bit for bit (module doc).
        if not torch.equal(a, b):
          raise AssertionError(
              f"k1p {mode}{suffix} {name}: differs from K1 by "
              f"{(a.float() - b.float()).abs().max().item():.3g}")
        err, rel_rms = _check_close(f"k1p {mode}{suffix} {name}", a, w,
                                    shared=shared if name == "agg" else None)
        max_abs = max(max_abs, err)
      del got, k1, want, outs
      # In turns with K1 and its products as bf16 cuBLAS GEMMs (K1p, K1,
      # GEMMs, GEMMs, K1, K1p), 10 launches each.
      run["gemm"] = _gemm_yardstick(torch, gen, edges.num_edges,
                                    _edge_products(mode, backward=False))
      turns = [_time_ms(torch, run[k], reps=10)
               for k in ("k1p", "k1", "gemm", "gemm", "k1", "k1p")]
      ms, k1_ms, gemm_ms = ((turns[0] + turns[5]) / 2,
                            (turns[1] + turns[4]) / 2,
                            (turns[2] + turns[3]) / 2)
      plain_ms = _time_ms(torch, run["plain"], reps=1)
    entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0), max_abs)
    entry.update({"ms" + suffix: ms, "k1_ms" + suffix: k1_ms,
                  "gemm_ms" + suffix: gemm_ms, "plain_ms" + suffix: plain_ms,
                  "bit_equal_to_k1" + suffix: True,
                  **{k + suffix: v for k, v in _bound(*_edge_cost(
                      edges.num_edges, edges.num_senders,
                      edges.num_receivers, C, mode)).items()}})
    _log("k1p", t0, mode=mode + suffix, edges=edges.num_edges,
         max_abs=f"{max_abs:.4g}", bit_equal_to_k1=True, ms=f"{ms:.3f}",
         k1_ms=f"{k1_ms:.3f}", gemm_ms=f"{gemm_ms:.3f}",
         plain_ms=f"{plain_ms:.3f}",
         bound_ms=f"{entry['bound_ms' + suffix]:.4f}",
         turns_ms="/".join(f"{t:.3f}" for t in turns))
    del args, run
    torch.cuda.empty_cache()

  # K4 behind each forward, processor mode on the mesh-6 set, the same
  # seeded cotangents: under grad the forward is K1p or K1, the backward K4,
  # which keeps only the inputs and sums in a fixed order, so every
  # gradient is the same bit for bit.
  edges = cases[0][2]
  args = _edge_case(torch, gen, edges, C, encoder=False)
  args["we"] = args["we"].to(bf16)
  cot = (_randn(torch, gen, (edges.num_edges, C), 1.0, bf16),
         _randn(torch, gen, (edges.num_receivers, C)))
  grads = {}
  for run_name, pipelined in (("k1", False), ("k1p", True)):
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in args.items()}
    grads[run_name], _ = _autograd(
        torch, lambda **kw: fused_edge(edges, write_edges=True,
                                       pipelined=pipelined, **kw),
        leaves, cot, list(leaves))
  torch.cuda.synchronize()
  for name, want in grads["k1"].items():
    if not torch.equal(grads["k1p"][name], want):
      raise AssertionError(
          f"k1p: grad {name} behind K1p differs from behind K1 by "
          f"{(grads['k1p'][name] - want).abs().max().item():.3g}")
  _log("k1p", t0, k4_behind_k1p="processor", grads_bit_equal_to_k1=True)
  del args, cot, grads
  torch.cuda.empty_cache()
  for entry in entries.values():
    results[entry["name"]] = {**results.get(entry["name"], {}), **entry}


def phase_bench(torch, card, results):
  """The benchmark mirror (module doc)."""
  import contextlib
  import io
  import os
  from graphcast_tpu_torch import bench
  from graphcast_tpu_torch.models import zoo
  t0 = time.perf_counter()
  knobs = {"BENCH_FALLBACK_ONLY": "1", "BENCH_NUM_STEPS": str(BENCH_STEPS),
           "GC_PIPELINED_EDGE": "1"}
  cleared = ("BENCH_GENCAST", "BENCH_SKIP_GENCAST", "BENCH_FUSED",
             "BENCH_GENCAST_RESOLUTION", "BENCH_GENCAST_MESH_SIZE")
  saved = {k: os.environ.get(k) for k in (*knobs, *cleared)}
  out, err = io.StringIO(), io.StringIO()
  os.environ.update(knobs)
  for k in cleared:
    os.environ.pop(k, None)
  _reset_counters()
  try:
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
      result = bench.main(DEVICE)
  finally:
    for k, v in saved.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v
  counts = {**{k: fn.launches for k, fn in _counters().items()},
            **_mode_counts()}
  for ln in (out.getvalue() + err.getvalue()).splitlines():
    print(f"[bench] {ln}", flush=True)
  lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
  gencast = [json.loads(ln.split("# gencast: ", 1)[1].split(" compile=")[0])
             for ln in err.getvalue().splitlines()
             if ln.startswith("# gencast: ")]
  name, limit = (part.strip() for part in card.split(","))
  want = {"fallback": f"graphcast_1.0deg_13lev_mesh5_{BENCH_STEPS}step_rollout",
          "gencast": "gencast_1.0deg_mesh5_splash_12h_step_40evals"}
  keys = {"metric", "value", "unit", "card", "power_limit"}
  for line, metric in ((lines[0] if lines else {}, want["fallback"]),
                       (gencast[0] if gencast else {}, want["gencast"])):
    if (set(line) != keys or line["metric"] != metric or line["unit"] != "s"
        or not line["value"] > 0 or line["card"] != name
        or line["power_limit"] != limit):
      raise AssertionError(f"bench line {line}, expected keys {keys}, metric "
                           f"{metric} on {card!r}")
  if len(lines) != 1 or lines[0] != result or len(gencast) != 1:
    raise AssertionError(f"bench printed {lines} and {gencast}")
  # The mirror times a warm-up and bench.NUM_RUNS calls of each path: the
  # GenCast step (39 evaluations), the 1.0° rollout (BENCH_STEPS steps of
  # 16 processor steps and one encoder step).
  calls = 1 + bench.NUM_RUNS
  evals = 2 * zoo.gencast_custom(1.0, 5).sampler_config.num_noise_levels - 1
  expected = {"fused_edge": 0, "fused_edge_pipelined_embed": calls * evals,
              "fused_edge_pipelined_encoder": calls * BENCH_STEPS,
              "fused_edge_pipelined_all": calls * (evals + 17 * BENCH_STEPS)}
  if any(counts[k] != n for k, n in expected.items()):
    raise AssertionError(f"bench launches {counts}, expected {expected}")
  results["fused_edge_pipelined_embed"].update(
      launches=counts["fused_edge_pipelined_embed"],
      launches_per_step=evals)
  for key in ("fused_edge_pipelined", "fused_edge_pipelined_encoder"):
    results[key]["bench_launches"] = (
        counts["fused_edge_pipelined_encoder"] if key.endswith("encoder")
        else counts["fused_edge_pipelined_all"]
        - counts["fused_edge_pipelined_encoder"]
        - counts["fused_edge_pipelined_embed"])
  _log("bench", t0, fallback=f"{lines[0]['value']:.4f}",
       gencast_12h_step=f"{gencast[0]['value']:.4f}",
       k1p_embed_per_12h_step=counts["fused_edge_pipelined_embed"] // calls,
       k1p_per_6h_step=(counts["fused_edge_pipelined_all"]
                        - counts["fused_edge_pipelined_embed"])
       // (calls * BENCH_STEPS),
       k1_launches=counts["fused_edge"], lines_ok=True)

CURVE_STEPS = 30          # GraphCast steps of the train_curve phase
CURVE_GENCAST_STEPS = 10  # its GenCast 1.0° steps
CURVE_WINDOW = 5          # steps in its first and last loss windows
ROLLOUT_MEMBERS = 2       # the gencast_rollout phase's members
GENCAST_ROLLOUT_STEPS = 3  # and its 12 h steps
MEMDUMP_RTOL = 0.1        # memdump: listed blocks vs the measured peak
CURVE_KERNELS = {
    "graphcast": ("fused_edge", "fused_edge_bwd", "weight_grad",
                  "segment_sum", "segment_sum_sender"),
    "gencast": ("splash_fwd", "splash_dq", "splash_dkv", "segment_sum")}


def _path_launches(phase, results, counts, kernels, key=None):
  """Records the launches of ``kernels`` on a path (``counts`` read just
  after it, every count set to 0 just before) as ``<key>_launches``; fails
  if any of them launched no time."""
  missing = [k for k in kernels if not counts[k]]
  if missing:
    raise AssertionError(f"{phase}: {missing} never launched ({counts})")
  for k in kernels:
    results.setdefault(k, {"name": k})[f"{key or phase}_launches"] = (
        counts[k])


def phase_train_curve(torch, results):
  """The training curve (graphcast_tpu_torch/tools/train_curve.py) at full
  width, cut in steps (module doc)."""
  from graphcast_tpu_torch.models import configs, zoo
  from graphcast_tpu_torch.tools import train_curve
  t0 = time.perf_counter()
  log = lambda line: print(f"[train_curve] {line}", flush=True)  # noqa: E731
  mc = configs.ModelConfig(resolution=1.0, mesh_size=5, latent_size=512,
                           gnn_msg_steps=16, hidden_layers=1,
                           radius_query_fraction_edge_length=0.6)
  curve = train_curve.graphcast_curve(mc, configs.TASK_13, 1.0, DEVICE)
  _reset_counters()
  run = train_curve.run_curve(curve, CURVE_STEPS, log=log)
  _path_launches("train_curve", results, _launches(),
                 CURVE_KERNELS["graphcast"], "train_curve_graphcast")
  losses = run["losses"]
  first = float(np.mean(losses[:CURVE_WINDOW]))
  last = float(np.mean(losses[-CURVE_WINDOW:]))
  if not last < first:
    raise AssertionError(f"train_curve: GraphCast's last {CURVE_WINDOW} "
                         f"losses average {last:.5f}, not below the first "
                         f"{CURVE_WINDOW}'s {first:.5f}: {losses}")
  del curve
  torch.cuda.empty_cache()
  curve = train_curve.gencast_curve(zoo.gencast_1p0deg(), DEVICE)
  _reset_counters()
  grun = train_curve.run_curve(curve, CURVE_GENCAST_STEPS, log=log)
  _path_launches("train_curve", results, _launches(),
                 CURVE_KERNELS["gencast"], "train_curve_gencast")
  _log("train_curve", t0, graphcast=f"1.0deg/13lev/mesh5/latent512/16mp",
       steps=CURVE_STEPS, first_window=f"{first:.5f}",
       last_window=f"{last:.5f}", drop_pct=f"{(1 - last / first) * 100:.2f}",
       first_step_s=f"{run['compile_s']:.2f}",
       s_per_step=f"{run['s_per_step']:.4f}",
       gencast=_gencast_label(zoo.gencast_1p0deg()),
       gencast_steps=CURVE_GENCAST_STEPS,
       gencast_losses="[" + ",".join(f"{v:.5g}" for v in grun["losses"])
       + "]", gencast_s_per_step=f"{grun['s_per_step']:.4f}", finite=True)
  del curve
  torch.cuda.empty_cache()


def phase_gencast_rollout(torch, results):
  """The ensemble rollout driver (graphcast_tpu_torch/tools/
  bench_gencast_rollout.py) at 1.0°, cut in members and steps (module
  doc)."""
  from graphcast_tpu_torch.rollout import tile_batch
  from graphcast_tpu_torch.tools import bench_gencast_rollout as tool
  t0 = time.perf_counter()
  predictor, inputs, targets, forcings = tool.build(
      1.0, 5, GENCAST_ROLLOUT_STEPS, DEVICE)
  tool.rollout(predictor, inputs, targets.isel(time=slice(0, 1)),
               forcings.isel(time=slice(0, 1)), ROLLOUT_MEMBERS, 0)
  _reset_counters()
  seconds, preds = _timed_s(torch, lambda: tool.rollout(
      predictor, inputs, targets, forcings, ROLLOUT_MEMBERS, 1))
  _path_launches("gencast_rollout", results, _launches(),
                 ("segment_sum", "splash_fwd"))
  again = tool.rollout(predictor, inputs, targets, forcings, ROLLOUT_MEMBERS,
                       1)
  _check_fieldset(torch, "gencast_rollout", preds,
                  tile_batch(targets, ROLLOUT_MEMBERS))
  differ = [n for n in preds.var_names
            if not torch.equal(preds.data(n), again.data(n))]
  if differ:
    raise AssertionError(f"gencast_rollout: the rerun differs in {differ}")
  t = preds.data("temperature")
  if torch.equal(t[0], t[1]):
    raise AssertionError("gencast_rollout: the members are equal")
  _log("gencast_rollout", t0, members=ROLLOUT_MEMBERS,
       steps=GENCAST_ROLLOUT_STEPS,
       rollout_s=f"{seconds:.3f}",
       s_per_member_step=(
           f"{seconds / ROLLOUT_MEMBERS / GENCAST_ROLLOUT_STEPS:.4f}"),
       final_mean_t=f"{tool.final_mean(preds):.6g}", rerun="bit-equal",
       members_differ=True, finite=True)
  del predictor, preds, again
  torch.cuda.empty_cache()


def phase_bench_train(torch, results):
  """The train-step drivers (graphcast_tpu_torch/tools/bench_train_025.py
  at 1.0° AR-2, bench_train_gencast.py at 1.0°), one timed step each
  after a first (module doc)."""
  from graphcast_tpu_torch.tools import bench_train_025, bench_train_gencast
  t0 = time.perf_counter()
  _reset_counters()
  gc = bench_train_025.run(2, torch.device(DEVICE),
                           bench_train_025.training_config(resolution=1.0),
                           timed_steps=1)
  _path_launches("bench_train", results, _launches(),
                 CURVE_KERNELS["graphcast"], "bench_train_025")
  torch.cuda.empty_cache()
  _reset_counters()
  gen = bench_train_gencast.run(1.0, 5, torch.device(DEVICE), timed_steps=1)
  _path_launches("bench_train", results, _launches(),
                 CURVE_KERNELS["gencast"], "bench_train_gencast")
  for rec in (gc, gen):
    print(f"[bench_train] {json.dumps(rec)}", flush=True)
  _log("bench_train", t0, graphcast_ar2_s=gc["value"],
       graphcast_peak_gb=f"{gc['peak_gb']:.2f}", gencast_s=gen["value"],
       gencast_peak_gb=f"{gen['peak_gb']:.2f}")
  torch.cuda.empty_cache()


def phase_memdump(torch, results):
  """The memory breakdown driver (graphcast_tpu_torch/tools/
  memdump_train_025.py) at 1.0° AR-2 (module doc)."""
  from graphcast_tpu_torch.tools import memdump_train_025
  t0 = time.perf_counter()
  _reset_counters()
  rec = memdump_train_025.run(2, 1.0, 5, torch.device(DEVICE), top=8)
  _path_launches("memdump", results, _launches(), CURVE_KERNELS["graphcast"])
  ratio = rec["listed_over_measured"]
  if abs(ratio - 1) > MEMDUMP_RTOL:
    raise AssertionError(f"memdump: the listed blocks make {ratio:.4f} of "
                         f"the measured peak")
  _log("memdump", t0, config="1.0deg/37lev/mesh5/latent512/16mp/AR2",
       form=rec["fused"], peak_gb=f"{rec['peak_gb']:.3f}",
       measured_peak_gb=f"{rec['measured_peak_gb']:.3f}",
       listed_over_measured=f"{ratio:.4f}", sites=len(rec["sites"]),
       trace_events=rec["trace_events"],
       top_site=rec["sites"][0]["site"].replace(" ", "/"))
  torch.cuda.empty_cache()


# ----- the native geometry and hidden_layers > 1 (GraphCast and GenCast) --

GEOMETRY_CASES = ((1.0, 5), (0.25, 6))  # the geometry phase's grid, mesh
HL_DEPTH = 2                # the hidden_layers phases' MLP hidden layers
HL_TRAIN_STEPS = 2          # timed form-B train steps of hidden_layers
HL_GENCAST_STEPS = 1        # timed 12 h steps of gencast_hidden_layers
HL_SMALL_DEPTHS = (2, 3)    # hidden_layers_small's GraphCast depths
HL_SMALL_SEED = 21
HL_SMALL_MODEL = dict(resolution=5.0, mesh_size=3, latent_size=128,
                      gnn_msg_steps=4)
HL_SMALL_TASK = dict(
    input_variables=("2m_temperature", "temperature",
                     "toa_incident_solar_radiation", "land_sea_mask"),
    target_variables=("2m_temperature", "temperature"),
    forcing_variables=("toa_incident_solar_radiation",),
    pressure_levels=(500, 850), input_duration="12h")
HL_MINI_LAYERS = 1          # GenCast Mini's transformer depth there
HL_MINI_SIGMA = 1.0
# The DeepGraphNet options of hidden_layers_small (graphcast_tpu nn/
# deep_gnn.py:28-71), each beside the defaults of HL_GNN_BASE; then every
# activation name of nn/core.py ACTIVATIONS.
HL_GNN_NODES = {"a": 600, "b": 900}
HL_GNN_EDGE_SETS = {"ab": ("a", "b"), "ba": ("b", "a"), "bb": ("b", "b")}
HL_GNN_BASE = dict(mlp_hidden_size=64, mlp_num_hidden_layers=1,
                   num_message_passing_steps=2, node_output_size={"b": 3})
HL_GNN_OPTIONS = {
    "num_processor_repetitions": dict(num_processor_repetitions=2),
    "embed_edges_false": dict(embed_edges=False),
    "embed_nodes_false": dict(embed_nodes=False),
    "edge_output_size": dict(edge_output_size={"ab": 3, "bb": 5}),
    "include_sent_messages": dict(include_sent_messages_in_node_update=True),
    "use_layer_norm_false": dict(use_layer_norm=False),
    "factored_edge_updates_false": dict(factored_edge_updates=False),
    "norm_conditioning": dict(norm_conditioning_size=4),
    "mlp_num_hidden_layers_2": dict(mlp_num_hidden_layers=2),
    "mlp_num_hidden_layers_3": dict(mlp_num_hidden_layers=3),
    "remat_steps": dict(remat_steps=True, num_message_passing_steps=4),
}
HL_GNN_C = 64


def phase_geometry(torch):
  """Both connectivity backends at GEOMETRY_CASES (module doc), each
  artifact built afresh."""
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.geometry import artifact as artifact_lib
  from graphcast_tpu_torch.geometry import connectivity
  from graphcast_tpu_torch.native import geometry as native
  t0 = time.perf_counter()
  native.load_library()  # "native" is asked for: a failed build fails here
  library_s = time.perf_counter() - t0
  auto = connectivity.resolve_backend("auto")
  if auto != "native":
    raise AssertionError(f"geometry: 'auto' resolved to {auto!r}")
  for resolution, mesh_size in GEOMETRY_CASES:
    lat, lon = synthetic.grid_coords(resolution)
    t1 = time.perf_counter()
    by_numpy = artifact_lib.build_artifact(lat, lon, mesh_size, cache_dir="",
                                           backend="numpy")
    numpy_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    by_native = artifact_lib.build_artifact(lat, lon, mesh_size, cache_dir="",
                                            backend="native")
    native_s = time.perf_counter() - t1
    for name in ("grid2mesh", "mesh"):
      for field in ("senders", "receivers", "features"):
        a = getattr(getattr(by_numpy, name), field)
        b = getattr(getattr(by_native, name), field)
        if not np.array_equal(a, b):
          raise AssertionError(f"geometry {resolution}deg: {name}.{field} "
                               "differs between the backends")
    m2g_np, m2g_nat = by_numpy.mesh2grid, by_native.mesh2grid
    if not np.array_equal(m2g_np.receivers, m2g_nat.receivers):
      raise AssertionError("geometry: mesh2grid receivers differ")
    differ = m2g_np.senders != m2g_nat.senders
    _log("geometry", t0, grid=f"{resolution}deg", mesh=mesh_size,
         grid_nodes=by_native.num_grid_nodes,
         mesh_nodes=by_native.num_mesh_nodes,
         g2m_edges=by_native.grid2mesh.senders.size,
         mesh_edges=by_native.mesh.senders.size,
         m2g_edges=m2g_nat.senders.size, numpy_build_s=f"{numpy_s:.2f}",
         native_build_s=f"{native_s:.2f}",
         g2m_and_mesh_edges="bit-equal",
         m2g_rows_differ=int(differ.sum()),
         m2g_grid_nodes_differ=int(differ.reshape(-1, 3).any(1).sum()))
    del by_numpy, by_native
  _log("geometry", t0, library_build_s=f"{library_s:.2f}",
       auto_backend=auto, library=str(native.SOURCE.name))


def _host_prelude(torch, phases):
  """Host work that needs no card, run beside the kernels' build (whose
  last ptxas runs for minutes on one core) in two threads, each part
  timed: one for the geometry phase and the artifacts, attention masks and
  block maps that later phases take from the per-process caches (and the
  CPU sides that read them), one for the small phases' CPU references
  (each builds its own graphs). Returns a function that waits for both,
  prints when each part ended, and raises what they raised."""
  import threading
  selected = set(phases)
  geometry, references = [], []
  if "geometry" in selected:
    geometry.append(("geometry", lambda: phase_geometry(torch)))
  if selected & {"k1", "k2", "k4", "k5", "embed", "embed_bwd", "k3", "main",
                 "k1p", "train", "train_forms", "forecast", "hidden_layers"}:
    geometry.append(("graphcast_0p25", lambda: _geometry(0.25, 6)))
  if selected & {"gencast", "gencast_train", "ensemble", "parallel",
                  "triblock", "bench", "train_curve", "gencast_rollout",
                  "bench_train", "gencast_hidden_layers"}:
    geometry.append(("gencast_1p0", lambda: _gencast_geometry(1.0, 5)))
  if selected & {"gencast_0p25", "ensemble_0p25_chunked"}:
    geometry.append(("gencast_0p25", lambda: _gencast_geometry(0.25, 6)))
  if "gencast_0p25" in selected:
    geometry.append(("gencast_0p25_check",
                     lambda: _gencast_0p25_check_references(torch)))
  for mesh_size in (5, 6):
    if selected & {"k6", "k7k8", "sp_attention", "triblock", "shared_card"}:
      geometry.append((f"block_map_{mesh_size}",
                       functools.partial(_k_hop_block_map, mesh_size)))
  if "triblock" in selected:
    geometry.append(("triblock", lambda: _triblock_case(torch)))
  if "hidden_layers_small" in selected:
    references.append(("hidden_layers_small",
                       lambda: _hl_small_references(torch)))
  if selected & {"small", "graphcast_batch"}:
    references.append(("small", lambda: _small_references(torch)))
  if "train_small" in selected:
    references.append(("train_small",
                       lambda: _train_small_references(torch)))
  if selected & {"gencast_small", "ensemble_small"}:
    references.append(("gencast_small", lambda: _mini_references(torch)))
  if "gencast_train_small" in selected:
    references.append(("gencast_train_small",
                       lambda: _gencast_train_small_references(torch)))
  errors, ended = [], {}
  t0 = time.perf_counter()

  def run(work):
    torch.set_num_threads(num_threads)
    try:
      for name, fn in work:
        fn()
        ended[name] = time.perf_counter() - t0
    except BaseException as e:  # noqa: BLE001  (re-raised by wait)
      errors.append(e)

  threads = torch.get_num_threads()
  num_threads = max(1, min(threads, (os.cpu_count() or 2) - 1))
  torch.set_num_threads(num_threads)  # a core stays with the compiler
  workers = [threading.Thread(target=run, args=(work,),
                              name=f"prelude_{name}", daemon=True)
             for name, work in (("geometry", geometry),
                                ("references", references))]
  for w in workers:
    w.start()

  def wait():
    for w in workers:
      w.join()
    torch.set_num_threads(threads)
    _log("prelude", t0, beside_build=True,
         parts=len(geometry) + len(references),
         ended_s=",".join(f"{k}:{v:.1f}" for k, v in ended.items()))
    if errors:
      raise errors[0]

  return wait


def _gencast_geometry(resolution, mesh_size):
  """GenCast's banded artifact and its k-hop-16 splash mask, built into the
  per-process caches its models read (geometry/artifact.py
  cached_artifact, sparse_transformer.prepared_mask)."""
  from graphcast_tpu_torch.models import sparse_transformer, transformer
  art = _gencast_artifact(resolution, mesh_size)
  sparse_transformer.prepared_mask(transformer.adjacency_from_edges(
      art.mesh.senders, art.mesh.receivers, art.num_mesh_nodes), 16,
                                   "splash_mha")


def _with_hidden_layers(preset, hidden_layers):
  """A GraphCast preset with its MLPs at ``hidden_layers``."""
  return dataclasses.replace(preset, model_config=dataclasses.replace(
      preset.model_config, hidden_layers=hidden_layers))


class _GatherCount:
  """Counts the ops.gather.RowGather calls (the general and chunked paths'
  row gathers; their backward sums are K3 launches) while active."""

  def __enter__(self):
    from graphcast_tpu_torch.ops import gather
    self.cls, self.call, self.n = gather.RowGather, gather.RowGather.__call__, 0

    def counted(g, table):
      self.n += 1
      return self.call(g, table)

    self.cls.__call__ = counted
    return self

  def __exit__(self, *exc):
    self.cls.__call__ = self.call


_FUSED_KERNELS = ("fused_edge", "fused_decoder", "fused_edge_bwd",
                  "fused_decoder_bwd", "weight_grad", "segment_sum_sender")


def phase_hidden_layers(torch, results):
  """zoo.graphcast() at hidden_layers=HL_DEPTH against 1 (module doc)."""
  from graphcast_tpu_torch.models import zoo
  from graphcast_tpu_torch.tools import bench_train_025
  t0 = time.perf_counter()
  preset = zoo.graphcast()
  mp = preset.model_config.gnn_msg_steps
  inputs, targets1, forcings_n = _main_data(torch)
  predictors, warm = {}, {}

  def alone(hl):
    """(peak GB, final state) of a rollout by the one predictor alive."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, final = _timed_s(torch, lambda: predictors[hl].rollout_final(
        inputs, targets1, forcings_n))
    return torch.cuda.max_memory_allocated() / 1e9, final

  peak = {}
  for hl in (HL_DEPTH, 1):
    predictors[hl] = _stack(torch, _with_hidden_layers(preset, hl),
                            seed=0)[1].to(DEVICE)
    warm[hl] = _timed_s(torch, lambda: predictors[hl].rollout_final(
        inputs, targets1, forcings_n.isel(time=slice(0, 1))))[0]
    if hl == HL_DEPTH:
      peak[hl], first = alone(hl)
  _check_fieldset(torch, "hidden_layers", first, inputs.select(
      first.var_names))
  runs = {HL_DEPTH: [], 1: []}
  for hl in (HL_DEPTH, 1, 1, HL_DEPTH):  # in turns, both alive
    _reset_counters()
    with _GatherCount() as gathers:
      seconds, final = _timed_s(torch, lambda: predictors[hl].rollout_final(
          inputs, targets1, forcings_n))
    runs[hl].append(dict(s=seconds / ROLLOUT_STEPS, counts=_launches(),
                         gathers=gathers.n))
    differ = [n for n in first.var_names if hl == HL_DEPTH
              and not torch.equal(first.data(n), final.data(n))]
    if differ:
      raise AssertionError(f"hidden_layers: a rerun of the rollout differs "
                           f"in {differ}")
    del final
  del predictors[HL_DEPTH], first
  peak[1] = alone(1)[0]
  deep, one = runs[HL_DEPTH], runs[1]
  k3 = deep[0]["counts"]["segment_sum"]
  if (k3 != (2 + mp) * ROLLOUT_STEPS
      or any(deep[0]["counts"][k] for k in _FUSED_KERNELS)
      or not one[0]["counts"]["fused_edge"]
      or one[0]["counts"]["segment_sum"]):
    raise AssertionError(f"hidden_layers rollout launches: hidden_layers="
                         f"{HL_DEPTH} {deep[0]['counts']}, 1 "
                         f"{one[0]['counts']}")
  _path_launches("hidden_layers", results, deep[0]["counts"],
                 ("segment_sum",), "hidden_layers_rollout")
  _log("hidden_layers", t0, config=_label(_with_hidden_layers(
      preset, HL_DEPTH)), hidden_layers=HL_DEPTH, steps=ROLLOUT_STEPS,
       warmup_1step_s=f"{warm[HL_DEPTH]:.2f}",
       s_per_step="[" + ",".join(f"{r['s']:.4f}" for r in deep) + "]",
       s_per_step_hidden_layers_1="[" + ",".join(
           f"{r['s']:.4f}" for r in one) + "]",
       peak_mem_gb=f"{peak[HL_DEPTH]:.2f}",
       peak_mem_gb_hidden_layers_1=f"{peak[1]:.2f}",
       k3_per_step=k3 // ROLLOUT_STEPS,
       row_gathers_per_step=deep[0]["gathers"] // ROLLOUT_STEPS,
       k1_per_step_hidden_layers_1=one[0]["counts"]["fused_edge"]
       // ROLLOUT_STEPS, reruns="bit-equal", finite=True)
  del predictors, runs, deep, one, inputs, targets1, forcings_n

  # The AR-1 training step in the JAX package's 0.25° form (form B), on
  # one ERA5-shaped batch made on the card (data/era5.py) for both models.
  from graphcast_tpu_torch.examples.graphcast_demo import (
      era5_inputs_targets_forcings)
  cfg = bench_train_025.training_config(resolution=0.25)
  batch = tuple(fs.astype(torch.bfloat16) for fs in
                era5_inputs_targets_forcings(cfg["task"], cfg["resolution"],
                                             1, 6, seed=0, device=DEVICE))
  train = {}
  for hl in (HL_DEPTH, 1):
    gc.collect()  # the models before it are freed
    torch.cuda.empty_cache()
    # What stays resident from earlier phases (main's cached data among
    # them) counts in the peak; it is printed beside it.
    resident_gb = torch.cuda.memory_allocated() / 1e9
    t1 = time.perf_counter()
    model, step, batch = bench_train_025.build_step(
        cfg, 1, torch.device(DEVICE), hidden_layers=hl, batch=batch)
    start = [p.detach().to("cpu", copy=True) for p in model.parameters()]

    def grads():
      return [p.grad.detach().to("cpu", copy=True) for p in
              model.parameters() if p.grad is not None]

    first_s, (loss_a, _) = _timed_s(torch, lambda: step(*batch))
    grads_a = grads()
    with torch.no_grad():  # the same parameters again: a rerun
      for p, s in zip(model.parameters(), start):
        p.copy_(s)
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    with _GatherCount() as gathers:
      seconds, (loss_b, _) = _timed_s(torch, lambda: step(*batch))
    counts = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    grads_b = grads()
    if not (torch.equal(loss_a, loss_b) and len(grads_a) == len(grads_b)
            and all(torch.equal(a, b) for a, b in zip(grads_a, grads_b))):
      raise AssertionError(f"hidden_layers train (hidden_layers={hl}): the "
                           "rerun's loss or gradients differ")
    times = [seconds]
    for _ in range(HL_TRAIN_STEPS - 1):
      times.append(_timed_s(torch, lambda: step(*batch))[0])
    if not np.isfinite(float(loss_a)):
      raise AssertionError(f"hidden_layers train: loss {float(loss_a)}")
    train[hl] = dict(first_s=first_s, s=min(times), peak_gb=peak_gb,
                     resident_gb=resident_gb,
                     counts=counts, gathers=gathers.n, loss=float(loss_a),
                     build_s=time.perf_counter() - t1)
    del model, step, start, grads_a, grads_b
  del batch
  gc.collect()
  torch.cuda.empty_cache()
  deep, one = train[HL_DEPTH], train[1]
  if (not deep["counts"]["segment_sum"]
      or any(deep["counts"][k] for k in _FUSED_KERNELS)
      or not one["counts"]["fused_edge_bwd"]):
    raise AssertionError(f"hidden_layers train launches: {deep['counts']}, "
                         f"hidden_layers=1 {one['counts']}")
  _path_launches("hidden_layers", results, deep["counts"], ("segment_sum",),
                 "hidden_layers_train")
  _log("hidden_layers", t0, train_form=json.dumps(
      {k: str(v) for k, v in cfg.items() if k != "task"},
      sort_keys=True).replace(" ", ""), ar_steps=1,
       first_step_s=f"{deep['first_s']:.2f}", s_per_step=f"{deep['s']:.4f}",
       peak_mem_gb=f"{deep['peak_gb']:.2f}",
       resident_before_gb=f"{deep['resident_gb']:.2f}",
       loss=f"{deep['loss']:.6g}",
       k3_per_step=deep["counts"]["segment_sum"],
       row_gathers_per_step=deep["gathers"],
       s_per_step_hidden_layers_1=f"{one['s']:.4f}",
       peak_mem_gb_hidden_layers_1=f"{one['peak_gb']:.2f}",
       resident_before_gb_hidden_layers_1=f"{one['resident_gb']:.2f}",
       k3_per_step_hidden_layers_1=one["counts"]["segment_sum"],
       k4_per_step_hidden_layers_1=one["counts"]["fused_edge_bwd"],
       rerun="bit-equal (loss, every gradient)")


def _gencast_hidden_layers_preset(preset, hidden_layers, layers=None):
  """A GenCast preset with its MLPs at ``hidden_layers`` (and, given
  ``layers``, its transformer cut to that depth)."""
  arch = preset.denoiser_architecture_config
  st = arch.sparse_transformer_config
  if layers is not None:
    st = dataclasses.replace(st, num_layers=layers)
  return dataclasses.replace(preset, denoiser_architecture_config=(
      dataclasses.replace(arch, hidden_layers=hidden_layers,
                          sparse_transformer_config=st)))


def phase_gencast_hidden_layers(torch, results):
  """zoo.gencast_1p0deg() at hidden_layers=HL_DEPTH (module doc)."""
  from graphcast_tpu_torch import train
  from graphcast_tpu_torch.models import zoo
  t0 = time.perf_counter()
  preset = _gencast_hidden_layers_preset(zoo.gencast_1p0deg(), HL_DEPTH)
  model, stack = _gencast_stack(torch, preset, seed=0)
  data = _gencast_train_data(torch, preset, DEVICE, torch.bfloat16)
  inputs, targets, forcings = (fs.map_data(torch.nan_to_num)
                               for fs in data)

  def sample(seed):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    with torch.inference_mode():
      return stack(inputs, targets, forcings, generator=gen)

  warm_s, _ = _timed_s(torch, lambda: sample(100))
  torch.cuda.reset_peak_memory_stats()
  _reset_counters()
  steps_s, samples = _timed_s(torch, lambda: [
      sample(1 + i) for i in range(HL_GENCAST_STEPS)])
  counts = _launches()
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  for s in samples:
    _check_fieldset(torch, "gencast_hidden_layers", s, targets)
  evals = 2 * preset.sampler_config.num_noise_levels - 1
  layers = preset.denoiser_architecture_config.sparse_transformer_config
  want = {"splash_fwd": evals * layers.num_layers, "segment_sum": 2 * evals}
  if (any(counts[k] != n * HL_GENCAST_STEPS for k, n in want.items())
      or any(counts[k] for k in _FUSED_KERNELS)):
    raise AssertionError(f"gencast_hidden_layers launches {counts}, expected "
                         f"{want} a step and no fused kernel")
  _path_launches("gencast_hidden_layers", results, counts,
                 ("splash_fwd", "segment_sum"), "gencast_hidden_layers")

  # One training step, NaN SST in the batch, after a warm-up step.
  step = train.make_train_step(
      stack, train.graphcast_optimizer(model.parameters(), peak_lr=1e-3))
  gen = torch.Generator(device=DEVICE).manual_seed(5)
  before = [p.detach().to("cpu", copy=True) for p in model.parameters()]
  train_warm_s, (loss0, _) = _timed_s(torch, lambda: step(
      *data, generator=gen))
  torch.cuda.reset_peak_memory_stats()
  _reset_counters()
  train_s, (loss1, _) = _timed_s(torch, lambda: step(*data, generator=gen))
  tcounts = _launches()
  train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
  losses = [float(loss0), float(loss1)]
  if not all(np.isfinite(losses)):
    raise AssertionError(f"gencast_hidden_layers: training losses {losses}")
  if all(torch.equal(a, p.detach().cpu())
         for a, p in zip(before, model.parameters())):
    raise AssertionError("gencast_hidden_layers: no parameter changed")
  want = {k: layers.num_layers for k in ("splash_fwd", "splash_dq",
                                         "splash_dkv")}
  if (any(tcounts[k] != n for k, n in want.items())
      or not tcounts["segment_sum"]
      or any(tcounts[k] for k in _FUSED_KERNELS)):
    raise AssertionError(f"gencast_hidden_layers train launches {tcounts}")
  _path_launches("gencast_hidden_layers", results, tcounts,
                 ("splash_fwd", "splash_dq", "splash_dkv", "segment_sum"),
                 "gencast_hidden_layers_train")
  _log("gencast_hidden_layers", t0, config=_gencast_label(preset),
       hidden_layers=HL_DEPTH, steps=HL_GENCAST_STEPS,
       warmup_step_s=f"{warm_s:.2f}",
       s_per_12h_step=f"{steps_s / HL_GENCAST_STEPS:.4f}",
       peak_mem_gb=f"{peak_gb:.2f}",
       k6_per_step=counts["splash_fwd"] // HL_GENCAST_STEPS,
       k3_per_step=counts["segment_sum"] // HL_GENCAST_STEPS,
       train_warmup_s=f"{train_warm_s:.2f}", train_s=f"{train_s:.4f}",
       train_peak_mem_gb=f"{train_peak_gb:.2f}",
       train_losses="[" + ",".join(f"{v:.6g}" for v in losses) + "]",
       train_k6_k7_k8=f"{tcounts['splash_fwd']},{tcounts['splash_dq']},"
       f"{tcounts['splash_dkv']}", train_k3=tcounts["segment_sum"],
       finite=True, params_changed=True)
  del model, stack, step, samples, before
  torch.cuda.empty_cache()


def _hl_small_preset(hidden_layers):
  from graphcast_tpu_torch.models import configs, zoo
  return zoo.GraphCastPreset(
      name=f"GraphCast tiny hidden_layers={hidden_layers}",
      model_config=configs.ModelConfig(hidden_layers=hidden_layers,
                                       **HL_SMALL_MODEL),
      task_config=configs.TaskConfig(**HL_SMALL_TASK))


def _hl_mini_preset():
  from graphcast_tpu_torch.models import zoo
  return _gencast_hidden_layers_preset(zoo.gencast_mini(), HL_DEPTH,
                                       HL_MINI_LAYERS)


def _gnn_graph(torch, device, dtype, edge_width, node_width):
  """hidden_layers_small's typed graph (two node sets, three edge sets,
  one within a set; batch 2), its K3 aggregators and a conditioning,
  from numpy seeds, on ``device`` in ``dtype``."""
  import functools as ft
  from graphcast_tpu_torch.nn import typed_graph as tg
  from graphcast_tpu_torch.ops.fused_edge import EdgeIndex
  from graphcast_tpu_torch.ops.segment_sum import sorted_segment_sum
  rng = np.random.RandomState(HL_SMALL_SEED)
  nodes, edges, aggregators = {}, {}, {}
  for name, count in HL_GNN_NODES.items():
    nodes[name] = tg.NodeSet(count, torch.from_numpy(rng.randn(
        count, 2, node_width).astype(np.float32)).to(device, dtype))
  for name, (s, r) in HL_GNN_EDGE_SETS.items():
    n = 4 * HL_GNN_NODES[r]
    senders = rng.randint(0, HL_GNN_NODES[s], n)
    receivers = rng.randint(0, HL_GNN_NODES[r], n)
    order = np.lexsort((senders, receivers))
    senders, receivers = senders[order], receivers[order]
    index = EdgeIndex(senders, receivers, HL_GNN_NODES[s], HL_GNN_NODES[r],
                      device=device)
    aggregators[name] = ft.partial(sorted_segment_sum, index)
    edges[tg.EdgeSetKey(name, (s, r))] = tg.EdgeSet(
        tg.EdgesIndices(torch.as_tensor(senders, device=device),
                        torch.as_tensor(receivers, device=device)),
        torch.from_numpy(rng.randn(n, 2, edge_width).astype(
            np.float32)).to(device, dtype))
  cond = torch.from_numpy(rng.randn(2, 4).astype(np.float32)).to(device,
                                                                 dtype)
  graph = tg.TypedGraph(context=tg.Context(features=()), nodes=nodes,
                        edges=edges)
  return graph, aggregators, cond


def _gnn_run(torch, options, device, dtype):
  """{name: tensor} of one DeepGraphNet (HL_GNN_BASE with ``options``):
  its output features and every parameter gradient of a fixed projection
  of them, f32 on the CPU."""
  from graphcast_tpu_torch.nn import core, deep_gnn
  cfg = dict(HL_GNN_BASE, **options)
  c = HL_GNN_C
  edge_width = 4 if cfg.get("embed_edges", True) else c
  node_width = 5 if cfg.get("embed_nodes", True) else c
  graph, aggregators, cond = _gnn_graph(torch, device, dtype, edge_width,
                                        node_width)
  net = deep_gnn.DeepGraphNet(
      node_latent_size={n: c for n in HL_GNN_NODES},
      edge_latent_size={n: c for n in HL_GNN_EDGE_SETS},
      node_input_size={n: node_width for n in HL_GNN_NODES},
      edge_input_size={n: edge_width for n in HL_GNN_EDGE_SETS},
      edge_sets=HL_GNN_EDGE_SETS, **cfg)
  core.reset_parameters(net, torch.Generator().manual_seed(HL_SMALL_SEED))
  net = net.to(device)
  out = net(graph, cond=cond if cfg.get("norm_conditioning_size") else None,
            edge_aggregators=aggregators)
  feats = {f"node {n}": ns.features for n, ns in out.nodes.items()}
  feats.update({f"edge {k.name}": es.features for k, es in out.edges.items()})
  rng = np.random.RandomState(HL_SMALL_SEED + 1)
  total = sum((f.float() * torch.from_numpy(rng.randn(*f.shape).astype(
      np.float32)).to(device)).sum() for _, f in sorted(feats.items()))
  total.backward()
  result = {k: f.detach().float().cpu() for k, f in feats.items()}
  result.update({f"grad {k}": (torch.zeros(p.shape) if p.grad is None
                               else p.grad.detach().float().cpu())
                 for k, p in net.named_parameters()})
  return result


def _gnn_cases():
  from graphcast_tpu_torch.nn import core
  cases = dict(HL_GNN_OPTIONS)
  cases.update({f"activation_{a}": dict(activation=a)
                for a in sorted(core.ACTIVATIONS)})
  return cases


_HL_SMALL_REFS = {}


def _hl_small_references(torch):
  """hidden_layers_small's CPU runs, f32 and bf16 (its noise floor), made
  once: GraphCast tiny at each of HL_SMALL_DEPTHS (one step, and the AR-1
  loss with every gradient), GenCast Mini at HL_DEPTH (one evaluation,
  and the loss with every gradient at σ = HL_MINI_SIGMA on numpy noise),
  and each DeepGraphNet case."""
  from graphcast_tpu_torch.data import synthetic
  if _HL_SMALL_REFS:
    return _HL_SMALL_REFS
  t0 = time.perf_counter()
  refs = {}
  for hl in HL_SMALL_DEPTHS:
    preset = _hl_small_preset(hl)
    data = synthetic.make_example_batch(
        preset.task_config, resolution=preset.model_config.resolution,
        batch=1, device="cpu")
    outs, train = {}, {}
    for bf16 in (False, True):
      model, stack = _stack(torch, preset, seed=HL_SMALL_SEED, bf16=bf16,
                            device="cpu", gradient_checkpointing=True)
      with torch.inference_mode():
        outs[bf16] = stack(*data)
      train[bf16] = _loss_and_grads(torch, stack, model, data, "cpu")
    refs[("graphcast", hl)] = data, outs, train
  preset = _hl_mini_preset()
  data = _gencast_train_data(torch, preset, "cpu", torch.float32)
  noisy = data[1].map_data(lambda x: torch.nan_to_num(x) + HL_MINI_SIGMA
                           * torch.from_numpy(np.random.RandomState(
                               HL_SMALL_SEED).randn(*x.shape).astype(
                                   np.float32)))
  outs, train = {}, {}
  for bf16 in (False, True):
    dtype = torch.bfloat16 if bf16 else torch.float32
    model, stack = _gencast_stack(torch, preset, seed=HL_SMALL_SEED,
                                  device="cpu")
    outs[bf16] = _denoise(torch, model, data[0].map_data(torch.nan_to_num),
                          noisy, torch.tensor([HL_MINI_SIGMA]),
                          data[2], dtype, "cpu")
    _fix_noise_draw(torch, model, HL_MINI_SIGMA, seed=HL_SMALL_SEED)
    train[bf16] = _loss_and_grads(
        torch, stack, model, [fs.astype(dtype) for fs in data], "cpu",
        generator=torch.Generator())
  refs["gencast"] = data, noisy, outs, train
  for name, options in _gnn_cases().items():
    refs[("gnn", name)] = {bf16: _gnn_run(
        torch, options, "cpu", torch.bfloat16 if bf16 else torch.float32)
                           for bf16 in (False, True)}
  refs["cpu_s"] = time.perf_counter() - t0
  _HL_SMALL_REFS.update(refs)
  return _HL_SMALL_REFS


def _train_floor(torch, phase, card, cpu):
  """_noise_floor_checks on _loss_and_grads results: the loss, each
  per-variable loss and each gradient."""
  return _noise_floor_checks(
      torch, phase, {"loss": card[0], **card[1]}, card[2],
      {k: (None, {"loss": v[0], **v[1]}, v[2]) for k, v in cpu.items()})


def phase_hidden_layers_small(torch):
  """Tiny GraphCast at HL_SMALL_DEPTHS, GenCast Mini at HL_DEPTH and each
  DeepGraphNet case on the card against the port on the CPU (module
  doc)."""
  t0 = time.perf_counter()
  refs = _hl_small_references(torch)
  worst = {}
  for hl in HL_SMALL_DEPTHS:
    data, outs, train = refs[("graphcast", hl)]
    preset = _hl_small_preset(hl)
    model, stack = _stack(torch, preset, seed=HL_SMALL_SEED, device=DEVICE,
                          gradient_checkpointing=True)
    stack = stack.to(DEVICE)
    card_data = [fs.to(DEVICE) for fs in data]
    with torch.inference_mode():
      out = stack(*card_data)
    names = data[1].var_names
    w = _check_noise_floor(torch, f"hidden_layers_small graphcast {hl}",
                           {n: out.data(n) for n in names}, outs, names)
    t = _train_floor(torch, f"hidden_layers_small graphcast {hl}",
                     _loss_and_grads(torch, stack, model, card_data, DEVICE),
                     train)
    worst[f"graphcast_{hl}"] = max(w, t["var"], t["param"])
    del model, stack
  data, noisy, outs, train = refs["gencast"]
  preset = _hl_mini_preset()
  model, stack = _gencast_stack(torch, preset, seed=HL_SMALL_SEED)
  out = _denoise(torch, model, data[0].map_data(torch.nan_to_num), noisy,
                 torch.tensor([HL_MINI_SIGMA]), data[2], torch.bfloat16,
                 DEVICE)
  names = data[1].var_names
  w = _check_noise_floor(torch, "hidden_layers_small gencast",
                         {n: out.data(n) for n in names}, outs, names)
  _fix_noise_draw(torch, model, HL_MINI_SIGMA, seed=HL_SMALL_SEED)
  t = _train_floor(torch, "hidden_layers_small gencast", _loss_and_grads(
      torch, stack, model, [fs.astype(torch.bfloat16) for fs in data],
      DEVICE, generator=torch.Generator(device=DEVICE)), train)
  worst["gencast_mini"] = max(w, t["var"], t["param"])
  del model, stack
  for name in _gnn_cases():
    cpu = refs[("gnn", name)]
    card = _gnn_run(torch, _gnn_cases()[name], DEVICE, torch.bfloat16)
    bound_ratio = 0.0
    for k, f32 in cpu[False].items():
      floor = _rms(torch, cpu[True][k] - f32)
      bound = 2 * floor + SMALL_EPS * _rms(torch, f32)
      err = _rms(torch, card[k] - f32)
      if not (np.isfinite(err) and err <= bound):
        raise AssertionError(f"hidden_layers_small {name} {k}: rms(card-f32)"
                             f"={err:.4g} > 2*floor+eps={bound:.4g}")
      bound_ratio = max(bound_ratio, err / bound if bound else 0.0)
    worst[name] = bound_ratio
  torch.cuda.empty_cache()
  _log("hidden_layers_small", t0, graphcast=f"{HL_SMALL_MODEL}".replace(
      " ", ""), graphcast_hidden_layers=",".join(map(str, HL_SMALL_DEPTHS)),
       gencast=_gencast_label(preset), gencast_hidden_layers=HL_DEPTH,
       gnn_cases=len(_gnn_cases()), cpu_s=f"{refs['cpu_s']:.1f}",
       worst_err_over_bound=json.dumps(
           {k: round(v, 3) for k, v in worst.items()}).replace(" ", ""))


def _timed_s(torch, fn):
  """(seconds, result) of ``fn()``, the card synchronized at both ends."""
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  out = fn()
  torch.cuda.synchronize()
  return time.perf_counter() - t0, out


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--phases", default=",".join(PHASES),
                      help="comma-separated subset of " + ",".join(PHASES))
  parser.add_argument("--profile", metavar="DIR",
                      help="also profile one main-path step, one train step, "
                           "one GenCast step, one GenCast train step, one "
                           "ensemble chunk, one batch-4 GraphCast step and "
                           "one 0.25 deg GenCast step "
                           "(torch.profiler) and write their kernel tables "
                           "and traces to DIR")
  args = parser.parse_args(argv)
  phases = args.phases.split(",")
  unknown = set(phases) - set(PHASES)
  if unknown:
    parser.error(f"unknown phases {sorted(unknown)}")
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 2
  # No geometry disk cache: the script writes nothing outside the checkout
  # and times each artifact's build (an empty variable turns it off).
  os.environ["GRAPHCAST_TPU_CACHE"] = ""
  torch.backends.cuda.matmul.allow_tf32 = False  # twins in true f32
  torch.backends.cudnn.allow_tf32 = False
  import graphcast_tpu_torch  # noqa: F401  (fails outside the repository)

  # The phases use more grid and mesh configurations than one model does:
  # keep every geometry artifact and attention mask built in this run.
  from graphcast_tpu_torch.geometry import artifact as artifact_lib
  from graphcast_tpu_torch.models import sparse_transformer
  artifact_lib.ARTIFACT_CACHE_SIZE = 16
  sparse_transformer.MASK_CACHE_SIZE = 16

  t_start = time.perf_counter()
  prelude = _host_prelude(torch, phases)
  card = phase_build(torch)
  prelude()
  if "shared_card" in phases:
    phase_shared_card(torch)
  results = {}
  if {"k1", "k2", "k4", "k5", "embed", "embed_bwd", "k3", "main",
      "k1p"} & set(phases):
    art = _geometry(0.25, 6)
  if "k1" in phases:
    phase_k1(torch, art, results)
  if "k2" in phases:
    phase_k2(torch, art, results)
  if "k4" in phases:
    phase_k4(torch, art, results)
  if "k5" in phases:
    phase_k5(torch, art, results)
  if "wgrad" in phases:
    phase_wgrad(torch, results)
  if "k6" in phases:
    phase_k6(torch, results)
  if "k7k8" in phases:
    phase_k7k8(torch, results)
  if "sp_attention" in phases:
    phase_sp_attention(torch, results)
  if "embed" in phases:
    phase_embed(torch, art, results)
  if "embed_bwd" in phases:
    phase_embed_bwd(torch, art, results)
  if "k3" in phases:
    phase_k3(torch, art, results)
  if "main" in phases:
    for name in ("fused_edge", "fused_edge_encoder", "fused_decoder"):
      results.setdefault(name, {"name": name})
    phase_main(torch, results, args.profile)
  if "small" in phases:
    phase_small(torch)
  if "train" in phases:
    phase_train(torch, results, args.profile)
  if "train_forms" in phases:
    phase_train_forms(torch, results)
  if "train_small" in phases:
    phase_train_small(torch)
  if "gencast" in phases:
    for name in ("splash_fwd", "fused_edge_embed", "fused_decoder_embed"):
      results.setdefault(name, {"name": name})
    phase_gencast(torch, results, args.profile)
  if "gencast_small" in phases:
    phase_gencast_small(torch)
  if "gencast_train" in phases:
    for name in ("splash_fwd", "splash_dq", "splash_dkv", "fused_edge_embed",
                 "fused_decoder_embed", "fused_edge_bwd_embed",
                 "fused_decoder_bwd_embed", "weight_grad", "feature_grad",
                 "segment_sum_sender"):
      results.setdefault(name, {"name": name})
    phase_gencast_train(torch, results, args.profile)
  if "gencast_train_small" in phases:
    phase_gencast_train_small(torch)
  if {"ensemble", "graphcast_batch"} & set(phases):
    results.setdefault("segment_sum", {"name": "segment_sum"})
  if "ensemble" in phases:
    results.setdefault("splash_fwd", {"name": "splash_fwd"})
    phase_ensemble(torch, results, args.profile)
  if "ensemble_small" in phases:
    phase_ensemble_small(torch)
  if "graphcast_batch" in phases:
    phase_graphcast_batch(torch, results, args.profile)
  if "parallel" in phases:
    phase_parallel(torch, results)
  if "forecast" in phases:
    phase_forecast(torch, results)
  if "gencast_0p25" in phases:
    phase_gencast_0p25(torch, results, args.profile)
  if "ensemble_0p25_chunked" in phases:
    phase_ensemble_0p25_chunked(torch, results)
  if "triblock" in phases:
    phase_triblock(torch, results)
  if {"k1p", "main_pipelined", "bench"} & set(phases):
    for name in ("fused_edge_pipelined", "fused_edge_pipelined_encoder",
                 "fused_edge_pipelined_embed"):
      results.setdefault(name, {"name": name})
  if "k1p" in phases:
    phase_k1p(torch, art, results)
  if "main_pipelined" in phases:
    phase_main_pipelined(torch, results, args.profile)
  if "bench" in phases:
    phase_bench(torch, card, results)
  if "train_curve" in phases:
    phase_train_curve(torch, results)
  if "gencast_rollout" in phases:
    phase_gencast_rollout(torch, results)
  if "bench_train" in phases:
    phase_bench_train(torch, results)
  if "memdump" in phases:
    phase_memdump(torch, results)
  if {"hidden_layers", "gencast_hidden_layers"} & set(phases):
    results.setdefault("segment_sum", {"name": "segment_sum"})
  if "hidden_layers" in phases:
    phase_hidden_layers(torch, results)
  if "gencast_hidden_layers" in phases:
    phase_gencast_hidden_layers(torch, results)
  if "hidden_layers_small" in phases:
    phase_hidden_layers_small(torch)
  print(f"[total] {time.perf_counter() - t_start:.1f}s", flush=True)
  print(card)
  print(json.dumps({"kernels": list(results.values())}))
  if set(phases) != set(PHASES):
    print(f"chip_smoke: ran only {phases}; no result line")
    return 0
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  try:
    sys.exit(main())
  except Exception as e:  # noqa: BLE001  (re-raised after the name)
    traceback.print_exc()
    print(f"chip_smoke: failed in {_failed_phase(e.__traceback__)} "
          f"(last line: {_last_log[0][:300]!r}): {type(e).__name__}",
          file=sys.stderr, flush=True)
    sys.exit(1)
