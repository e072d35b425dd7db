"""Drives the PyTorch port of GraphCast and GenCast (graphcast_tpu_torch) on
one GPU.

Usage: python3 chip_smoke.py            (all phases; needs one CUDA device)
       python3 chip_smoke.py --phases build,k1,k2   (a subset, for debugging)
       python3 chip_smoke.py --profile DIR  (also profile one step of each
                                             timed path)

Phases, each printing one line with its seconds and results:
  build  compile csrc/*.cu with nvcc for sm_90a and load it; print the
         card's name and power limit (nvidia-smi).
  k1     the fused edge kernel against its plain-PyTorch twin on the card:
         processor mode on the real mesh-6 multi-mesh edge set and encoder
         mode on the real 0.25° grid2mesh edge set, latent 512, bf16.
  k2     the fused decoder kernel against its twin at 0.25° (1,038,240 grid
         nodes, 227 outputs).
  main   the main path: zoo.graphcast() (0.25°, 37 levels, mesh-6, latent
         512, 16 message-passing steps), random weights from a fixed
         torch.Generator, Autoregressive(InputsAndResiduals(Bfloat16Cast(
         GraphCast))).rollout_final for 4 six-hour steps at batch 1 in bf16;
         checks finiteness and the kernels' launch counts.
  small  zoo.graphcast_small() one step on the card (bf16, kernels) against
         the same port on the CPU (twins): per variable,
         rms(card bf16 - cpu f32) <= 2 * rms(cpu bf16 - cpu f32) + eps.
  k4     the edge step's backward kernel against torch.autograd.grad of the
         K1 twin, seeded random cotangents: processor mode on the mesh-6
         edge set, encoder mode on the 0.25° grid2mesh edge set.
  k5     the decoder's backward kernel against autograd of the K2 twin on
         the first 131,072 grid nodes of the 0.25° mesh2grid list with all
         mesh-6 nodes (the twin's f32 autograd at all 1,038,240 nodes would
         hold several 6.4 GB tensors); the kernel in uneven node chunks
         against one chunk; then the kernel alone at all nodes.
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
         same masks (the kernels' own o and lse from K6), with the backward
         of scaled_dot_product_attention with the dense boolean mask at
         mesh-5 as the library yardstick.
  embed  K1 and K2 in embed mode (GenCast's grid2mesh and mesh2grid, raw
         edge features embedded in the kernel) against their plain versions
         on the real 1.0° GenCast and 0.25° edge sets.
  embed_bwd  K4 and K5 in embed mode against torch.autograd.grad of the K1
         and K2 embed twins on the real 1.0° GenCast edge sets, each kernel
         alone on the 0.25° sets, and the feature-gradient pass they share
         against its plain version.
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
         MINI_LAYERS layers, for the CPU side's sake, in all the Mini
         phases): one preconditioned denoiser
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
         yardstick.
  ensemble  the main path of the batch > 1 slice, GenCast's ensemble
         forecast: rollout.chunked_ensemble_prediction over NaNCleaner(
         InputsAndResiduals(GenCast)) at zoo.gencast_1p0deg(), random
         weights as in gencast, ENSEMBLE_MEMBERS members as the batch axis,
         bf16; one warm-up chunk, then ENSEMBLE_STEPS timed 12 h chunks:
         s per step and per member-step, peak memory; checks finite output
         of the template's shape, distinct members and the launches per
         step (K3 once per evaluation, K6 once per layer per evaluation, K1
         and K2 none).
  ensemble_small  zoo.gencast_mini() at batch 2 on the card: one
         preconditioned denoiser evaluation (the general path, K3) per pair
         of gencast_small's three noise levels, a level per member; each
         member against the port on the CPU at its level (gencast_small's
         own CPU runs, made once) with the small phase's noise-floor rule.
  graphcast_batch  zoo.graphcast_small() at batch BATCH through Autoregressive(
         InputsAndResiduals(Bfloat16Cast(GraphCast))): the general path with
         K3. Member 0 of one step (the small phase's inputs) against a
         batch-1 card step of its inputs (K1, K2) and against the small
         phase's CPU f32 run, each within the small phase's noise floor;
         then rollout_final over BATCH_STEPS timed steps: s per step, peak
         memory, K3 once per aggregation (17 a step), K1 and K2 none.
  k1p    the pipelined edge kernel (K1p) against its plain version and
         against K1 on the same inputs: processor mode on the mesh-6
         multi-mesh, encoder mode on the 0.25° grid2mesh set, embed mode on
         the 1.0° GenCast and the 0.25° grid2mesh sets; e' bit-identical to
         K1's, the receiver sums to f32 reassociation; K1p ms beside K1 ms
         (timed in turns), plain ms and the bound; then one K4 backward
         behind a K1p forward through fused_edge against one behind K1.
  main_pipelined  the main path of main with GC_PIPELINED_EDGE=1: the same
         weights, inputs and rollout_final, K1p 16 + 1 launches a step and
         K1 none; the final state against main's, per variable; s/step of
         both runs and the peak memory.
  bench  the benchmark mirror's main() (python3 -m graphcast_tpu_torch.bench)
         with BENCH_FALLBACK_ONLY=1, BENCH_NUM_STEPS=BENCH_STEPS and
         GC_PIPELINED_EDGE=1: the GenCast 1.0° 12 h step (K1p in embed mode,
         39 a step) and the 1.0° GraphCast fallback rollout (K1p processor
         and encoder modes); checks its lines' keys and metric names and
         that K1p ran where K1 would have.

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
embedding moves all of them the same way. K1p against K1: e' equal bit for
bit, the receiver sums within relative RMS K1P_AGG_RTOL (only runs that
cross a tile boundary are summed in another f32 order); each gradient
behind a K1p forward against the one behind K1: rms(K1p - K1) <= 2 rms(K1'
- K1) + K1P_GRAD_RTOL rms(K1), K1' a second run of K1's path (K4's f32
atomics add in a run-dependent order, and the bf16 gradients round their
sums).

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
import json
import subprocess
import sys
import time

import numpy as np

KERNEL_RTOL = 1e-2      # relative RMS error, kernel vs twin
KERNEL_ATOL = 0.125     # max-abs error, kernel vs twin
GRAD_RTOL = 1e-2        # relative RMS error per gradient, K4/K5 vs autograd
WGRAD_RTOL = 1e-4       # relative RMS error, weight-gradient reduction
SMALL_EPS = 1e-4        # noise-floor slack, relative to rms(cpu f32)
ROLLOUT_STEPS = 4
TRAIN_STEPS = 3
K5_NODES = 131_072
TRAIN_SMALL_MP_STEPS = 4
LSE_ATOL = 1e-3         # max-abs error of the attention's logsumexp
GENCAST_STEPS = 2
SST_NAN_ROWS = 10       # latitude rows of NaN SST in the GenCast train data
GENCAST_TRAIN_SMALL_SIGMA = 1.0
ENSEMBLE_MEMBERS = 4    # GenCast ensemble members, the batch axis
ENSEMBLE_STEPS = 2      # timed 12 h chunks of the ensemble rollout
BATCH = 4               # GraphCast_small batch of the graphcast_batch phase
BATCH_STEPS = 2         # its timed 6 h steps
K1P_AGG_RTOL = 1e-6     # relative RMS, K1p's receiver sums vs K1's
K1P_GRAD_RTOL = 1e-6    # slack over K4's run-to-run noise, relative to rms
MAIN_PIPELINED_RTOL = 1e-2  # relative RMS per variable, vs main's final
BENCH_STEPS = 4         # the bench phase's BENCH_NUM_STEPS
PEAK_FLOPS = 989e12     # H100 SXM, dense bf16 tensor cores
PEAK_F32 = 67e12        # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3, bytes/s
DEVICE = "cuda"
PHASES = ("build", "k1", "k2", "k4", "k5", "wgrad", "k6", "k7k8", "embed",
          "embed_bwd", "k3", "main", "small", "train", "train_small",
          "gencast", "gencast_small", "gencast_train", "gencast_train_small",
          "ensemble", "ensemble_small", "graphcast_batch", "k1p",
          "main_pipelined", "bench")


def _log(phase, t0, **fields):
  parts = " ".join(f"{k}={v}" for k, v in fields.items())
  print(f"[{phase}] {time.perf_counter() - t0:.1f}s {parts}", flush=True)


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
  """(FLOPs, bytes) of one K1 call: per edge row 2 (processor), 1 (encoder)
  or 3 (embed, plus the F-deep first layer) C x C products."""
  flops = {"processor": 4 * C * C, "encoder": 2 * C * C,
           "embed": 6 * C * C + 2 * F * C}[mode] * E
  rows = {"processor": 2 * E * C * 2, "encoder": E * C * 2,
          "embed": E * F * 2}[mode]
  mats = {"processor": 2, "encoder": 1, "embed": 3}[mode] * C * C * 2
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
  return card


def _geometry(resolution, mesh_size):
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.geometry import artifact as artifact_lib
  lat, lon = synthetic.grid_coords(resolution)
  return artifact_lib.build_artifact(lat, lon, mesh_size)


def phase_k1(torch, art, results):
  from graphcast_tpu_torch.ops.fused_edge import (
      EdgeIndex, fused_edge, fused_edge_reference)
  t0 = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(1)
  C = 512
  g, m = art.num_grid_nodes, art.num_mesh_nodes
  cases = {
      "processor": (EdgeIndex(art.mesh.senders, art.mesh.receivers, m, m,
                              DEVICE), False),
      "encoder": (EdgeIndex(art.grid2mesh.senders, art.grid2mesh.receivers,
                            g, m, DEVICE), True),
  }
  for mode, (edges, encoder) in cases.items():
    args = _edge_case(torch, gen, edges, C, encoder)
    write = not encoder
    with torch.inference_mode():
      got = fused_edge(edges, write_edges=write, **args)
      want = fused_edge_reference(edges, write_edges=write, **args)
      torch.cuda.synchronize()
      pairs = [("agg", got, want)] if encoder else [
          ("e_out", got[0], want[0]), ("agg", got[1], want[1])]
      errs = {}
      for name, a, b in pairs:
        errs[name] = _check_close(f"k1 {mode} {name}", a, b)
      ms = _time_ms(torch, lambda: fused_edge(edges, write_edges=write,
                                              **args))
      plain_ms = _time_ms(torch, lambda: fused_edge_reference(
          edges, write_edges=write, **args))
    key = "fused_edge" if mode == "processor" else "fused_edge_encoder"
    results[key] = _entry(
        key, "fused_edge.cu", "graphcast_tpu/ops/pallas_edge.py:116",
        mode=mode, launches=None,
        max_abs_err=max(e[0] for e in errs.values()), ms=ms,
        plain_ms=plain_ms, **_bound(*_edge_cost(
            edges.num_edges, edges.num_senders, edges.num_receivers, C,
            mode)))
    _log("k1", t0, mode=mode, edges=edges.num_edges,
         **{f"{n}_max_abs": f"{e[0]:.4g}" for n, e in errs.items()},
         **{f"{n}_rel_rms": f"{e[1]:.3g}" for n, e in errs.items()},
         ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}",
         bound_ms=f"{results[key]['bound_ms']:.4f}")
    del args, got, want
    torch.cuda.empty_cache()


def phase_k2(torch, art, results):
  from graphcast_tpu_torch.ops.fused_decoder import (
      MATRICES, VECTORS, fused_decode, fused_decode_reference)
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
  with torch.inference_mode():
    got = fused_decode(edges, grid, mesh_proj, const, weights)
    want = fused_decode_reference(edges, grid, mesh_proj, const, weights)
    torch.cuda.synchronize()
    max_abs, rel_rms = _check_close("k2 out", got, want)
    del want
    torch.cuda.empty_cache()
    ms = _time_ms(torch, lambda: fused_decode(edges, grid, mesh_proj, const,
                                              weights))
    plain_ms = _time_ms(torch, lambda: fused_decode_reference(
        edges, grid, mesh_proj, const, weights), reps=1)
  results["fused_decoder"] = _entry(
      "fused_decoder", "fused_decoder.cu",
      "graphcast_tpu/ops/pallas_decoder.py:76", mode="plain", launches=None,
      max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
      **_bound(*_decoder_cost(g, m, C, num_out, embed=False)))
  _log("k2", t0, grid_nodes=g, outputs=num_out, max_abs=f"{max_abs:.4g}",
       rel_rms=f"{rel_rms:.3g}", ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}",
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


def phase_k4(torch, art, results):
  from graphcast_tpu_torch.ops.fused_edge import (
      EdgeIndex, fused_edge, fused_edge_backward, fused_edge_reference)
  t0 = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(4)
  C = 512
  g, m = art.num_grid_nodes, art.num_mesh_nodes
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
    ms = _time_ms(torch, lambda: fused_edge_backward(
        edges, d_eout=d_eout, d_agg=d_agg, **det))
    suffix = "" if mode == "processor" else "_encoder"
    entry["ms" + suffix] = ms
    entry["plain_ms" + suffix] = plain_ms
    # The backward recomputes the forward (processor: 2 products, encoder:
    # 1) and takes 2 products per forward product; it reads the forward's
    # inputs and the cotangents, writes de (dgs), the node and weight grads.
    fwd_flops, fwd_bytes = _edge_cost(edges.num_edges, edges.num_senders,
                                      edges.num_receivers, C, mode)
    bound = _bound(3 * fwd_flops,
                   2 * fwd_bytes + 2 * edges.num_edges * C * 2)
    entry.update({k + suffix: v for k, v in bound.items()})
    _log("k4", t0, mode=mode, edges=edges.num_edges,
         worst_rel_rms=f"{max(rels.values()):.3g}", ms=f"{ms:.3f}",
         plain_ms=f"{plain_ms:.3f}")
    del args, leaves, got, det, d_agg, d_eout, cot
    torch.cuda.empty_cache()
  entry["max_abs_err"] = worst
  results["fused_edge_bwd"] = entry


def phase_k5(torch, art, results):
  from graphcast_tpu_torch.ops import fused_decoder
  from graphcast_tpu_torch.ops.fused_decoder import (
      KEYS, MATRICES, VECTORS, fused_decode, fused_decode_backward,
      fused_decode_reference)
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

  ms = _time_ms(torch, k5)
  # The 131,072 nodes above are one of the wrapper's node chunks; the train
  # path runs 8. The same call in uneven chunks (partial last tiles) must
  # agree to the atomics' run-to-run noise.
  one_chunk = k5()
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
       chunked_worst_rel_rms=f"{max(chunk_rels.values()):.3g}", ms=f"{ms:.3f}",
       plain_ms=f"{plain_ms:.3f}", full_grid_nodes=g,
       ms_full=f"{ms_full:.3f}")
  # The backward recomputes the forward and takes 2 products per forward
  # product; it reads the forward's inputs and dout, writes dgrid, dconst,
  # dmesh_proj and the weight grads (f32).
  fwd_flops, fwd_bytes = _decoder_cost(K5_NODES, m, C, num_out, embed=False)
  results["fused_decoder_bwd"] = _entry(
      "fused_decoder_bwd", "fused_decoder_bwd.cu",
      "graphcast_tpu/ops/pallas_decoder.py:160", launches=None,
      max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, ms_full_grid=ms_full,
      **_bound(3 * fwd_flops, 2 * fwd_bytes + 4 * K5_NODES * C * 2))
  del edges, acts, dout, det
  torch.cuda.empty_cache()


def _wgrad_split(torch, run, reps=5):
  """Device ms per call of weight_grad's two kernels, the split-K product
  and the fixed-order reduction, from torch.profiler over ``reps`` calls."""
  from torch.profiler import ProfilerActivity, profile
  run()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      run()
    torch.cuda.synchronize()
  main = reduce = 0.0
  for evt in prof.events():
    if evt.device_type != torch.autograd.DeviceType.CUDA:
      continue
    ms = evt.time_range.elapsed_us() / 1e3
    if "weight_grad_reduce" in evt.name:
      reduce += ms
    elif "weight_grad_kernel" in evt.name:
      main += ms
  return main / reps, reduce / reps


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


def _stack(torch, preset, seed, bf16=True, device=DEVICE, **ar_kw):
  from graphcast_tpu_torch.models.graphcast import GraphCast
  model = GraphCast(preset.model_config, preset.task_config,
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
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  from graphcast_tpu_torch.rollout import extend_targets_template
  preset = zoo.graphcast()
  inputs, targets, forcings = synthetic.make_example_batch(
      preset.task_config, resolution=preset.model_config.resolution,
      batch=1)
  bf16 = torch.bfloat16
  return (inputs.astype(bf16).to(DEVICE), targets.astype(bf16).to(DEVICE),
          extend_targets_template(forcings, ROLLOUT_STEPS).astype(bf16).to(
              DEVICE))


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
  # The same rollout again: K1's atomics add the sums of runs that cross a
  # tile boundary in a run-dependent order, so two runs differ this much.
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
       worst_rel_rms_vs_main=f"{worst:.3g}",
       main_rerun_worst_rel_rms=f"{_MAIN_FINAL['noise']:.3g}", finite=True)


SMALL_SEED = 3  # weights of the GraphCast_small phases


@functools.lru_cache(maxsize=None)
def _small_references(torch):
  """zoo.graphcast_small()'s batch-1 synthetic (inputs, targets, forcings)
  on the CPU and one step of the port on the CPU from them, {bf16: out}
  for f32 and bf16 (the small phase's noise floor). Built once: the
  graphcast_batch phase holds its member 0 to the same runs."""
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  preset = zoo.graphcast_small()
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
  from graphcast_tpu_torch.models import zoo
  from graphcast_tpu_torch.params import flat_params
  t0 = time.perf_counter()
  preset = zoo.graphcast_small()
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
  from graphcast_tpu_torch.ops.segment_sum import sorted_segment_sum
  from graphcast_tpu_torch.ops.splash import (
      block_sparse_attention, splash_dkv, splash_dq)
  from graphcast_tpu_torch.ops.weight_grad import feature_grad, weight_grad
  return {"fused_edge": fused_edge, "fused_decoder": fused_decode,
          "fused_edge_bwd": fused_edge_backward,
          "fused_decoder_bwd": fused_decode_backward,
          "weight_grad": weight_grad, "feature_grad": feature_grad,
          "splash_fwd": block_sparse_attention, "splash_dq": splash_dq,
          "splash_dkv": splash_dkv, "segment_sum": sorted_segment_sum}


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
  per encoder chunk (dW1), 7 times per K5 chunk."""
  from graphcast_tpu_torch.ops import fused_decoder, fused_edge
  proc = -(-art.mesh.senders.size // fused_edge.BWD_CHUNK_ROWS)
  enc = -(-art.grid2mesh.senders.size // fused_edge.BWD_CHUNK_ROWS)
  dec = -(-art.num_grid_nodes // fused_decoder.BWD_CHUNK_NODES)
  return {"fused_edge": 1 + mp_steps, "fused_decoder": 1,
          "fused_edge_bwd": mp_steps * proc + enc, "fused_decoder_bwd": dec,
          "weight_grad": 2 * mp_steps * proc + enc + 7 * dec}


def phase_train(torch, results, profile_dir=None):
  from graphcast_tpu_torch import train
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  t0 = time.perf_counter()
  preset = zoo.graphcast()
  mc = preset.model_config
  model, predictor = _stack(torch, preset, seed=0,
                            gradient_checkpointing=True)
  predictor = predictor.to(DEVICE)
  data = synthetic.make_example_batch(preset.task_config,
                                      resolution=mc.resolution, batch=1,
                                      num_target_times=1)
  data = [fs.astype(torch.bfloat16).to(DEVICE) for fs in data]
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
  for name in ("fused_edge_bwd", "fused_decoder_bwd", "weight_grad"):
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


def phase_train_small(torch):
  import dataclasses
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  t0 = time.perf_counter()
  preset = zoo.graphcast_small()
  preset = dataclasses.replace(preset, model_config=dataclasses.replace(
      preset.model_config, gnn_msg_steps=TRAIN_SMALL_MP_STEPS))
  inputs, targets, forcings = synthetic.make_example_batch(
      preset.task_config, resolution=preset.model_config.resolution,
      batch=1, num_target_times=2, device="cpu")

  def steps(n):
    return (inputs, targets.isel(time=slice(0, n)),
            forcings.isel(time=slice(0, n)))

  model, card = _stack(torch, preset, seed=6)
  card = card.to(DEVICE)
  _, card_diag, card_grads = _loss_and_grads(torch, card, model, steps(1),
                                             DEVICE)
  torch.cuda.synchronize()
  card_s = time.perf_counter() - t0
  t1 = time.perf_counter()
  cpu = {}
  for bf16 in (False, True):
    cpu_model, stack = _stack(torch, preset, seed=6, bf16=bf16,
                              device="cpu")
    cpu[bf16] = _loss_and_grads(torch, stack, cpu_model, steps(1), "cpu")
  cpu_s = time.perf_counter() - t1
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
  """K7 (dq) and K8 (dk, dv) against the plain backward on the kernel's own
  o and lse, over the real k-hop-16 masks; SDPA's backward with the dense
  boolean mask at mesh-5 as the library yardstick."""
  from graphcast_tpu_torch.ops import splash
  t0 = time.perf_counter()
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
  for mesh_size in (5, 6):
    mask, bm, _, _ = _k_hop_block_map(mesh_size)
    n = bm.n
    q, k, v, do = (_randn(torch, gen, (1, n, heads, d), 1.0, torch.bfloat16)
                   for _ in range(4))
    with torch.inference_mode():
      (qh, kh, vh), oh, lseh = splash._launch_splash(q, k, v, bm, scale)
      doh = splash._to_heads(do, bm.n_pad)
      delta = splash.attention_delta(oh, doh)
      args = (qh, kh, vh, doh, lseh, delta, bm, scale)
      dq = splash.splash_dq(*args)
      dk, dv = splash.splash_dkv(*args)
      torch.cuda.synchronize()
      o, lse = splash._outputs(oh, lseh, 1, n)
      ref = (q, k, v, o, lse, do, bm, scale)
      want_dq = splash._dq_reference(*ref)
      want_dk, want_dv = splash._dkv_reference(*ref)
      phase = f"k7k8 mesh{mesh_size}"
      errs = {"splash_dq": _check_grads(
                  phase, {"dq": splash._from_heads(dq, 1, n)},
                  {"dq": want_dq}),
              "splash_dkv": _check_grads(
                  phase, {"dk": splash._from_heads(dk, 1, n),
                          "dv": splash._from_heads(dv, 1, n)},
                  {"dk": want_dk, "dv": want_dv})}
      rels = {**errs["splash_dq"][1], **errs["splash_dkv"][1]}
      del want_dq, want_dk, want_dv, dq, dk, dv
      ms = {"splash_dq": _time_ms(torch, lambda: splash.splash_dq(*args),
                                  reps=20),
            "splash_dkv": _time_ms(torch, lambda: splash.splash_dkv(*args),
                                   reps=20)}
      plain = {"splash_dq": _time_ms(torch, lambda: splash._dq_reference(
                   *ref), reps=1),
               "splash_dkv": _time_ms(torch, lambda: splash._dkv_reference(
                   *ref), reps=1)}
    library_ms = None
    if mesh_size == 5:
      # The library yardstick: the backward of SDPA with the dense boolean
      # mask (dq, dk and dv together: K7 and K8's work).
      dense = torch.as_tensor(mask.toarray(), device=DEVICE)
      qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                    for x in (q, k, v))
      out = torch.nn.functional.scaled_dot_product_attention(
          qt, kt, vt, attn_mask=dense, scale=scale)
      dot = do.transpose(1, 2)
      library_ms = _time_ms(torch, lambda: torch.autograd.grad(
          out, (qt, kt, vt), dot, retain_graph=True), reps=3)
      del dense, qt, kt, vt, out, dot
    torch.cuda.empty_cache()
    suffix = "" if mesh_size == 5 else "_mesh6"
    # K7: S, dP and dQ per mask entry; reads q, k, v, do, lse and delta,
    # writes dq. K8: S^T, dP^T, dV and dK; writes dk and dv.
    rows = n * heads
    bounds = {"splash_dq": _bound(6 * heads * bm.nnz * d,
                                  5 * rows * d * 2 + 2 * rows * 4),
              "splash_dkv": _bound(8 * heads * bm.nnz * d,
                                   6 * rows * d * 2 + 2 * rows * 4)}
    for name, entry in entries.items():
      worst_abs[name] = max(worst_abs[name], errs[name][0])
      worst[name] = max(worst[name], *errs[name][1].values())
      entry.update({"ms" + suffix: ms[name], "plain_ms" + suffix: plain[name],
                    **{key + suffix: val for key, val in
                       bounds[name].items()}})
      if mesh_size == 5:
        entry["library_ms"] = library_ms
        entry["library_covers"] = "SDPA backward: dq, dk and dv"
    _log("k7k8", t0, mesh=mesh_size, nodes=n, mask_entries=bm.nnz,
         active_tiles=bm.n_active,
         transposed_full_tiles=int(bm.transposed.full.sum()),
         dq_rel_rms=f"{rels['dq']:.3g}", dk_rel_rms=f"{rels['dk']:.3g}",
         dv_rel_rms=f"{rels['dv']:.3g}",
         k7_max_abs=f"{errs['splash_dq'][0]:.4g}",
         k8_max_abs=f"{errs['splash_dkv'][0]:.4g}",
         k7_ms=f"{ms['splash_dq']:.3f}", k8_ms=f"{ms['splash_dkv']:.3f}",
         k7_plain_ms=f"{plain['splash_dq']:.3f}",
         k8_plain_ms=f"{plain['splash_dkv']:.3f}",
         library_ms="none" if library_ms is None else f"{library_ms:.3f}",
         k7_bound_ms=f"{bounds['splash_dq']['bound_ms']:.4f}",
         k8_bound_ms=f"{bounds['splash_dkv']['bound_ms']:.4f}")
    del q, k, v, do, qh, kh, vh, oh, lseh, doh, delta, args, ref, o, lse
    torch.cuda.empty_cache()
  for name, entry in entries.items():
    entry["max_abs_err"] = worst_abs[name]
    entry["worst_rel_rms"] = worst[name]
    results[name] = entry


@functools.lru_cache(maxsize=None)
def _gencast_artifact(resolution, mesh_size):
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.geometry import artifact as artifact_lib
  lat, lon = synthetic.grid_coords(resolution)
  return artifact_lib.build_artifact(lat, lon, mesh_size, multimesh=False,
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
      EdgeIndex, fused_edge, fused_edge_reference)
  t0 = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(9)
  C, num_out, bf16 = 512, 84, torch.bfloat16
  w = 1.0 / np.sqrt(C)
  arts = {"1p0": _gencast_artifact(1.0, 5), "0p25": art025}
  edge = _entry("fused_edge_embed", "fused_edge.cu",
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
      e_ms = _time_ms(torch, lambda: run(fused_edge))
      e_plain = _time_ms(torch, lambda: run(fused_edge_reference), reps=1)
    worst["edge"] = max(worst["edge"], e_abs)
    edge.update({"ms" + suffix: e_ms, "plain_ms" + suffix: e_plain,
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
      d_ms = _time_ms(torch, lambda: fused_decode(edges, grid, mesh_proj,
                                                  feats, weights))
      d_plain = _time_ms(torch, lambda: fused_decode_reference(
          edges, grid, mesh_proj, feats, weights), reps=1)
    worst["dec"] = max(worst["dec"], d_abs)
    dec.update({"ms" + suffix: d_ms, "plain_ms" + suffix: d_plain,
                **{k + suffix: v for k, v in _bound(*_decoder_cost(
                    g, m, C, num_out, embed=True)).items()}})
    _log("embed", t0, grid=res, g2m_edges=art.grid2mesh.senders.size,
         k1_max_shared=int(shared.max().item()),
         k1_max_abs=f"{e_abs:.4g}", k1_rel_rms=f"{e_rel:.3g}",
         k1_ms=f"{e_ms:.3f}", k1_plain_ms=f"{e_plain:.3f}",
         grid_nodes=g, k2_max_abs=f"{d_abs:.4g}", k2_rel_rms=f"{d_rel:.3g}",
         k2_ms=f"{d_ms:.3f}", k2_plain_ms=f"{d_plain:.3f}")
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
      EdgeIndex, fused_edge, fused_edge_embed_backward, fused_edge_reference)
  from graphcast_tpu_torch.ops.weight_grad import (
      feature_grad, feature_grad_reference)
  t0 = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(14)
  C, num_out, F, bf16 = 512, 84, 4, torch.bfloat16
  edge = _entry("fused_edge_bwd_embed", "fused_edge_bwd.cu",
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
    e_ms = _time_ms(torch, lambda: fused_edge_embed_backward(
        edges, det["e"], det["sproj"], det["rproj"], det["we"], det["b0"],
        det["w1"], det["b1"], det["scale"],
        tuple(v.detach() for v in embed.values()), d_agg))
    edge.update({"ms" + suffix: e_ms, **{k + suffix: v for k, v in
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
    d_ms = _time_ms(torch, lambda: fused_decode_backward(
        edges, acts["grid"], acts["mesh_proj"], acts["const"], det, dout))
    dec.update({"ms" + suffix: d_ms, **{k + suffix: v for k, v in
                _embed_bwd_bounds(g, "decoder", C, F, M=m,
                                  NO=num_out).items()}})
    _log("embed_bwd", t0, grid=res, g2m_edges=n_g2m, grid_nodes=g,
         **({"k4_worst_rel_rms": f"{max(e_rels.values()):.3g}",
             "k4_plain_ms": f"{e_plain:.3f}",
             "k5_worst_rel_rms": f"{max(d_rels.values()):.3g}",
             "k5_plain_ms": f"{d_plain:.3f}"} if res == "1p0" else {}),
         k4_ms=f"{e_ms:.3f}", k5_ms=f"{d_ms:.3f}",
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
    suffix = "" if name == "k4" else "_k5"
    fg.update({"ms" + suffix: _time_ms(torch, lambda: feature_grad(
                   x, dxe, w0, got_w)),
               "plain_ms" + suffix: _time_ms(torch, lambda: (
                   feature_grad_reference(x, dxe, w0, want_w))),
               **{k + suffix: v for k, v in _bound(
                   4 * rows * F * C,
                   rows * (C + F) * 2 + F * C * 2 + 2 * F * C * 4
                   + rows * F * 4).items()}})
    _log("embed_bwd", t0, feature_grad=name, rows=rows,
         worst_rel_rms=f"{max(f_rels.values()):.3g}",
         ms=f"{fg['ms' + suffix]:.3f}",
         plain_ms=f"{fg['plain_ms' + suffix]:.3f}",
         bound_ms=f"{fg['bound_ms' + suffix]:.4f}")
    del x, dxe, w0, got_w, want_w, got_x, want_x
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


def _gencast_stack(torch, preset, seed, device=None):
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.wrappers import InputsAndResiduals, NaNCleaner
  device = device or DEVICE
  model = preset.build(generator=torch.Generator().manual_seed(seed),
                       device=device)
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
MINI_LAYERS = 4            # their transformer depth (the preset has 16)


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
  feature pass once). Every launch of K1, K2, K4 and K5 is an embed-mode
  one."""
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
          "splash_dkv": layers.num_layers, "segment_sum": 0}


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
               "weight_grad"):
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


def phase_gencast_train_small(torch):
  from graphcast_tpu_torch import params
  t0 = time.perf_counter()
  preset = _mini_preset()
  card_model, card = _gencast_stack(torch, preset, seed=16)
  _fix_noise_draw(torch, card_model, GENCAST_TRAIN_SMALL_SIGMA, seed=17)
  data = _gencast_train_data(torch, preset, "cpu", torch.bfloat16)
  card_loss, card_diag, card_grads = _loss_and_grads(
      torch, card, card_model, data, DEVICE,
      generator=torch.Generator(device=DEVICE))
  torch.cuda.synchronize()
  card_s = time.perf_counter() - t0
  t1 = time.perf_counter()
  cpu = {}
  for bf16 in (False, True):
    cpu_model, stack = _gencast_stack(torch, preset, seed=16, device="cpu")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(
        params.flat_params(card_model).values(),
        params.flat_params(cpu_model).values())):
      raise AssertionError("CPU and card models differ in their weights")
    _fix_noise_draw(torch, cpu_model, GENCAST_TRAIN_SMALL_SIGMA, seed=17)
    data = _gencast_train_data(
        torch, preset, "cpu", torch.bfloat16 if bf16 else torch.float32)
    cpu[bf16] = _loss_and_grads(torch, stack, cpu_model, data, "cpu",
                                generator=torch.Generator())
  cpu_s = time.perf_counter() - t1
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
  expected = {"segment_sum": evals, "splash_fwd": evals * layers.num_layers,
              "fused_edge": 0, "fused_decoder": 0, "fused_edge_embed": 0,
              "fused_decoder_embed": 0}
  if any(counts[k] != n * ENSEMBLE_STEPS for k, n in expected.items()):
    raise AssertionError(f"ensemble launches {counts}, expected {expected} "
                         "per 12 h step")
  _check_fieldset(torch, "ensemble", preds, tile_batch(targets, ENSEMBLE_MEMBERS))
  t = preds.data("temperature").float()
  spread = (t[0] - t[1]).square().mean().sqrt().item()
  if not all((t[0] - t[m]).abs().max().item() > 0
             for m in range(1, ENSEMBLE_MEMBERS)):
    raise AssertionError("ensemble members are not all distinct")
  if profile_dir:
    _profile_step(torch, lambda: run(7, 1), profile_dir, "ensemble_step")
  for name in ("segment_sum", "splash_fwd"):
    results[name]["ensemble_launches"] = counts[name]
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
       member_spread_t_rms=f"{spread:.4g}", finite=True)
  del model, stack, preds
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
  if k3.launches - launches_before != len(pairs):
    raise AssertionError(f"ensemble_small: K3 launched "
                         f"{k3.launches - launches_before} times, expected "
                         f"{len(pairs)}")
  _log("ensemble_small", t0, config=_gencast_label(preset), batch=2,
       sigma_pairs=",".join(f"({a:g},{b:g})" for a, b in pairs),
       k3_launches=len(pairs), worst_err_over_bound=f"{worst:.3f}")
  del card
  torch.cuda.empty_cache()


def phase_graphcast_batch(torch, results, profile_dir=None):
  """GraphCast_small at batch BATCH (module doc): member 0 of one step
  (the small phase's inputs) against the small phase's CPU runs and a
  batch-1 card step, then the timed rollout."""
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  t0 = time.perf_counter()
  preset = zoo.graphcast_small()
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
  expected = {"segment_sum": 1 + mc.gnn_msg_steps, "fused_edge": 0,
              "fused_decoder": 0}
  if any(counts[k] != n * BATCH_STEPS for k, n in expected.items()):
    raise AssertionError(f"graphcast_batch launches {counts}, expected "
                         f"{expected} per step")
  _check_fieldset(torch, "graphcast_batch", final,
                  inputs.select(list(final.var_names)))
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
       member0_vs_cpu_over_bound=f"{worst_cpu:.3f}", finite=True)
  del card, step, single, final
  torch.cuda.empty_cache()


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
      EdgeIndex, fused_edge, fused_edge_reference)
  t0 = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(22)
  C, bf16 = 512, torch.bfloat16
  g, m = art025.num_grid_nodes, art025.num_mesh_nodes
  art1 = _gencast_artifact(1.0, 5)
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
      if mode == "processor":
        if not torch.equal(got[0], k1[0]):
          raise AssertionError("k1p processor e_out differs from K1's: "
                               f"max_abs={_errors(got[0], k1[0])[0]:.3g}")
        e_abs, e_rel = _check_close("k1p processor e_out", got[0], want[0])
        got, k1, want = got[1], k1[1], want[1]
      k1_abs, k1_rel = _errors(got, k1)
      if not k1_rel <= K1P_AGG_RTOL:
        raise AssertionError(f"k1p {mode}{suffix} agg vs K1: rel_rms="
                             f"{k1_rel:.3g} (tol {K1P_AGG_RTOL})")
      max_abs, rel_rms = _check_close(f"k1p {mode}{suffix} agg", got, want,
                                      shared=shared)
      if mode == "processor":
        max_abs = max(max_abs, e_abs)
      del got, k1, want
      # In turns (K1p, K1, K1, K1p), 10 launches each.
      turns = [_time_ms(torch, run[k], reps=10)
               for k in ("k1p", "k1", "k1", "k1p")]
      ms, k1_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
      plain_ms = _time_ms(torch, run["plain"], reps=1)
    entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0), max_abs)
    entry.update({"ms" + suffix: ms, "k1_ms" + suffix: k1_ms,
                  "plain_ms" + suffix: plain_ms,
                  "max_abs_vs_k1" + suffix: k1_abs,
                  "rel_rms_vs_k1" + suffix: k1_rel,
                  **{k + suffix: v for k, v in _bound(*_edge_cost(
                      edges.num_edges, edges.num_senders,
                      edges.num_receivers, C, mode)).items()}})
    _log("k1p", t0, mode=mode + suffix, edges=edges.num_edges,
         max_abs=f"{max_abs:.4g}", rel_rms=f"{rel_rms:.3g}",
         **({"e_out_equal_k1": True} if mode == "processor" else {}),
         agg_max_abs_vs_k1=f"{k1_abs:.3g}", agg_rel_rms_vs_k1=f"{k1_rel:.3g}",
         ms=f"{ms:.3f}", k1_ms=f"{k1_ms:.3f}", plain_ms=f"{plain_ms:.3f}",
         bound_ms=f"{entry['bound_ms' + suffix]:.4f}",
         turns_ms="/".join(f"{t:.3f}" for t in turns))
    del args, run
    torch.cuda.empty_cache()

  # K4 behind each forward, processor mode on the mesh-6 set, the same
  # seeded cotangents: under grad the forward is K1p or K1, the backward K4,
  # whose f32 atomics add in a run-dependent order: K1's path twice gives
  # the noise that K1p's may differ by.
  edges = cases[0][2]
  args = _edge_case(torch, gen, edges, C, encoder=False)
  args["we"] = args["we"].to(bf16)
  cot = (_randn(torch, gen, (edges.num_edges, C), 1.0, bf16),
         _randn(torch, gen, (edges.num_receivers, C)))
  grads = {}
  for run_name, pipelined in (("k1", False), ("k1_again", False),
                              ("k1p", True)):
    leaves = {k: v.detach().clone().requires_grad_() for k, v in args.items()}
    grads[run_name], _ = _autograd(
        torch, lambda **kw: fused_edge(edges, write_edges=True,
                                       pipelined=pipelined, **kw),
        leaves, cot, list(leaves))
  torch.cuda.synchronize()
  worst = 0.0
  for name, want in grads["k1"].items():
    noise = _rms(torch, grads["k1_again"][name] - want)
    err = _rms(torch, grads["k1p"][name] - want)
    bound = 2 * noise + K1P_GRAD_RTOL * _rms(torch, want)
    if not (np.isfinite(err) and err <= bound):
      raise AssertionError(f"k1p: grad {name} behind K1p vs behind K1 "
                           f"{err:.4g} > 2*noise+eps={bound:.4g}")
    worst = max(worst, err / bound)
  _log("k1p", t0, k4_behind_k1p="processor",
       worst_grad_err_over_bound=f"{worst:.3f}")
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


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--phases", default=",".join(PHASES),
                      help="comma-separated subset of " + ",".join(PHASES))
  parser.add_argument("--profile", metavar="DIR",
                      help="also profile one main-path step, one train step, "
                           "one GenCast step, one GenCast train step, one "
                           "ensemble chunk and one batch-4 GraphCast step "
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
  torch.backends.cuda.matmul.allow_tf32 = False  # twins in true f32
  torch.backends.cudnn.allow_tf32 = False
  import graphcast_tpu_torch  # noqa: F401  (fails outside the repository)

  t_start = time.perf_counter()
  card = phase_build(torch)
  results = {}
  if {"k1", "k2", "k4", "k5", "embed", "embed_bwd", "k3", "main",
      "k1p"} & set(phases):
    t0 = time.perf_counter()
    art = _geometry(0.25, 6)
    _log("geometry", t0, grid_nodes=art.num_grid_nodes,
         mesh_nodes=art.num_mesh_nodes,
         g2m_edges=art.grid2mesh.senders.size,
         mesh_edges=art.mesh.senders.size,
         m2g_edges=art.mesh2grid.senders.size)
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
                 "fused_decoder_bwd_embed", "weight_grad", "feature_grad"):
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
  sys.exit(main())
