"""Drives the PyTorch port of GraphCast (graphcast_tpu_torch) on one GPU.

Usage: python3 chip_smoke.py            (all phases; needs one CUDA device)
       python3 chip_smoke.py --phases build,k1,k2   (a subset, for debugging)
       python3 chip_smoke.py --profile DIR  (also profile one rollout step and
                                             one train step)

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
         train step gives it.
  train  the training slice: train.make_train_step over Autoregressive(
         InputsAndResiduals(Bfloat16Cast(GraphCast)), gradient_checkpointing
         =True) at zoo.graphcast(), graphcast_optimizer(peak_lr=1e-3), AR-1,
         batch 1, bf16; one warm-up and 3 timed steps: s/step, peak memory,
         the 4 losses; checks finite losses, changed parameters and the
         kernel launches per step that the model's graph implies (K1 17,
         K2 1; K4 once per row chunk of each of its 17 calls, K5 once per
         node chunk, the weight-gradient reduction once per matrix
         gradient per chunk).
  train_small  zoo.graphcast_small() (message-passing steps cut to
         TRAIN_SMALL_MP_STEPS, for the CPU side's sake) AR-1 loss and every
         parameter gradient on the card against the CPU port, with the
         small phase's noise-floor rule per variable and per parameter; then
         on the card, AR-2 with gradient_checkpointing on against off.

Kernel-vs-twin tolerances (both sides round at the same points and differ
only in f32 summation order, which flips an occasional bf16 rounding):
relative RMS error <= 1e-2 and max-abs error <= 0.125 on outputs of
magnitude up to ~8 (a few bf16 ulps there). Backward kernels: relative RMS
<= 1e-2 per gradient (the kernels round the cotangents to bf16 where the
TPU backward does, autograd of the twin where the twin's casts are).
Weight-gradient reduction: relative RMS <= 1e-4 (the same exact bf16
products summed in f32, in another order).

Any failed phase exits non-zero. On success the last lines are the total
seconds, the card's name and power limit, a JSON line describing each
kernel, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
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
DEVICE = "cuda"
PHASES = ("build", "k1", "k2", "k4", "k5", "wgrad", "main", "small",
          "train", "train_small")


def _log(phase, t0, **fields):
  parts = " ".join(f"{k}={v}" for k, v in fields.items())
  print(f"[{phase}] {time.perf_counter() - t0:.1f}s {parts}", flush=True)


def _errors(got, want):
  d = got.float() - want.float()
  rms_ref = want.float().square().mean().sqrt().item()
  return (d.abs().max().item(),
          d.square().mean().sqrt().item() / max(rms_ref, 1e-30))


def _check_close(name, got, want):
  max_abs, rel_rms = _errors(got, want)
  if not (np.isfinite(max_abs) and max_abs <= KERNEL_ATOL
          and rel_rms <= KERNEL_RTOL):
    raise AssertionError(
        f"{name}: kernel vs twin max_abs={max_abs:.3g} (tol {KERNEL_ATOL}) "
        f"rel_rms={rel_rms:.3g} (tol {KERNEL_RTOL})")
  return max_abs, rel_rms


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
  entry = {"name": "fused_edge", "route": "cuda",
           "source": "graphcast_tpu_torch/csrc/fused_edge.cu",
           "replaces": "graphcast_tpu/ops/pallas_edge.py:116"}
  worst = 0.0
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
        worst = max(worst, errs[name][0])
      ms = _time_ms(torch, lambda: fused_edge(edges, write_edges=write,
                                              **args))
      plain_ms = _time_ms(torch, lambda: fused_edge_reference(
          edges, write_edges=write, **args))
    suffix = "" if mode == "processor" else "_encoder"
    entry["ms" + suffix] = ms
    entry["plain_ms" + suffix] = plain_ms
    _log("k1", t0, mode=mode, edges=edges.num_edges,
         **{f"{n}_max_abs": f"{e[0]:.4g}" for n, e in errs.items()},
         **{f"{n}_rel_rms": f"{e[1]:.3g}" for n, e in errs.items()},
         ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}")
    del args, got, want
    torch.cuda.empty_cache()
  entry["max_abs_err"] = worst
  results["fused_edge"] = entry


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
  _log("k2", t0, grid_nodes=g, outputs=num_out, max_abs=f"{max_abs:.4g}",
       rel_rms=f"{rel_rms:.3g}", ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}")
  results["fused_decoder"] = {
      "name": "fused_decoder", "route": "cuda",
      "source": "graphcast_tpu_torch/csrc/fused_decoder.cu",
      "replaces": "graphcast_tpu/ops/pallas_decoder.py:76",
      "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}
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
  entry = {"name": "fused_edge_bwd", "route": "cuda",
           "source": "graphcast_tpu_torch/csrc/fused_edge_bwd.cu",
           "replaces": "graphcast_tpu/ops/pallas_edge.py:299"}
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
  results["fused_decoder_bwd"] = {
      "name": "fused_decoder_bwd", "route": "cuda",
      "source": "graphcast_tpu_torch/csrc/fused_decoder_bwd.cu",
      "replaces": "graphcast_tpu/ops/pallas_decoder.py:160",
      "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
      "ms_full_grid": ms_full}
  del edges, acts, dout, det
  torch.cuda.empty_cache()


def phase_wgrad(torch, results):
  from graphcast_tpu_torch.ops import fused_decoder, fused_edge
  from graphcast_tpu_torch.ops.weight_grad import (
      weight_grad, weight_grad_reference)
  t0 = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(7)
  C, bf16 = 512, torch.bfloat16
  # (rows, K, N) of the train step's reductions: a K4 row chunk (dW1, dWe),
  # a K5 node chunk's edge rows (w1) and its output layer (wd1, 227
  # outputs padded to 256).
  cases = {"k4_chunk": (fused_edge.BWD_CHUNK_ROWS, C, C),
           "k5_w1": (3 * fused_decoder.BWD_CHUNK_NODES, C, C),
           "k5_wd1": (fused_decoder.BWD_CHUNK_NODES, C, 256)}
  entry = {"name": "weight_grad", "route": "cuda",
           "source": "graphcast_tpu_torch/csrc/weight_grad.cu",
           "replaces": "graphcast_tpu/ops/pallas_edge.py:299",
           "also_replaces": "graphcast_tpu/ops/pallas_decoder.py:160"}
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
    ms = _time_ms(torch, lambda: weight_grad(a, b, got))
    plain_ms = _time_ms(torch, lambda: weight_grad_reference(a, b, want))
    suffix = "" if name == "k4_chunk" else "_" + name
    entry["ms" + suffix] = ms
    entry["plain_ms" + suffix] = plain_ms
    _log("wgrad", t0, case=name, rows=rows, k=k, n=n,
         max_abs=f"{max_abs:.4g}", rel_rms=f"{rels['dw']:.3g}",
         ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}")
    del a, b, got, want
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


def _stack(torch, preset, seed, bf16=True, **ar_kw):
  from graphcast_tpu_torch.models.graphcast import GraphCast
  model = GraphCast(preset.model_config, preset.task_config,
                    generator=torch.Generator().manual_seed(seed))
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


def phase_main(torch, results, profile_dir=None):
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  from graphcast_tpu_torch.ops.fused_decoder import fused_decode
  from graphcast_tpu_torch.ops.fused_edge import fused_edge
  from graphcast_tpu_torch.rollout import extend_targets_template
  t0 = time.perf_counter()
  preset = zoo.graphcast()
  mc = preset.model_config
  _, predictor = _stack(torch, preset, seed=0)
  predictor = predictor.to(DEVICE)
  inputs, targets, forcings = synthetic.make_example_batch(
      preset.task_config, resolution=mc.resolution, batch=1)
  bf16 = torch.bfloat16
  inputs = inputs.astype(bf16).to(DEVICE)
  targets1 = targets.astype(bf16).to(DEVICE)
  forcings_n = extend_targets_template(forcings, ROLLOUT_STEPS).astype(
      bf16).to(DEVICE)
  setup_s = time.perf_counter() - t0
  # Warm-up: one step builds the graph (host) and its device statics.
  t1 = time.perf_counter()
  predictor.rollout_final(inputs, targets1,
                          forcings_n.isel(time=slice(0, 1)))
  torch.cuda.synchronize()
  warm_s = time.perf_counter() - t1

  torch.cuda.reset_peak_memory_stats()
  fused_edge.launches = 0
  fused_decode.launches = 0
  t2 = time.perf_counter()
  final = predictor.rollout_final(inputs, targets1, forcings_n)
  torch.cuda.synchronize()
  rollout_s = time.perf_counter() - t2
  k1, k2 = fused_edge.launches, fused_decode.launches
  peak_gb = torch.cuda.max_memory_allocated() / 1e9

  steps_per = 1 + mc.gnn_msg_steps
  if k1 != steps_per * ROLLOUT_STEPS or k2 != ROLLOUT_STEPS:
    raise AssertionError(f"launch counts K1={k1} K2={k2}, expected "
                         f"{steps_per * ROLLOUT_STEPS} and {ROLLOUT_STEPS}")
  for name in final.var_names:
    f = final[name]
    if f.shape != inputs[name].shape:
      raise AssertionError(f"{name}: shape {f.shape} != {inputs[name].shape}")
    if not torch.isfinite(f.data.float()).all():
      raise AssertionError(f"{name}: non-finite values in the final state")
  if profile_dir:
    _profile_step(torch, lambda: predictor.rollout_final(
        inputs, targets1, forcings_n.isel(time=slice(0, 1))), profile_dir)
  results["fused_edge"]["launches"] = k1
  results["fused_decoder"]["launches"] = k2
  _log("main", t0, config=_label(preset),
       steps=ROLLOUT_STEPS, setup_s=f"{setup_s:.1f}",
       warmup_1step_s=f"{warm_s:.2f}", rollout_s=f"{rollout_s:.3f}",
       s_per_step=f"{rollout_s / ROLLOUT_STEPS:.4f}",
       peak_mem_gb=f"{peak_gb:.2f}", k1_launches=k1, k2_launches=k2,
       finite=True)


def phase_small(torch):
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  from graphcast_tpu_torch.params import flat_params
  t0 = time.perf_counter()
  preset = zoo.graphcast_small()
  inputs, targets, forcings = synthetic.make_example_batch(
      preset.task_config, resolution=preset.model_config.resolution, batch=1)
  model, card = _stack(torch, preset, seed=3)
  card = card.to(DEVICE)
  with torch.inference_mode():
    out_card = card(inputs.to(DEVICE), targets.to(DEVICE),
                    forcings.to(DEVICE))
  torch.cuda.synchronize()
  card_s = time.perf_counter() - t0
  outs = {}
  for bf16 in (False, True):
    cpu_model, cpu = _stack(torch, preset, seed=3, bf16=bf16)
    same = all(torch.equal(a, b.cpu()) for a, b in zip(
        flat_params(cpu_model).values(), flat_params(model).values()))
    if not same:
      raise AssertionError("CPU and card models differ in their weights")
    with torch.inference_mode():
      outs[bf16] = cpu(inputs, targets, forcings)
  worst = 0.0
  for name in targets.var_names:
    f32 = outs[False].data(name).double()
    floor = (outs[True].data(name).double() - f32).square().mean().sqrt()
    err = (out_card.data(name).cpu().double() - f32).square().mean().sqrt()
    bound = 2 * floor + SMALL_EPS * f32.square().mean().sqrt()
    if not (torch.isfinite(err) and err <= bound):
      raise AssertionError(f"small {name}: rms(card-f32)={err:.4g} > "
                           f"2*floor+eps={bound:.4g}")
    worst = max(worst, float(err / bound))
  _log("small", t0, config=_label(preset),
       card_s=f"{card_s:.1f}", worst_err_over_bound=f"{worst:.3f}")


def _counters():
  from graphcast_tpu_torch.ops.fused_decoder import (
      fused_decode, fused_decode_backward)
  from graphcast_tpu_torch.ops.fused_edge import (
      fused_edge, fused_edge_backward)
  from graphcast_tpu_torch.ops.weight_grad import weight_grad
  return {"fused_edge": fused_edge, "fused_decoder": fused_decode,
          "fused_edge_bwd": fused_edge_backward,
          "fused_decoder_bwd": fused_decode_backward,
          "weight_grad": weight_grad}


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

  counters = _counters()
  torch.cuda.reset_peak_memory_stats()
  for fn in counters.values():
    fn.launches = 0
  t2 = time.perf_counter()
  for _ in range(TRAIN_STEPS):
    losses.append(step(*data)[0])
  torch.cuda.synchronize()
  train_s = time.perf_counter() - t2
  counts = {k: fn.launches for k, fn in counters.items()}
  peak_gb = torch.cuda.max_memory_allocated() / 1e9

  expected = _train_launches_per_step(model._artifact, mc.gnn_msg_steps)
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
    results[name]["launches"] = counts[name]
  _log("train", t0, config=_label(preset) + "/AR1", steps=TRAIN_STEPS,
       setup_s=f"{setup_s:.1f}", warmup_step_s=f"{warm_s:.2f}",
       s_per_step=f"{train_s / TRAIN_STEPS:.4f}",
       peak_mem_gb=f"{peak_gb:.2f}",
       losses="[" + ",".join(f"{v:.6g}" for v in losses) + "]",
       **{f"{k}_per_step": counts[k] // TRAIN_STEPS for k in expected},
       finite=True, params_changed=True)
  del model, predictor, step, data
  torch.cuda.empty_cache()


def _loss_and_grads(torch, stack, model, data, device):
  """AR loss, per-variable losses and every parameter gradient (f32, CPU;
  zeros for a parameter the loss does not reach)."""
  from graphcast_tpu_torch.params import flat_params
  model.zero_grad(set_to_none=True)
  loss, diagnostics = stack.loss(*(fs.to(device) for fs in data))
  loss = loss.mean()
  loss.backward()
  grads = {k: torch.zeros(p.shape) if p.grad is None
           else p.grad.detach().float().cpu()
           for k, p in flat_params(model).items()}
  diag = {k: v.detach().mean().double().cpu() for k, v in diagnostics.items()}
  return loss.detach().double().cpu(), diag, grads


def _rms(torch, x):
  return x.double().square().mean().sqrt().item()


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
      batch=1, num_target_times=2)

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
    cpu_model, stack = _stack(torch, preset, seed=6, bf16=bf16)
    cpu[bf16] = _loss_and_grads(torch, stack, cpu_model, steps(1), "cpu")
  cpu_s = time.perf_counter() - t1
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
      raise AssertionError(f"train_small {name}: rms(card-f32)={err:.4g} > "
                           f"2*floor+eps={bound:.4g}")
    kind = name.split()[0]
    worst[kind] = max(worst.get(kind, 0.0), err / bound if bound else 0.0)

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


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--phases", default=",".join(PHASES),
                      help="comma-separated subset of " + ",".join(PHASES))
  parser.add_argument("--profile", metavar="DIR",
                      help="also profile one main-path step and one train "
                           "step (torch.profiler) and write their kernel "
                           "tables and traces to DIR")
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
  if {"k1", "k2", "k4", "k5", "main"} & set(phases):
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
  if "main" in phases:
    results.setdefault("fused_edge", {"name": "fused_edge"})
    results.setdefault("fused_decoder", {"name": "fused_decoder"})
    phase_main(torch, results, args.profile)
  if "small" in phases:
    phase_small(torch)
  if "train" in phases:
    phase_train(torch, results, args.profile)
  if "train_small" in phases:
    phase_train_small(torch)
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
