"""Drives the PyTorch port of GraphCast (graphcast_tpu_torch) on one GPU.

Usage: python3 chip_smoke.py            (all phases; needs one CUDA device)
       python3 chip_smoke.py --phases build,k1,k2   (a subset, for debugging)

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

Kernel-vs-twin tolerances (both sides round at the same points and differ
only in f32 summation order, which flips an occasional bf16 rounding):
relative RMS error <= 1e-2 and max-abs error <= 0.125 on outputs of
magnitude up to ~8 (a few bf16 ulps there).

Any failed phase exits non-zero. On success the last three lines are the
card's name and power limit, a JSON line describing each kernel, and
{"ok": true, "device": {...}}.
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
SMALL_EPS = 1e-4        # noise-floor slack, relative to rms(cpu f32)
ROLLOUT_STEPS = 4
DEVICE = "cuda"
PHASES = ("build", "k1", "k2", "main", "small")


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


def _label(preset):
  mc = preset.model_config
  return (f"{preset.name}:{mc.resolution}deg/"
          f"{len(preset.task_config.pressure_levels)}lev/mesh{mc.mesh_size}/"
          f"latent{mc.latent_size}/{mc.gnn_msg_steps}mp")


def _stack(torch, preset, seed, bf16=True):
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models.graphcast import GraphCast
  from graphcast_tpu_torch.wrappers import (
      Autoregressive, Bfloat16Cast, InputsAndResiduals)
  stddev, mean, diffs = synthetic.make_norm_stats(preset.task_config)
  model = GraphCast(preset.model_config, preset.task_config,
                    generator=torch.Generator().manual_seed(seed))
  return model, Autoregressive(InputsAndResiduals(
      Bfloat16Cast(model, enabled=bf16), stddev_by_level=stddev,
      mean_by_level=mean, diffs_stddev_by_level=diffs))


def _profile_step(torch, run, out_dir):
  """One profiled call of ``run``: writes the kernel-time table and chrome
  trace to ``out_dir`` and prints device busy time and idle share."""
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
  prof.export_chrome_trace(str(out / "main_step_trace.json"))
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
  with open(out / "main_step_kernels.txt", "w") as f:
    f.write(f"wall_ms {wall_ms:.3f} device_busy_ms {busy_us / 1e3:.3f}\n")
    for name, ms in top:
      f.write(f"{ms:10.3f} ms  {name}\n")
  _log("profile", time.perf_counter(), wall_ms=f"{wall_ms:.2f}",
       device_busy_ms=f"{busy_us / 1e3:.2f}",
       idle_share=f"{1 - busy_us / 1e3 / wall_ms:.3f}",
       device_events=len(spans), table=str(out / "main_step_kernels.txt"))
  for name, ms in top[:12]:
    print(f"[profile] {ms:9.3f} ms  {name[:110]}", flush=True)


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


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--phases", default=",".join(PHASES),
                      help="comma-separated subset of " + ",".join(PHASES))
  parser.add_argument("--profile", metavar="DIR",
                      help="also profile one main-path step (torch.profiler)"
                           " and write its kernel table and trace to DIR")
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

  card = phase_build(torch)
  results = {}
  if "k1" in phases or "k2" in phases or "main" in phases:
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
  if "main" in phases:
    results.setdefault("fused_edge", {"name": "fused_edge"})
    results.setdefault("fused_decoder", {"name": "fused_decoder"})
    phase_main(torch, results, args.profile)
  if "small" in phases:
    phase_small(torch)
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
