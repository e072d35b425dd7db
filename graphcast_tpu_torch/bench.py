"""Benchmark of the PyTorch port on one GPU: the mirror of the repository's
``bench.py``, with its three paths, its ``BENCH_*`` knobs and its metric
names.

Usage: python3 -m graphcast_tpu_torch.bench

- North star (default; ``bench.py:_bench_north_star``): GraphCast 0.25°,
  37 levels, mesh-6, latent 512, 16 message-passing steps, random weights,
  ``Autoregressive(InputsAndResiduals(Bfloat16Cast(GraphCast)))
  .rollout_final`` over ``BENCH_NUM_STEPS`` (40) six-hour steps from a bf16
  state. Unchunked: the card holds 0.25° inference whole. Knobs
  ``BENCH_RESOLUTION``, ``BENCH_MESH_SIZE``, ``BENCH_LATENT``,
  ``BENCH_MSG_STEPS``, ``BENCH_FUSED`` (as ``fused_aggregation``).
- Fallback (``_bench_fallback``): GraphCast 1.0°, 13 levels, mesh-5, latent
  512, the full trajectory of ``BENCH_NUM_STEPS`` steps. Only with
  ``BENCH_FALLBACK_ONLY=1``.
- GenCast (``_bench_gencast``): one 12 h step of the released GenCast
  architecture at ``BENCH_GENCAST_RESOLUTION`` (1.0) / mesh
  ``BENCH_GENCAST_MESH_SIZE`` (5), one member, bf16 state. Runs first unless
  ``BENCH_SKIP_GENCAST=1``; ``BENCH_GENCAST=1`` makes it the printed
  result. The metric keeps bench.py's name, ``..._40evals``: the port's
  sampler runs 39 denoiser evaluations a step (it skips the JAX loop's
  discarded σ = 0 midpoint), which a line on stderr says.

Each path: one warm-up call (it builds the graph and its statics), then the
minimum of 3 calls, each ending in ``torch.cuda.synchronize()`` and a scalar
``.item()``. ``GC_PIPELINED_EDGE=1`` runs the edge steps through K1p instead
of K1 (ops/fused_edge.py).

Unlike bench.py it does not fall back to 1.0° when the north star fails,
does not catch a GenCast failure (an exception ends the run with a non-zero
exit), prints no ``vs_baseline`` (bench.py's baselines are TPU figures) and
writes no file. The result line is ``{"metric", "value", "unit", "card",
"power_limit"}``: the card's name and power limit as nvidia-smi reports
them ("cpu" and null on the CPU, which the functions take only when a
caller asks with ``device="cpu"``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from graphcast_tpu_torch import devices
from graphcast_tpu_torch.env_flags import env_flag

NUM_RUNS = 3


def _build(resolution, mesh_size, latent, msg_steps, task, decode_chunks,
           encode_chunks, device):
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import configs
  from graphcast_tpu_torch.models.graphcast import GraphCast
  from graphcast_tpu_torch.wrappers import (
      Autoregressive, Bfloat16Cast, InputsAndResiduals)

  model = configs.ModelConfig(
      resolution=resolution, mesh_size=mesh_size, latent_size=latent,
      gnn_msg_steps=msg_steps, hidden_layers=1,
      radius_query_fraction_edge_length=0.6)
  fused = os.environ.get("BENCH_FUSED")
  fused = None if fused is None else bool(int(fused))
  stddev, mean, diffs = synthetic.make_norm_stats(task, device=device)
  return Autoregressive(
      InputsAndResiduals(
          Bfloat16Cast(GraphCast(model, task, decode_chunks=decode_chunks,
                                 encode_chunks=encode_chunks,
                                 fused_aggregation=fused,
                                 generator=torch.Generator().manual_seed(0),
                                 device=device)),
          stddev_by_level=stddev, mean_by_level=mean,
          diffs_stddev_by_level=diffs),
      gradient_checkpointing=False)


def _timed(fn, device):
  """(seconds of the warm-up call, minimum seconds of NUM_RUNS calls):
  ``fn(i)`` returns a scalar tensor; each call ends in a synchronize and its
  ``.item()``, which must be finite."""
  def call(i):
    t0 = time.perf_counter()
    v = fn(i)
    if device.type == "cuda":
      torch.cuda.synchronize(device)
    v = v.item()
    if not np.isfinite(v):
      raise AssertionError(f"non-finite benchmark output {v}")
    return time.perf_counter() - t0

  first = call(0)
  return first, min(call(i + 1) for i in range(NUM_RUNS))


def _bench_north_star(num_steps, device="cuda"):
  """0.25°/37-level final-state rollout, bf16 device state."""
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import configs
  from graphcast_tpu_torch.rollout import extend_targets_template

  device = devices.resolve(device)
  resolution = float(os.environ.get("BENCH_RESOLUTION", "0.25"))
  mesh_size = int(os.environ.get("BENCH_MESH_SIZE", "6"))
  latent = int(os.environ.get("BENCH_LATENT", "512"))
  msg_steps = int(os.environ.get("BENCH_MSG_STEPS", "16"))
  task = configs.TASK  # 37 levels

  predictor = _build(resolution, mesh_size, latent, msg_steps, task,
                     decode_chunks=1, encode_chunks=1, device=device)
  inputs, targets, forcings = synthetic.make_example_batch(
      task, resolution=resolution, batch=1, num_target_times=1,
      device=device)
  inputs = inputs.astype(torch.bfloat16)
  targets1 = targets.astype(torch.bfloat16)
  forcings_n = extend_targets_template(forcings, num_steps).astype(
      torch.bfloat16)

  def rollout_final(_):
    final = predictor.rollout_final(inputs, targets1, forcings_n)
    return final.data("temperature").float().mean()

  compile_s, steady = _timed(rollout_final, device)
  metric = (f"graphcast_{resolution}deg_37lev_mesh{mesh_size}_"
            f"{num_steps}step_rollout")
  return metric, steady, compile_s


def _bench_fallback(num_steps, device="cuda"):
  """1.0°/13-level full-trajectory rollout."""
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import configs
  from graphcast_tpu_torch.rollout import extend_targets_template

  device = devices.resolve(device)
  task = configs.TASK_13
  predictor = _build(1.0, 5, 512, 16, task, 1, 1, device)
  inputs, targets, forcings = synthetic.make_example_batch(
      task, resolution=1.0, batch=1, num_target_times=2, device=device)
  targets = extend_targets_template(targets, num_steps)
  forcings_n = extend_targets_template(forcings, num_steps)

  def rollout(_):
    preds = predictor(inputs, targets, forcings_n)
    return preds.data("temperature").float().mean()

  compile_s, steady = _timed(rollout, device)
  return (f"graphcast_1.0deg_13lev_mesh5_{num_steps}step_rollout", steady,
          compile_s)


def _bench_gencast(device="cuda"):
  """One GenCast 12 h forecast step (20 noise levels; 39 denoiser
  evaluations in the port) at 1.0°/mesh-5 with the block-sparse attention
  processor, one member, one card."""
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import gencast, zoo
  from graphcast_tpu_torch.wrappers import InputsAndResiduals, NaNCleaner

  device = devices.resolve(device)
  resolution = float(os.environ.get("BENCH_GENCAST_RESOLUTION", "1.0"))
  mesh_size = int(os.environ.get("BENCH_GENCAST_MESH_SIZE", "5"))
  task = gencast.TASK
  # The released GenCast architecture, from the single source of truth.
  predictor = zoo.gencast_custom(resolution, mesh_size).build(
      generator=torch.Generator().manual_seed(0), device=device)
  stddev, mean, diffs = synthetic.make_norm_stats(task, device=device)
  predictor = NaNCleaner(
      InputsAndResiduals(predictor, stddev_by_level=stddev,
                         mean_by_level=mean, diffs_stddev_by_level=diffs),
      var_to_clean="sea_surface_temperature", fill_value=0.0)
  inputs, targets, forcings = (
      fs.astype(torch.bfloat16) for fs in synthetic.make_example_batch(
          task, resolution=resolution, batch=1, num_target_times=1,
          time_step_hours=12, device=device))

  def sample_step(i):
    with torch.inference_mode():
      preds = predictor(inputs, targets, forcings,
                        generator=torch.Generator(device).manual_seed(i))
    return preds.data("temperature").float().mean()

  compile_s, steady = _timed(sample_step, device)
  metric = (f"gencast_{resolution}deg_mesh{mesh_size}_splash_12h_step"
            "_40evals")
  return metric, steady, compile_s


def card_info(device) -> tuple[str, str | None]:
  """(name, power limit) of the card as nvidia-smi reports them; ("cpu",
  None) on the CPU."""
  device = devices.resolve(device)
  if device.type != "cuda":
    return "cpu", None
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
       f"--id={device.index or 0}"],
      capture_output=True, text=True, check=True)
  name, limit = (part.strip()
                 for part in smi.stdout.strip().splitlines()[0].split(","))
  return name, limit


def _line(metric, seconds, card):
  return {"metric": metric, "value": seconds, "unit": "s",
          "card": card[0], "power_limit": card[1]}


def main(device="cuda") -> dict:
  """Runs the paths the knobs select (module doc), prints the result line
  and returns it."""
  num_steps = int(os.environ.get("BENCH_NUM_STEPS", "40"))
  card = card_info(device)
  if env_flag("BENCH_GENCAST") and env_flag("BENCH_SKIP_GENCAST"):
    raise SystemExit("BENCH_GENCAST=1 asks for the GenCast result, "
                     "BENCH_SKIP_GENCAST=1 skips it")
  if not env_flag("BENCH_SKIP_GENCAST"):
    metric, steady, compile_s = _bench_gencast(device)
    gencast_line = _line(metric, steady, card)
    print(f"# gencast: {json.dumps(gencast_line)} compile={compile_s:.1f}s "
          "(39 denoiser evaluations per 12 h step in the port; the name "
          "keeps bench.py's 40evals)", file=sys.stderr)
    if env_flag("BENCH_GENCAST"):
      print(json.dumps(gencast_line))
      return gencast_line

  if env_flag("BENCH_FALLBACK_ONLY"):
    metric, steady, compile_s = _bench_fallback(num_steps, device)
  else:
    metric, steady, compile_s = _bench_north_star(num_steps, device)
  result = _line(metric, steady, card)
  print(json.dumps(result))
  print(f"# compile+first={compile_s:.1f}s steady={steady:.3f}s "
        f"card={card[0]!r} power_limit={card[1]!r}",
        file=sys.stderr)
  return result


if __name__ == "__main__":
  main()
