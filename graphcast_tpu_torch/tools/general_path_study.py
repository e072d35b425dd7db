"""Times the general path (batch > 1) of two checkouts of the port in turns,
on one card: what its fixed-order sums cost.

Usage: python3 graphcast_tpu_torch/tools/general_path_study.py A B [B A]

Each argument is the root of a checkout; each runs in a process of its own
(this file is run by path, and imports the package from that checkout), in
the order given, so that ``A B B A`` times two versions in turns. A process
measures, with weights and data from fixed seeds, bf16:

- GraphCast_small (1.0°, 13 levels, mesh-5, latent 512, 16 steps) at batch
  4: s per rollout step (``rollout_final`` over 2 steps) and s per AR-1
  loss-and-backward step (``gradient_checkpointing=True``), the peak GB of
  each;
- the 4-member GenCast 1p0deg ensemble: s per 12 h step of
  ``rollout.chunked_ensemble_prediction``, peak GB, and the spread of a
  rerun from the same seed (the worst relative RMS of a variable; 0 when
  every sum runs in a fixed order);
- zoo.gencast_0p25deg() in the chunked unfused form (32 encoder and
  decoder chunks) at 8 members: s per preconditioned denoiser evaluation
  at the first noise level, peak GB.

Each after a warm-up call: the peak of one call from an emptied cache,
then the least seconds of 3 calls.

Prints one JSON line per process and, last, a JSON line with all of them
and the card's name and power limit. Imports nothing from the package at
module level (a checkout without this file runs it too).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

BATCH = 4
MEMBERS = 4
MEMBERS_0P25 = 8


def _timed(torch, fn):
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  out = fn()
  torch.cuda.synchronize()
  return time.perf_counter() - t0, out


def _peak(torch, fn, reps=3):
  """(seconds, peak GB, result): the peak of one ``fn()`` after the cache
  is emptied and the peak reset, then the least seconds of ``reps`` more
  calls on the warm allocator."""
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  _, out = _timed(torch, fn)
  peak = torch.cuda.max_memory_allocated() / 1e9
  seconds = min(_timed(torch, fn)[0] for _ in range(reps))
  return seconds, peak, out


def _graphcast_small(torch, out):
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  from graphcast_tpu_torch.models.graphcast import GraphCast
  from graphcast_tpu_torch.wrappers import (
      Autoregressive, Bfloat16Cast, InputsAndResiduals)
  preset = zoo.graphcast_small()
  model = GraphCast(preset.model_config, preset.task_config,
                    generator=torch.Generator().manual_seed(0), device="cuda")
  stack = Autoregressive(InputsAndResiduals(
      Bfloat16Cast(model), *synthetic.make_norm_stats(
          preset.task_config, device="cuda")), gradient_checkpointing=True)
  inputs, targets, forcings = (
      fs.astype(torch.bfloat16) for fs in synthetic.make_example_batch(
          preset.task_config, preset.model_config.resolution, batch=BATCH,
          num_target_times=2, device="cuda"))
  one = slice(0, 1)

  def rollout():
    with torch.inference_mode():
      return stack.rollout_final(inputs, targets.isel(time=one), forcings)

  def train():
    model.zero_grad(set_to_none=True)
    stack.loss(inputs, targets.isel(time=one),
               forcings.isel(time=one))[0].mean().backward()

  rollout()
  seconds, peak, _ = _peak(torch, rollout)
  out["graphcast_small_b4_s_per_step"] = seconds / 2
  out["graphcast_small_b4_peak_gb"] = peak
  train()
  seconds, peak, _ = _peak(torch, train)
  out["graphcast_small_b4_train_s"] = seconds
  out["graphcast_small_b4_train_peak_gb"] = peak


def _ensemble(torch, out):
  from graphcast_tpu_torch import rollout
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  from graphcast_tpu_torch.wrappers import InputsAndResiduals, NaNCleaner
  preset = zoo.gencast_1p0deg()
  model = preset.build(generator=torch.Generator().manual_seed(0),
                       device="cuda")
  stack = NaNCleaner(InputsAndResiduals(model, *synthetic.make_norm_stats(
      preset.task_config, device="cuda")),
                     var_to_clean="sea_surface_temperature", fill_value=0.0)
  data = [fs.astype(torch.bfloat16) for fs in synthetic.make_example_batch(
      preset.task_config, preset.resolution, batch=1, num_target_times=1,
      time_step_hours=12, device="cuda")]

  def run():
    with torch.inference_mode():
      return rollout.chunked_ensemble_prediction(
          stack, torch.Generator(device="cuda").manual_seed(1), *data,
          num_samples=MEMBERS, pull_to_host=False)

  run()
  seconds, peak, first = _peak(torch, run)
  again = run()  # the same seed as ``first``
  spread = 0.0
  for name in first.var_names:
    a, b = again.data(name).float(), first.data(name).float()
    rms = b.square().mean().sqrt()
    spread = max(spread, float((a - b).square().mean().sqrt() / rms))
  out["ensemble_4_s_per_step"] = seconds
  out["ensemble_4_peak_gb"] = peak
  out["ensemble_4_rerun_rel_rms"] = spread


def _ensemble_0p25(torch, out):
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  from graphcast_tpu_torch.rollout import tile_batch
  preset = zoo.gencast_0p25deg()
  model = preset.build(generator=torch.Generator().manual_seed(0),
                       device="cuda", encode_chunks=32, decode_chunks=32,
                       fused_aggregation=False)
  inputs, targets, forcings = (
      tile_batch(fs.astype(torch.bfloat16), MEMBERS_0P25)
      for fs in synthetic.make_example_batch(
          preset.task_config, preset.resolution, batch=1, num_target_times=1,
          time_step_hours=12, device="cuda"))
  sigma = preset.sampler_config.max_noise_level
  levels = torch.full((MEMBERS_0P25,), sigma, dtype=torch.bfloat16,
                      device="cuda")

  def evaluate():
    with torch.inference_mode():
      return model._preconditioned_denoiser(inputs, targets, levels,
                                            forcings)

  evaluate()
  seconds, peak, _ = _peak(torch, evaluate)
  out["ensemble_0p25_8_s_per_evaluation"] = seconds
  out["ensemble_0p25_8_peak_gb"] = peak


def measure(tree: str) -> dict:
  import torch
  torch.backends.cuda.matmul.allow_tf32 = False
  import graphcast_tpu_torch
  out = {"tree": tree, "package": os.path.dirname(graphcast_tpu_torch.__file__)}
  for part in (_graphcast_small, _ensemble, _ensemble_0p25):
    part(torch, out)
    torch.cuda.empty_cache()
  return out


def main(argv=None) -> int:
  argv = sys.argv[1:] if argv is None else argv
  if argv[:1] == ["--measure"]:
    print(json.dumps(measure(argv[1])), flush=True)
    return 0
  runs = []
  for tree in argv:
    tree = os.path.abspath(tree)
    env = {**os.environ, "PYTHONPATH": tree, "GRAPHCAST_TPU_CACHE": ""}
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--measure", tree],
        cwd=tree, env=env, capture_output=True, text=True, check=False)
    if proc.returncode:
      print(proc.stdout + proc.stderr, file=sys.stderr)
      return proc.returncode
    runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps(runs[-1]), flush=True)
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  print(smi)
  print(json.dumps({"card": smi, "runs": runs}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
