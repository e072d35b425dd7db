"""GenCast ensemble rollout: ``ROLLOUT_MEMBERS`` members × ``ROLLOUT_STEPS``
12 h steps through ``rollout.chunked_ensemble_prediction`` on one card;
twin of the repository's ``tools/bench_gencast_rollout.py``.

Usage: python3 -m graphcast_tpu_torch.tools.bench_gencast_rollout

The released architecture (``zoo.gencast_custom``), weights from seed 0,
``NaNCleaner(InputsAndResiduals(...))``, a bf16 synthetic state; the
members are the batch axis, so every step runs the denoiser's general path
(K3 for the grid2mesh and mesh2grid sums and the gathers' rows, K6 in the
transformer), 39 evaluations a step. The trajectory stays on the card
unless ``ROLLOUT_PULL_TO_HOST=1``. One first run (graph, mask, SHT basis,
plans), then the minimum of ``ROLLOUT_TIMING_RUNS`` runs from new seeds,
each ending in a scalar read back: seconds, and seconds per member-step.

Knobs: ``ROLLOUT_MEMBERS`` (2), ``ROLLOUT_STEPS`` (30), ``ROLLOUT_CHUNK``
(1), ``ROLLOUT_RESOLUTION`` (1.0), ``ROLLOUT_MESH_SIZE`` (5),
``ROLLOUT_PULL_TO_HOST`` (0), ``ROLLOUT_TIMING_RUNS`` (2). The record keeps
the twin's keys but ``vs_baseline`` (a ratio to TPU figures), with the card
and its power limit.
"""

from __future__ import annotations

import math
import os

import torch

from graphcast_tpu_torch import devices
from graphcast_tpu_torch.tools import common


def build(resolution: float, mesh_size: int, num_steps: int, device):
  """(predictor, bf16 inputs, targets template, forcings) of a
  ``num_steps``-step rollout."""
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  from graphcast_tpu_torch.wrappers import InputsAndResiduals, NaNCleaner
  preset = zoo.gencast_custom(resolution, mesh_size)
  model = preset.build(generator=torch.Generator().manual_seed(0),
                       device=device)
  stddev, mean, diffs = synthetic.make_norm_stats(preset.task_config,
                                                  device=device)
  predictor = NaNCleaner(
      InputsAndResiduals(model, stddev_by_level=stddev, mean_by_level=mean,
                         diffs_stddev_by_level=diffs),
      var_to_clean="sea_surface_temperature", fill_value=0.0)
  data = synthetic.make_example_batch(
      preset.task_config, resolution=resolution, batch=1,
      num_target_times=num_steps, time_step_hours=12, device=device)
  return (predictor, *(fs.astype(torch.bfloat16) for fs in data))


def rollout(predictor, inputs, targets, forcings, members: int, seed: int,
            chunk: int = 1, pull_to_host: bool = False):
  """The ensemble's predictions [members, steps, ...] from generator
  ``seed`` (members drawn from it, rollout.member_generators)."""
  from graphcast_tpu_torch import rollout as rollout_lib
  device = inputs.data(inputs.var_names[0]).device
  with torch.inference_mode():
    return rollout_lib.chunked_ensemble_prediction(
        predictor, torch.Generator(device).manual_seed(seed), inputs,
        targets, forcings, num_samples=members, num_steps_per_chunk=chunk,
        pull_to_host=pull_to_host)


def final_mean(preds) -> float:
  """The twin's readback: the mean temperature of the last step."""
  return float(preds.data("temperature")[:, -1].float().mean())


def parse_args(argv=None):
  """The twin's positional arguments, ``--device`` and ``--out``."""
  p = common.parser(__doc__.splitlines()[0])
  return p.parse_args(argv)


def main(argv=None) -> dict:
  args = parse_args(argv)
  device = devices.resolve(args.device)
  members = common.env_int("ROLLOUT_MEMBERS", 2)
  num_steps = common.env_int("ROLLOUT_STEPS", 30)
  chunk = common.env_int("ROLLOUT_CHUNK", 1)
  resolution = common.env_float("ROLLOUT_RESOLUTION", 1.0)
  mesh_size = common.env_int("ROLLOUT_MESH_SIZE", 5)
  pull_to_host = os.environ.get("ROLLOUT_PULL_TO_HOST", "0") == "1"
  timing_runs = common.env_int("ROLLOUT_TIMING_RUNS", 2)
  predictor, inputs, targets, forcings = build(resolution, mesh_size,
                                               num_steps, device)

  def run(seed):
    value = final_mean(rollout(predictor, inputs, targets, forcings,
                               members, seed, chunk, pull_to_host))
    if not math.isfinite(value):
      raise AssertionError(f"non-finite rollout output {value}")
    return value

  compile_s, _ = common.timed(lambda: run(0), device)
  times = [common.timed(lambda: run(i + 1), device)[0]
           for i in range(timing_runs)]
  steady = min(times)
  per_member_step = steady / (members * num_steps)
  print(f"gencast_rollout_{resolution}deg: {steady:.1f} s for {members}x"
        f"{num_steps} steps ({per_member_step:.3f} s/member-step; first run "
        f"{compile_s:.1f}s)", flush=True)
  record = {
      "metric": f"gencast_{resolution}deg_mesh{mesh_size}_splash_"
                f"{num_steps}step_{members}member_rollout",
      "value": round(steady, 3), "unit": "s",
      "s_per_member_step": round(per_member_step, 4),
      "compile_s": round(compile_s, 1),
      "pull_to_host": pull_to_host,
      "note": ("chunked ensemble rollout on one card, trajectory "
               + ("pulled to the host each step; " if pull_to_host else
                  "on the card; ")
               + "reproduce with "
               f"ROLLOUT_RESOLUTION={resolution} ROLLOUT_MESH_SIZE="
               f"{mesh_size} ROLLOUT_MEMBERS={members} ROLLOUT_STEPS="
               f"{num_steps} python3 -m graphcast_tpu_torch.tools."
               "bench_gencast_rollout")}
  return common.emit(record, device, args.out)


if __name__ == "__main__":
  main()
