"""GraphCast end to end on the port: twin of examples/graphcast_demo.py
(the script form of the reference's graphcast_demo.ipynb).

1. build Autoregressive(InputsAndResiduals(Bfloat16Cast(GraphCast))), with
   random weights from --seed or a reference-format checkpoint bundle
   (--checkpoint, compat/haiku_checkpoint.py);
2. make an ERA5-shaped dataset from --seed on the device, add the progress
   features and TOA incident solar radiation, and extract inputs, targets
   and forcings (data/era5.py); or, with --data synthetic, the JAX demo's
   synthetic batch;
3. forecast --steps six-hour steps and score them against the targets
   (latitude-weighted RMSE; ACC against the normalization means as the
   climatology);
4. take the loss and its gradients;
5. run a chunked rollout twice as long.

Runs on the card (--device cuda, the default); --device cpu runs the
kernels' plain versions. Nothing falls back: without a card the default
raises.

Usage:
  python3 -m graphcast_tpu_torch.examples.graphcast_demo [--resolution 4.0]
      [--mesh-size 3] [--steps 8] [--checkpoint path/to/params.npz]
      [--data era5|synthetic] [--seed 0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from graphcast_tpu_torch import devices, evaluation, rollout, train
from graphcast_tpu_torch.compat import haiku_checkpoint
from graphcast_tpu_torch.data import durations, era5, synthetic
from graphcast_tpu_torch.models import configs
from graphcast_tpu_torch.models.graphcast import GraphCast
from graphcast_tpu_torch.wrappers import (
    Autoregressive, Bfloat16Cast, InputsAndResiduals)


def era5_inputs_targets_forcings(task_config: configs.TaskConfig,
                                 resolution: float, steps: int,
                                 step_hours: int, seed: int,
                                 device: torch.device):
  """(inputs, targets, forcings) of ``steps`` target steps, extracted from
  an ERA5-shaped dataset made from ``seed`` on ``device``."""
  step = np.timedelta64(step_hours, "h")
  num_inputs = int(durations.to_timedelta64(task_config.input_duration)
                   // step)
  dataset = synthetic.make_era5_dataset(
      task_config, resolution, num_times=num_inputs + steps,
      time_step_hours=step_hours, seed=seed, device=device)
  dataset = era5.add_derived_vars(dataset)
  if era5.TISR in (set(task_config.input_variables)
                   | set(task_config.forcing_variables)):
    dataset = era5.add_tisr_var(dataset)
  return era5.extract_inputs_targets_forcings(
      dataset, input_variables=task_config.input_variables,
      target_variables=task_config.target_variables,
      forcing_variables=task_config.forcing_variables,
      pressure_levels=task_config.pressure_levels,
      input_duration=task_config.input_duration,
      target_lead_times=slice(f"{step_hours}h", f"{step_hours * steps}h"))


def summarize(scores: dict) -> dict:
  """{variable: mean over every kept dim} of a metric's output."""
  return {k: round(float(v.float().mean()), 4) for k, v in scores.items()}


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--resolution", type=float, default=4.0)
  parser.add_argument("--mesh-size", type=int, default=3)
  parser.add_argument("--latent-size", type=int, default=128)
  parser.add_argument("--gnn-msg-steps", type=int, default=4)
  parser.add_argument("--steps", type=int, default=8,
                      help="number of 6h forecast steps")
  parser.add_argument("--checkpoint", type=str, default=None,
                      help="reference-format .npz checkpoint bundle")
  parser.add_argument("--data", choices=("era5", "synthetic"),
                      default="era5")
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--device", type=str, default=devices.DEFAULT_DEVICE)
  args = parser.parse_args(argv)
  device = devices.resolve(args.device)

  if args.checkpoint:
    model, model_config, task_config, desc, _ = (
        haiku_checkpoint.load_graphcast_checkpoint(args.checkpoint,
                                                   device=device))
    print(f"loaded checkpoint: {desc}")
  else:
    task_config = configs.TASK_13
    model_config = configs.ModelConfig(
        resolution=args.resolution, mesh_size=args.mesh_size,
        latent_size=args.latent_size, gnn_msg_steps=args.gnn_msg_steps,
        hidden_layers=1)
    model = GraphCast(model_config, task_config,
                      generator=torch.Generator().manual_seed(args.seed),
                      device=device)

  if args.data == "era5":
    inputs, targets, forcings = era5_inputs_targets_forcings(
        task_config, model_config.resolution, args.steps, 6, args.seed,
        device)
  else:
    inputs, targets, forcings = synthetic.make_example_batch(
        task_config, resolution=model_config.resolution, batch=1,
        num_target_times=args.steps, seed=args.seed, device=device)
  stddev, mean, diffs = synthetic.make_norm_stats(task_config, device=device)
  predictor = Autoregressive(
      InputsAndResiduals(Bfloat16Cast(model), stddev_by_level=stddev,
                         mean_by_level=mean, diffs_stddev_by_level=diffs),
      gradient_checkpointing=True)
  n_params = sum(p.numel() for p in model.parameters())
  print(f"params: {n_params:,} on {device}")

  # --- forecast and scores ---
  t0 = time.time()
  predictions = predictor(inputs, targets, forcings)
  t2m = predictions.data("2m_temperature").float().cpu()
  print(f"{args.steps}-step forecast (incl. graph build): "
        f"{time.time() - t0:.1f}s")
  print("prediction vars:", predictions.var_names)
  if not torch.isfinite(t2m).all():
    raise RuntimeError("non-finite forecast")
  print("rmse:", summarize(evaluation.rmse(predictions, targets)))
  print("acc:", summarize(evaluation.acc(predictions, targets, mean)))

  # --- loss + gradients ---
  loss_fn = train.make_loss_fn(predictor)
  loss, diagnostics = loss_fn(inputs, targets, forcings)
  loss.backward()
  grads_finite = all(torch.isfinite(p.grad).all()
                     for p in model.parameters() if p.grad is not None)
  print(f"loss: {loss.item():.4f}; grads finite: {grads_finite}")
  print("per-variable diagnostics:",
        {k: round(v.item(), 4) for k, v in diagnostics.items()})
  if not grads_finite:
    raise RuntimeError("non-finite gradients")

  # --- chunked long rollout ---
  long_targets = rollout.extend_targets_template(targets, args.steps * 2)
  long_forcings = rollout.extend_targets_template(forcings, args.steps * 2)
  chunked = rollout.chunked_prediction(
      predictor, None, inputs, long_targets, long_forcings,
      num_steps_per_chunk=args.steps)
  print("chunked rollout steps:", chunked.sizes["time"])
  return predictions


if __name__ == "__main__":
  main()
