"""GenCast ensemble demo on the port: twin of examples/gencast_demo.py (the
script form of the reference's gencast_mini_demo.ipynb).

1. build NaNCleaner(InputsAndResiduals(GenCast)), the reference's inference
   wrapper stack, with random weights from --seed;
2. make an ERA5-shaped 12-hourly dataset from --seed on the device, add the
   progress features and extract inputs, targets and forcings
   (data/era5.py); or, with --data synthetic, the JAX demo's synthetic
   batch; both in bf16, the dtype of the card's kernels;
3. draw an N-member ensemble (rollout.chunked_ensemble_prediction) and
   score it against the targets (fair CRPS, ensemble-mean RMSE);
4. take the diffusion training loss and its gradients.

Runs on the card (--device cuda, the default); --device cpu runs the
kernels' plain versions. The JAX demo's sharding of the members over
devices is not ported. Nothing falls back: without a card the default
raises.

Usage:
  python3 -m graphcast_tpu_torch.examples.gencast_demo [--members 4]
      [--mesh-size 3] [--attention mha|triblockdiag_mha|splash_mha]
      [--data era5|synthetic] [--seed 0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from graphcast_tpu_torch import devices, evaluation, rollout, train
from graphcast_tpu_torch.data import synthetic
from graphcast_tpu_torch.examples.graphcast_demo import (
    era5_inputs_targets_forcings, summarize)
from graphcast_tpu_torch.models import gencast
from graphcast_tpu_torch.models.denoiser import (
    DenoiserArchitectureConfig, NoiseEncoderConfig)
from graphcast_tpu_torch.models.sparse_transformer import (
    SparseTransformerConfig)
from graphcast_tpu_torch.wrappers import InputsAndResiduals, NaNCleaner


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--resolution", type=float, default=4.0)
  parser.add_argument("--mesh-size", type=int, default=3)
  parser.add_argument("--latent-size", type=int, default=128)
  parser.add_argument("--members", type=int, default=4)
  parser.add_argument("--attention", type=str, default="triblockdiag_mha",
                      choices=("mha", "triblockdiag_mha", "splash_mha"))
  parser.add_argument("--noise-levels", type=int, default=8)
  parser.add_argument("--fused", action="store_true",
                      help="ask for the fused kernels, which the port runs "
                           "at batch 1 in any case")
  parser.add_argument("--data", choices=("era5", "synthetic"),
                      default="era5")
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--device", type=str, default=devices.DEFAULT_DEVICE)
  args = parser.parse_args(argv)
  device = devices.resolve(args.device)

  task = gencast.TASK
  d_model = args.latent_size
  st_cfg = SparseTransformerConfig(
      attention_k_hop=4, d_model=d_model, num_layers=4,
      num_heads=max(1, d_model // 128) if args.attention == "splash_mha"
      else 4,
      attention_type=args.attention, ffw_hidden=2 * d_model, block_q=256)
  arch_cfg = DenoiserArchitectureConfig(
      sparse_transformer_config=st_cfg, mesh_size=args.mesh_size,
      latent_size=args.latent_size)
  model = gencast.GenCast(
      task_config=task,
      denoiser_architecture_config=arch_cfg,
      sampler_config=gencast.SamplerConfig(
          num_noise_levels=args.noise_levels),
      noise_config=gencast.NoiseConfig(),
      noise_encoder_config=NoiseEncoderConfig(),
      fused_aggregation=True if args.fused else None,
      generator=torch.Generator().manual_seed(args.seed), device=device)

  stddev, mean, diffs = synthetic.make_norm_stats(task, device=device)
  predictor = NaNCleaner(
      InputsAndResiduals(model, stddev_by_level=stddev, mean_by_level=mean,
                         diffs_stddev_by_level=diffs),
      var_to_clean="sea_surface_temperature", fill_value=0.0)

  if args.data == "era5":
    data = era5_inputs_targets_forcings(task, args.resolution, 1, 12,
                                        args.seed, device)
  else:
    data = synthetic.make_example_batch(
        task, resolution=args.resolution, batch=1, num_target_times=1,
        time_step_hours=12, seed=args.seed, device=device)
  # bf16, the dtype the card's kernels take (K1, K2 and K6 in bf16).
  inputs, targets, forcings = (fs.astype(torch.bfloat16) for fs in data)

  generator = torch.Generator(device=device).manual_seed(args.seed)
  t0 = time.time()
  ensemble = rollout.chunked_ensemble_prediction(
      predictor, generator, inputs, targets, forcings,
      num_samples=args.members, pull_to_host=False)
  t2m = ensemble.data("2m_temperature").float()
  print(f"{args.members}-member ensemble (incl. graph build): "
        f"{time.time() - t0:.1f}s on {device}")
  if not torch.isfinite(t2m).all():
    raise RuntimeError("non-finite ensemble")
  print("ensemble spread (2m_temperature stddev across members): "
        f"{t2m.std(dim=0).mean().item():.3f}")
  print("crps:", summarize(evaluation.crps_ensemble(ensemble, targets)))
  print("ensemble-mean rmse:",
        summarize(evaluation.ensemble_mean_rmse(ensemble, targets)))

  loss_fn = train.make_loss_fn(predictor)
  loss, _ = loss_fn(inputs, targets, forcings, generator=generator)
  loss.backward()
  grads_finite = all(torch.isfinite(p.grad).all()
                     for p in model.parameters() if p.grad is not None)
  print(f"diffusion training loss: {loss.item():.4f}; grads finite: "
        f"{grads_finite}")
  if not grads_finite:
    raise RuntimeError("non-finite gradients")
  return ensemble


if __name__ == "__main__":
  main()
