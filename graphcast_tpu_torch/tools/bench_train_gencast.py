"""One GenCast diffusion training step (loss, backward, AdamW) on one card:
twin of the repository's ``tools/bench_train_gencast.py``.

Usage: python3 -m graphcast_tpu_torch.tools.bench_train_gencast
       [resolution] [mesh_size]

Defaults 1.0 and 5. The released architecture (``zoo.gencast_custom``),
weights from seed 0, ``NaNCleaner(InputsAndResiduals(...))``, one 12 h
target in bf16, ``train.graphcast_optimizer(peak_lr=1e-3)``; the denoiser
runs once a step (σ and noise drawn from a generator seeded with the
step). The twin's form: ``fused_aggregation=False`` (the general path, or
at 0.25° 32 encoder and decoder chunks, each a recompute region). One
first step, then the minimum of 3 steps, each read back, and the peak
memory of those.
"""

from __future__ import annotations

import torch

from graphcast_tpu_torch import devices
from graphcast_tpu_torch.tools import bench_train_025, common


def build_step(resolution: float, mesh_size: int, device):
  """(model, train step, bf16 batch) of the GenCast training step."""
  from graphcast_tpu_torch import train
  from graphcast_tpu_torch.tools.train_curve import gencast_curve
  from graphcast_tpu_torch.models import zoo
  chunks = 32 if resolution <= 0.5 else 1
  preset = zoo.gencast_custom(resolution, mesh_size)
  curve = gencast_curve(preset, device, decode_chunks=chunks,
                        encode_chunks=chunks)
  batch = tuple(fs.astype(torch.bfloat16) for fs in curve.make_batch(0))
  step = train.make_train_step(
      curve.predictor,
      train.graphcast_optimizer(curve.model.parameters(), peak_lr=1e-3))
  return curve, step, batch


def run(resolution: float, mesh_size: int, device,
        timed_steps: int = bench_train_025.TIMED_STEPS) -> dict:
  """The twin's record of the step (module doc), with peak_gb."""
  curve, step, batch = build_step(resolution, mesh_size, device)
  t = bench_train_025.time_steps(step, batch, device, curve.loss_kwargs,
                                 timed_steps)
  print(f"gencast_train_step_{resolution}deg_mesh{mesh_size}: "
        f"{min(t['times']):.3f} s (first {t['first_s']:.1f}s, "
        f"loss0={t['loss0']:.4f}, all {[round(s, 3) for s in t['times']]}, "
        f"peak {t['peak_gb']} GB)", flush=True)
  del curve, step, batch
  return {
      "metric": f"gencast_train_step_{resolution}deg_mesh{mesh_size}",
      "value": round(min(t["times"]), 4), "unit": "s",
      "compile_s": round(t["first_s"], 1),
      "peak_gb": t["peak_gb"],
      "note": ("diffusion loss+grads+AdamW on one card, the first step "
               "apart; reproduce with python3 -m graphcast_tpu_torch.tools."
               f"bench_train_gencast {resolution} {mesh_size}")}


def parse_args(argv=None):
  """The twin's positional arguments, ``--device`` and ``--out``."""
  p = common.parser(__doc__.splitlines()[0])
  p.add_argument("resolution", nargs="?", type=float, default=1.0)
  p.add_argument("mesh_size", nargs="?", type=int, default=5)
  return p.parse_args(argv)


def main(argv=None) -> dict:
  args = parse_args(argv)
  device = devices.resolve(args.device)
  return common.emit(run(args.resolution, args.mesh_size, device), device,
                     args.out)


if __name__ == "__main__":
  main()
