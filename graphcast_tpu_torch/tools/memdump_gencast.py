"""Memory breakdown of a GenCast ensemble step at its peak: twin of the
repository's ``tools/memdump_gencast.py``.

Usage: python3 -m graphcast_tpu_torch.tools.memdump_gencast
       [resolution] [mesh_size]

Defaults 0.25 and 6: one preconditioned denoiser evaluation of 8 members
as the batch, at the sampler's first noise level (the ensemble evaluation
the port runs at 0.25°; the JAX script's sample step has one member), in
the chunked unfused form (32 encoder and decoder chunks at 0.25°, else 1;
``fused_aggregation=False``), the released architecture with weights from
seed 0, bf16, under ``torch.inference_mode``. A whole 12 h step of 8
members at 0.25° (the sampler's state beside the evaluation) does not fit
in 80 GB. The JAX script asks the
compiler for its static buffer assignment; this runs the step with the
allocator's history on from before the model is built (``memory_trace``)
and lists the blocks live at the peak, grouped by the port's allocating
line, with their total beside ``torch.cuda.max_memory_allocated()``.
"""

from __future__ import annotations

import torch

from graphcast_tpu_torch import devices
from graphcast_tpu_torch.tools import common, memory_trace


MEMBERS = 8


def run(resolution: float, mesh_size: int, device, top: int = 25) -> dict:
  """The step's memory record (module doc)."""
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  from graphcast_tpu_torch.rollout import tile_batch
  chunks = 32 if resolution <= 0.5 else 1

  def step_once():
    preset = zoo.gencast_custom(resolution, mesh_size)
    model = preset.build(generator=torch.Generator().manual_seed(0),
                         device=device, decode_chunks=chunks,
                         encode_chunks=chunks, fused_aggregation=False)
    inputs, targets, forcings = (
        tile_batch(fs.astype(torch.bfloat16), MEMBERS)
        for fs in synthetic.make_example_batch(
            preset.task_config, resolution=resolution, batch=1,
            num_target_times=1, time_step_hours=12, device=device))
    gen = torch.Generator(device).manual_seed(1)
    sigma = preset.sampler_config.max_noise_level
    noisy = targets.map_data(lambda x: x + sigma * torch.randn(
        x.shape, generator=gen, device=device, dtype=x.dtype))
    levels = torch.full((MEMBERS,), sigma, dtype=torch.bfloat16,
                        device=device)
    with torch.inference_mode():
      preds = model._preconditioned_denoiser(inputs, noisy, levels,
                                             forcings)
      value = float(preds.data("temperature").float().mean())
    del model, preds
    return value

  value, snapshot, measured = memory_trace.record(step_once, device)
  mem = memory_trace.summary(memory_trace.peak_breakdown(
      snapshot, device.index or 0), measured, top)
  for s in mem["sites"]:
    print(f"  {s['gb']:9.4f} GB  {s['blocks']:6d} blocks  {s['site']}")
  print(f"  listed {mem['listed_gb']:.4f} GB of the measured peak "
        f"{mem['measured_peak_gb']:.4f} GB", flush=True)
  return {"metric": f"gencast_{resolution}deg_mesh{mesh_size}_{MEMBERS}"
                    "member_evaluation_memory",
          "mean_temperature": value, **mem}


def parse_args(argv=None):
  """The twin's positional arguments, ``--device`` and ``--out``."""
  p = common.parser(__doc__.splitlines()[0])
  p.add_argument("resolution", nargs="?", type=float, default=0.25)
  p.add_argument("mesh_size", nargs="?", type=int, default=6)
  return p.parse_args(argv)


def main(argv=None) -> dict:
  args = parse_args(argv)
  device = devices.resolve(args.device)
  if device.type != "cuda":
    raise SystemExit("the allocator's history exists on the card only")
  return common.emit(run(args.resolution, args.mesh_size, device), device,
                     args.out)


if __name__ == "__main__":
  main()
