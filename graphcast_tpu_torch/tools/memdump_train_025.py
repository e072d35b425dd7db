"""Memory breakdown of one GraphCast training step at its peak: twin of
the repository's ``tools/memdump_train_025.py``.

Usage: python3 -m graphcast_tpu_torch.tools.memdump_train_025
       [ar_steps] [resolution] [mesh_size]

Defaults 2, 0.25 and 6: the AR-2 0.25° step in the twin's training form
(``bench_train_025``'s model and step, 37 levels at any resolution, as the
twin; the knobs ``TRAIN_DECODE_CHUNKS`` (64), ``TRAIN_ENCODE_CHUNKS`` (50),
``TRAIN_FUSED``, ``AR_UNROLL``, ``AR_BLOCK``, ``AR_OFFLOAD``,
``AR_OFFLOAD_MP`` as there). ``TRAIN_FUSED``
takes the twin's values; its default here is ``processor``, the form the
port's notes call B (the twin's default, ``0``, has no fused processor).
The JAX script asks the compiler for its static buffer assignment;
PyTorch allocates as it runs, so this runs the step once with the
allocator's history on from before the model is built
(``memory_trace``) and lists the blocks live at the peak, grouped by the
port's allocating line, with their total beside
``torch.cuda.max_memory_allocated()``.
"""

from __future__ import annotations

import torch

from graphcast_tpu_torch import devices
from graphcast_tpu_torch.tools import bench_train_025, common, memory_trace


def run(ar_steps: int, resolution: float, mesh_size: int, device,
        top: int = 25) -> dict:
  """The step's memory record (module doc)."""
  from graphcast_tpu_torch.models import configs
  cfg = bench_train_025.training_config(resolution, mesh_size, configs.TASK,
                                        fine_defaults=True)

  def step_once():
    model, step, batch = bench_train_025.build_step(cfg, ar_steps, device)
    loss = float(step(*batch)[0])
    del model, step, batch
    return loss

  loss, snapshot, measured = memory_trace.record(step_once, device)
  mem = memory_trace.summary(memory_trace.peak_breakdown(
      snapshot, device.index or 0), measured, top)
  levs = len(cfg["task"].pressure_levels)
  for s in mem["sites"]:
    print(f"  {s['gb']:9.4f} GB  {s['blocks']:6d} blocks  {s['site']}")
  print(f"  listed {mem['listed_gb']:.4f} GB of the measured peak "
        f"{mem['measured_peak_gb']:.4f} GB", flush=True)
  return {"metric": f"graphcast_train_step_{resolution}deg_{levs}lev"
                    f"_ar{ar_steps}_memory",
          "loss": loss, "fused": str(cfg["fused"]), **mem}


def parse_args(argv=None):
  """The twin's positional arguments, ``--device`` and ``--out``."""
  p = common.parser(__doc__.splitlines()[0])
  p.add_argument("ar_steps", nargs="?", type=int, default=2)
  p.add_argument("resolution", nargs="?", type=float, default=0.25)
  p.add_argument("mesh_size", nargs="?", type=int, default=6)
  return p.parse_args(argv)


def main(argv=None) -> dict:
  args = parse_args(argv)
  device = devices.resolve(args.device)
  if device.type != "cuda":
    raise SystemExit("the allocator's history exists on the card only")
  return common.emit(run(args.ar_steps, args.resolution, args.mesh_size,
                         device), device, args.out)


if __name__ == "__main__":
  main()
