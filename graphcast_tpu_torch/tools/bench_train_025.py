"""One GraphCast training step (loss, backward, AdamW) on one card: twin of
the repository's ``tools/bench_train_025.py``.

Usage: python3 -m graphcast_tpu_torch.tools.bench_train_025 [ar_steps]

0.25°, 37 levels, mesh-6 by default; ``TRAIN_RESOLUTION=1.0`` takes 1.0°,
13 levels, mesh-5 (``TRAIN_MESH_SIZE`` overrides the mesh). Latent 512, 16
message-passing steps, AR-``ar_steps`` loss (1 by default), bf16
activations through ``Bfloat16Cast``, f32 masters, ``train.
graphcast_optimizer(peak_lr=1e-3)``, weights from seed 0. The twin's
training form: ``GraphCast(decode_chunks, encode_chunks, fused_aggregation,
remat_processor=True)`` under ``Autoregressive(gradient_checkpointing=True,
loss_scan_unroll, loss_scan_block, loss_carry_offload,
loss_offload_processor_carries)``, each from its knob: ``TRAIN_DECODE_
CHUNKS`` (64 at 0.25°, else 1), ``TRAIN_ENCODE_CHUNKS`` (50, else 1),
``TRAIN_FUSED`` (0, 1, processor (default), encoder), ``AR_UNROLL`` (4),
``AR_BLOCK`` (1), ``AR_OFFLOAD`` (0), ``AR_OFFLOAD_MP`` (0). At 0.25° the
default is the form the port's notes call B.

One first step, then the minimum of 3 steps, each read back: seconds per
step, the first step's seconds, and the peak memory of the timed steps.
"""

from __future__ import annotations

import math

import torch

from graphcast_tpu_torch import devices, train
from graphcast_tpu_torch.tools import common

FUSED_MODES = {"0": False, "1": True, "processor": "processor",
               "encoder": "encoder"}
TIMED_STEPS = 3


def training_config(resolution: float | None = None,
                    mesh_size: int | None = None, task=None,
                    fine_defaults: bool | None = None,
                    fused_default: str = "processor") -> dict:
  """The sizes and forms of the step: the knobs (module doc), where an
  argument does not fix them; ``fine_defaults``: take the 0.25° chunk
  counts (else 1), by default where the resolution is 0.5° or finer."""
  from graphcast_tpu_torch.models import configs
  if resolution is None:
    resolution = common.env_float("TRAIN_RESOLUTION", 0.25)
  fine = resolution <= 0.5
  fine_defaults = fine if fine_defaults is None else fine_defaults
  return {
      "resolution": resolution,
      "mesh_size": mesh_size or common.env_int("TRAIN_MESH_SIZE",
                                               6 if fine else 5),
      "task": task or (configs.TASK if fine else configs.TASK_13),
      "fused": common.choice("TRAIN_FUSED", FUSED_MODES, fused_default),
      "decode_chunks": common.env_int("TRAIN_DECODE_CHUNKS",
                                      64 if fine_defaults else 1),
      "encode_chunks": common.env_int("TRAIN_ENCODE_CHUNKS",
                                      50 if fine_defaults else 1),
      "loss_scan_unroll": common.env_int("AR_UNROLL", 4),
      "loss_scan_block": common.env_int("AR_BLOCK", 1),
      "loss_carry_offload": common.env_bool("AR_OFFLOAD"),
      "loss_offload_processor_carries": common.env_bool("AR_OFFLOAD_MP"),
  }


def build_step(cfg: dict, ar_steps: int, device, hidden_layers: int = 1,
               batch=None):
  """(model, train step, bf16 batch) of the configured training step;
  ``hidden_layers``: the MLPs' hidden layers (the JAX script's 1);
  ``batch``: the bf16 (inputs, targets, forcings) to train on, made from
  the synthetic data where None."""
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import configs
  from graphcast_tpu_torch.models.graphcast import GraphCast
  from graphcast_tpu_torch.wrappers import (
      Autoregressive, Bfloat16Cast, InputsAndResiduals)
  model_config = configs.ModelConfig(
      resolution=cfg["resolution"], mesh_size=cfg["mesh_size"],
      latent_size=512, gnn_msg_steps=16, hidden_layers=hidden_layers,
      radius_query_fraction_edge_length=0.6)
  task = cfg["task"]
  model = GraphCast(model_config, task, decode_chunks=cfg["decode_chunks"],
                    encode_chunks=cfg["encode_chunks"],
                    fused_aggregation=cfg["fused"], remat_processor=True,
                    generator=torch.Generator().manual_seed(0), device=device)
  stddev, mean, diffs = synthetic.make_norm_stats(task, device=device)
  predictor = Autoregressive(
      InputsAndResiduals(Bfloat16Cast(model), stddev_by_level=stddev,
                         mean_by_level=mean, diffs_stddev_by_level=diffs),
      gradient_checkpointing=True,
      loss_scan_unroll=cfg["loss_scan_unroll"],
      loss_scan_block=cfg["loss_scan_block"],
      loss_carry_offload=cfg["loss_carry_offload"],
      loss_offload_processor_carries=cfg["loss_offload_processor_carries"])
  if batch is None:
    batch = tuple(fs.astype(torch.bfloat16) for fs in
                  synthetic.make_example_batch(
                      task, resolution=cfg["resolution"], batch=1,
                      num_target_times=ar_steps, device=device))
  step = train.make_train_step(
      predictor, train.graphcast_optimizer(model.parameters(), peak_lr=1e-3))
  return model, step, batch


def time_steps(step, batch, device, loss_kwargs=lambda i: {},
               timed_steps: int = TIMED_STEPS) -> dict:
  """{first_s, loss0, times, peak_gb}: one step, then ``timed_steps`` steps
  each read back, the peak memory over those."""
  first_s, (loss, _) = common.timed(lambda: step(*batch, **loss_kwargs(0)),
                                    device)
  loss0 = float(loss)
  if not math.isfinite(loss0):
    raise AssertionError(f"non-finite training loss {loss0}")
  common.reset_peak(device)
  times = []
  for i in range(timed_steps):
    seconds, (loss, _) = common.timed(
        lambda: step(*batch, **loss_kwargs(i + 1)), device)
    float(loss)
    times.append(seconds)
  return {"first_s": first_s, "loss0": loss0, "times": times,
          "peak_gb": common.peak_gb(device)}


def run(ar_steps: int, device, cfg: dict | None = None,
        timed_steps: int = TIMED_STEPS) -> dict:
  """The twin's record of one configured step (module doc), with peak_gb."""
  cfg = cfg or training_config()
  model, step, batch = build_step(cfg, ar_steps, device)
  t = time_steps(step, batch, device, timed_steps=timed_steps)
  resolution = cfg["resolution"]
  levs = len(cfg["task"].pressure_levels)
  print(f"train_step_{resolution}deg_ar{ar_steps}: {min(t['times']):.3f} s "
        f"(first {t['first_s']:.1f}s, loss0={t['loss0']:.4f}, all "
        f"{[round(s, 3) for s in t['times']]}, peak {t['peak_gb']} GB)",
        flush=True)
  del model, step, batch
  return {
      "metric": f"graphcast_train_step_{resolution}deg_{levs}lev"
                f"_ar{ar_steps}",
      "value": round(min(t["times"]), 4), "unit": "s",
      "compile_s": round(t["first_s"], 1),
      "fused": str(cfg["fused"]),
      "carry_offload": cfg["loss_carry_offload"],
      "peak_gb": t["peak_gb"],
      "note": ("loss+grads+AdamW on one card, the first step apart; "
               "reproduce with "
               f"TRAIN_RESOLUTION={resolution} python3 -m "
               f"graphcast_tpu_torch.tools.bench_train_025 {ar_steps}")}


def parse_args(argv=None):
  """The twin's positional arguments, ``--device`` and ``--out``."""
  p = common.parser(__doc__.splitlines()[0])
  p.add_argument("ar_steps", nargs="?", type=int, default=1)
  return p.parse_args(argv)


def main(argv=None) -> dict:
  args = parse_args(argv)
  device = devices.resolve(args.device)
  cfg = training_config()
  return common.emit(run(args.ar_steps, device, cfg), device, args.out)


if __name__ == "__main__":
  main()
