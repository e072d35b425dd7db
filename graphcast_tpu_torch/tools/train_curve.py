"""Training loss-descent curve: does the optimizer learn? Twin of the
repository's ``tools/train_curve.py``.

The real training loop of the port (``train.make_train_step``: loss,
backward through the fused kernels, AdamW on f32 masters) for N steps on a
fixed synthetic batch, reading each step's loss back; on a fixed batch the
model must memorize, so a broken backward kernel shows as a flat or
diverging curve. ``CURVE_STREAM=1`` asks the stronger question, learning
rather than memorization: every step trains on a fresh batch (seed i + 10)
and a held-out batch (seed 999, never trained on) is scored every
``CURVE_EVAL_EVERY`` steps (5) by ``train.make_loss_fn``.

Usage:
  python3 -m graphcast_tpu_torch.tools.train_curve [num_steps]   # GraphCast
  CURVE_MODEL=gencast python3 -m graphcast_tpu_torch.tools.train_curve
  CURVE_STREAM=1 python3 -m graphcast_tpu_torch.tools.train_curve

- GraphCast (default): 1.0°, 13 levels, mesh-5, latent 512, 16 message-
  passing steps, ``Autoregressive(InputsAndResiduals(Bfloat16Cast(
  GraphCast(fused_aggregation="processor", remat_processor=True))),
  gradient_checkpointing=True)``: K1 (processor), K4, the weight-gradient
  reduction, K3 and K3's sender mode.
- GenCast: ``zoo.gencast_custom(...).build(fused_aggregation=False)`` under
  ``NaNCleaner(InputsAndResiduals(...))``: K6, K7, K8 and K3. Its loss
  draws σ and noise from a generator seeded with the step (the held-out
  loss from seed 7 each time), so its curve is noisy.

Knobs: ``CURVE_MODEL``, ``CURVE_RESOLUTION`` (1.0), ``CURVE_MESH_SIZE``
(5), ``CURVE_LATENT`` (512), ``CURVE_MSG_STEPS`` (16), ``CURVE_LAYERS``
(16, GenCast), ``CURVE_LR`` (3e-4, ``train.graphcast_optimizer``'s peak),
``CURVE_STREAM``, ``CURVE_EVAL_EVERY``. Weights from seed 0, bf16 batches.
The record keeps the twin's keys and metric name, with the card and its
power limit.
"""

from __future__ import annotations

import os
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from graphcast_tpu_torch import devices, train
from graphcast_tpu_torch.tools import common

WEIGHT_SEED = 0
HELDOUT_SEED = 999       # the held-out batch, never trained on
HELDOUT_NOISE_SEED = 7   # GenCast's held-out σ and noise
STREAM_SEED_OFFSET = 10  # step i > 0 of a stream trains on seed i + 10


class Curve(NamedTuple):
  """What the loop trains: the parameters' module, the loss's predictor,
  a batch from a seed, the record's tag and the loss's keyword arguments
  at step i (``None``: the held-out loss)."""
  model: torch.nn.Module
  predictor: object
  make_batch: Callable[[int], tuple]
  tag: str
  loss_kwargs: Callable[[int | None], dict]


def _no_kwargs(step):
  del step
  return {}


def graphcast_curve(model_config, task_config, resolution: float, device,
                    model=None, bf16: bool = True) -> Curve:
  """GraphCast in the twin's training form (module doc); ``model``: a
  ``GraphCast`` of that form to train instead of a fresh one from seed 0."""
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models.graphcast import GraphCast
  from graphcast_tpu_torch.wrappers import (
      Autoregressive, Bfloat16Cast, InputsAndResiduals)
  if model is None:
    model = GraphCast(model_config, task_config,
                      fused_aggregation="processor", remat_processor=True,
                      generator=torch.Generator().manual_seed(WEIGHT_SEED),
                      device=device)
  stddev, mean, diffs = synthetic.make_norm_stats(task_config, device=device)
  predictor = Autoregressive(
      InputsAndResiduals(Bfloat16Cast(model, enabled=bf16),
                         stddev_by_level=stddev, mean_by_level=mean,
                         diffs_stddev_by_level=diffs),
      gradient_checkpointing=True)

  def make_batch(seed):
    return synthetic.make_example_batch(
        task_config, resolution=resolution, batch=1, num_target_times=1,
        seed=seed, device=device)

  tag = f"graphcast_{str(resolution).replace('.', 'p')}"
  return Curve(model, predictor, make_batch, tag, _no_kwargs)


def gencast_curve(preset, device, **forms) -> Curve:
  """GenCast in the twin's training form (module doc); ``forms``: the
  build's chunk counts."""
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.wrappers import InputsAndResiduals, NaNCleaner
  model = preset.build(generator=torch.Generator().manual_seed(WEIGHT_SEED),
                       device=device, fused_aggregation=False, **forms)
  stddev, mean, diffs = synthetic.make_norm_stats(preset.task_config,
                                                  device=device)
  predictor = NaNCleaner(
      InputsAndResiduals(model, stddev_by_level=stddev, mean_by_level=mean,
                         diffs_stddev_by_level=diffs),
      var_to_clean="sea_surface_temperature", fill_value=0.0)

  def make_batch(seed):
    return synthetic.make_example_batch(
        preset.task_config, resolution=preset.resolution, batch=1,
        num_target_times=1, time_step_hours=12, seed=seed, device=device)

  def loss_kwargs(step):
    seed = HELDOUT_NOISE_SEED if step is None else step
    return {"generator": torch.Generator(device).manual_seed(seed)}

  tag = f"gencast_{str(preset.resolution).replace('.', 'p')}"
  return Curve(model, predictor, make_batch, tag, loss_kwargs)


def run_curve(curve: Curve, num_steps: int, *, stream: bool = False,
              eval_every: int = 5, lr: float = 3e-4,
              dtype=torch.bfloat16, log=print) -> dict:
  """The twin's loop (module doc): returns {"losses", "heldout" [(step,
  loss)], "compile_s", "s_per_step"}; raises on a non-finite loss."""
  device = next(curve.model.parameters()).device

  def batch(seed):
    return tuple(fs.astype(dtype) for fs in curve.make_batch(seed))

  step_fn = train.make_train_step(
      curve.predictor, train.graphcast_optimizer(curve.model.parameters(),
                                                 peak_lr=lr))
  loss_fn = train.make_loss_fn(curve.predictor)
  data = batch(0)
  held = batch(HELDOUT_SEED) if stream else None
  losses, heldout = [], []
  t0 = time.perf_counter()
  for i in range(num_steps):
    if stream and i > 0:
      data = batch(i + STREAM_SEED_OFFSET)
    loss, _ = step_fn(*data, **curve.loss_kwargs(i))
    losses.append(float(loss))  # read back: the host keeps in step
    if i == 0:
      compile_s = time.perf_counter() - t0
      t1 = time.perf_counter()
    if stream and (i % eval_every == 0 or i == num_steps - 1):
      with torch.no_grad():
        hl = float(loss_fn(*held, **curve.loss_kwargs(None))[0])
      heldout.append((i, hl))
      log(f"step {i:4d}: train {losses[-1]:.5f} held-out {hl:.5f}")
    elif i % 10 == 0 or i == num_steps - 1:
      log(f"step {i:4d}: loss {losses[-1]:.5f}")
  common.synchronize(device)
  rest = num_steps - 1
  s_per_step = (time.perf_counter() - t1) / rest if rest else None
  if not all(np.isfinite(losses)):
    raise AssertionError(f"non-finite loss in curve: {losses}")
  return {"losses": losses, "heldout": heldout, "compile_s": compile_s,
          "s_per_step": s_per_step}


def record(curve: Curve, run: dict, *, stream: bool, lr: float,
           which: str) -> dict:
  """The twin's record (its keys and metric name) of a ``run_curve``."""
  losses = run["losses"]
  num_steps = len(losses)
  w = max(1, num_steps // 10)
  first, last = float(np.mean(losses[:w])), float(np.mean(losses[-w:]))
  out = {
      "metric": f"train_loss_descent_{curve.tag}_{num_steps}steps"
                + ("_stream" if stream else ""),
      "first_window_mean": round(first, 5),
      "last_window_mean": round(last, 5),
      "drop_pct": round((1 - last / first) * 100, 2),
      "losses": [round(v, 5) for v in losses],
      "lr": lr,
      "note": (("fresh synthetic batch every step + fixed held-out batch "
                f"(seed {HELDOUT_SEED}, never trained on) scored with the "
                "loss fn; " if stream else "fixed synthetic batch, ")
               + "train.make_train_step (AdamW, f32 masters, bf16 "
               "activations, the port's kernels); reproduce with "
               + ("CURVE_STREAM=1 " if stream else "")
               + f"CURVE_MODEL={which} python3 -m "
               f"graphcast_tpu_torch.tools.train_curve {num_steps}")}
  if stream:
    hvals = [h for _, h in run["heldout"]]
    out["heldout"] = [[s, round(h, 5)] for s, h in run["heldout"]]
    out["heldout_first"] = round(hvals[0], 5)
    out["heldout_last"] = round(hvals[-1], 5)
    out["heldout_drop_pct"] = round((1 - hvals[-1] / hvals[0]) * 100, 2)
  return out


def build(which: str, device) -> Curve:
  """The curve ``CURVE_MODEL`` names, sized by the knobs (module doc)."""
  from graphcast_tpu_torch.models import configs, zoo
  resolution = common.env_float("CURVE_RESOLUTION", 1.0)
  if which == "graphcast":
    model_config = configs.ModelConfig(
        resolution=resolution, mesh_size=common.env_int("CURVE_MESH_SIZE", 5),
        latent_size=common.env_int("CURVE_LATENT", 512),
        gnn_msg_steps=common.env_int("CURVE_MSG_STEPS", 16),
        hidden_layers=1, radius_query_fraction_edge_length=0.6)
    return graphcast_curve(model_config, configs.TASK_13, resolution, device)
  preset = zoo.gencast_custom(
      resolution=resolution, mesh_size=common.env_int("CURVE_MESH_SIZE", 5),
      d_model=common.env_int("CURVE_LATENT", 512),
      num_layers=common.env_int("CURVE_LAYERS", 16),
      latent_size=common.env_int("CURVE_LATENT", 512))
  return gencast_curve(preset, device)


MODELS = ("gencast", "graphcast")


def parse_args(argv=None):
  """The twin's positional arguments, ``--device`` and ``--out``."""
  p = common.parser(__doc__.splitlines()[0])
  p.add_argument("num_steps", nargs="?", type=int, default=60)
  return p.parse_args(argv)


def main(argv=None) -> dict:
  args = parse_args(argv)
  device = devices.resolve(args.device)
  which = os.environ.get("CURVE_MODEL", "graphcast")
  if which not in MODELS:
    raise SystemExit(f"CURVE_MODEL={which!r}: expected one of "
                     f"{sorted(MODELS)}")
  stream = os.environ.get("CURVE_STREAM", "0") == "1"
  lr = common.env_float("CURVE_LR", 3e-4)
  curve = build(which, device)
  run = run_curve(curve, args.num_steps, stream=stream,
                  eval_every=common.env_int("CURVE_EVAL_EVERY", 5), lr=lr)
  rec = record(curve, run, stream=stream, lr=lr, which=which)
  print(f"{curve.tag}: loss {rec['first_window_mean']:.5f} -> "
        f"{rec['last_window_mean']:.5f} over {args.num_steps} steps "
        f"({rec['drop_pct']:.1f}% drop, first step {run['compile_s']:.1f}s, "
        f"then {run['s_per_step']} s/step)", flush=True)
  return common.emit(rec, device, args.out)


if __name__ == "__main__":
  main()
