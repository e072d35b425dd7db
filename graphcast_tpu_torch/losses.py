"""Latitude- and pressure-level-weighted losses (port of
graphcast_tpu/losses.py; reference: losses.py).

Weights are computed on the host with numpy from the FieldSet's coords:
- latitude weights ∝ grid-cell area: cos(lat) for offset grids, with the
  pole-cell special case sin²(Δ/4) for grids including ±90
  (reference: losses.py:103-172);
- level weights ∝ pressure level / mean level (reference: losses.py:97-100).

Rounding points are the JAX package's: err² in the prediction's dtype (bf16
under Bfloat16Cast), the weights cast to that dtype, the mean then cast to
f32.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from graphcast_tpu_torch.fields import Field, FieldSet, align_for_broadcast

LossAndDiagnostics = tuple[torch.Tensor, dict]  # (loss [batch], {var: [batch]})


def _check_uniform_spacing_and_get_delta(vector: np.ndarray) -> float:
  diff = np.diff(vector)
  if not np.all(np.isclose(diff[0], diff)):
    raise ValueError(f"vector {vector} is not uniformly spaced")
  return float(diff[0])


def latitude_cell_area_weights(latitude: np.ndarray) -> np.ndarray:
  """Unnormalized per-latitude cell-area weights (host numpy)."""
  latitude = np.asarray(latitude, dtype=np.float64)
  delta = abs(_check_uniform_spacing_and_get_delta(latitude))
  if np.any(np.isclose(np.abs(latitude), 90.0)):
    if (not np.isclose(latitude.max(), 90.0)
        or not np.isclose(latitude.min(), -90.0)):
      raise ValueError("latitude grid touching a pole must span [-90, 90]")
    weights = (np.cos(np.deg2rad(latitude))
               * np.sin(np.deg2rad(delta / 2)))
    pole = np.isclose(np.abs(latitude), 90.0)
    weights[pole] = np.sin(np.deg2rad(delta / 4)) ** 2
    return weights
  if (not np.isclose(latitude.max(), 90 - delta / 2)
      or not np.isclose(latitude.min(), -90 + delta / 2)):
    raise ValueError(
        f"latitude vector must start/end at ±(90 − Δ/2); got {latitude}")
  return np.cos(np.deg2rad(latitude))


def normalized_latitude_weights(latitude: np.ndarray) -> np.ndarray:
  w = latitude_cell_area_weights(latitude)
  return (w / w.mean()).astype(np.float32)


def normalized_level_weights(level: np.ndarray) -> np.ndarray:
  level = np.asarray(level, dtype=np.float64)
  return (level / level.mean()).astype(np.float32)


def _weighted(err2: torch.Tensor, weights: np.ndarray, dim: str,
              like: Field) -> torch.Tensor:
  w = Field(torch.as_tensor(weights, dtype=err2.dtype, device=err2.device),
            (dim,))
  return err2 * align_for_broadcast(w, like)


def weighted_mse_per_level(
    predictions: FieldSet,
    targets: FieldSet,
    per_variable_weights: Mapping[str, float],
) -> LossAndDiagnostics:
  """Lat/level-weighted MSE (reference: losses.py:56-94).

  Returns (total_loss [batch], {var: per-var loss [batch]}), f32.
  """
  coords = targets.coords
  lat_w = normalized_latitude_weights(coords["lat"]) if "lat" in coords else None
  level_w = (normalized_level_weights(coords["level"])
             if "level" in coords else None)

  diagnostics = {}
  for name in targets.var_names:
    pred = predictions[name].data
    tgt = targets[name]
    err2 = (pred - tgt.data.to(pred.dtype)) ** 2
    if lat_w is not None and "lat" in tgt.dims:
      err2 = _weighted(err2, lat_w, "lat", tgt)
    if level_w is not None and "level" in tgt.dims:
      err2 = _weighted(err2, level_w, "level", tgt)
    axes = tuple(i for i, d in enumerate(tgt.dims) if d != "batch")
    diagnostics[name] = err2.mean(dim=axes).float()

  total = sum_per_variable_losses(diagnostics, per_variable_weights)
  return total, diagnostics


def sum_per_variable_losses(per_variable_losses: Mapping[str, torch.Tensor],
                            weights: Mapping[str, float]):
  """Weighted sum over variables (reference: losses.py:77-94).

  Variables absent from `weights` default to weight 1.0.
  """
  extra = set(weights) - set(per_variable_losses)
  if extra:
    raise ValueError(f"weights for unknown variables: {extra}")
  total = 0.0
  for name, loss in per_variable_losses.items():
    total = total + loss * weights.get(name, 1.0)
  return total
