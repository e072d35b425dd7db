"""Forecast evaluation metrics: latitude-weighted RMSE, ACC, fair CRPS.

Port of graphcast_tpu/evaluation.py (the reference scores its models
externally, WeatherBench2-style, README.md:71-79): plain torch in float32
on the tensors' device, with the cell-area latitude weights of the training
loss (losses.py).

Conventions:
- deterministic metrics take predictions/targets with matching dims;
- ensemble metrics expect the ensemble as the leading "batch" axis of the
  predictions FieldSet (the framework's sample convention) against
  batch-1 targets.

Each metric returns {variable: tensor} reduced over lat/lon, every other
dim kept (e.g. [batch, time(, level)]).
"""

from __future__ import annotations

import torch

from graphcast_tpu_torch import losses
from graphcast_tpu_torch.fields import Field, FieldSet, align_for_broadcast


def _lat_weights(fs: FieldSet, like: Field) -> torch.Tensor:
  w = losses.normalized_latitude_weights(fs.coords["lat"])
  return align_for_broadcast(
      Field(torch.as_tensor(w, dtype=like.dtype, device=like.data.device),
            ("lat",)), like)


def _weighted_spatial_mean(data: torch.Tensor, field: Field,
                           weights: torch.Tensor) -> torch.Tensor:
  """Mean over lat/lon with latitude weights; keeps other dims."""
  axes = tuple(i for i, d in enumerate(field.dims) if d in ("lat", "lon"))
  return torch.mean(data * weights, dim=axes)


def rmse(predictions: FieldSet, targets: FieldSet) -> dict:
  """Latitude-weighted RMSE per variable."""
  out = {}
  for name in targets.var_names:
    p, t = predictions[name], targets[name]
    w = _lat_weights(targets, t)
    mse = _weighted_spatial_mean(
        (p.data.float() - t.data.float()) ** 2, t, w)
    out[name] = torch.sqrt(mse)
  return out


def acc(predictions: FieldSet, targets: FieldSet,
        climatology: FieldSet) -> dict:
  """Anomaly correlation coefficient per variable (lat-weighted)."""
  out = {}
  for name in targets.var_names:
    p, t = predictions[name], targets[name]
    c = align_for_broadcast(climatology[name].astype(torch.float32), t)
    w = _lat_weights(targets, t)
    pa = p.data.float() - c
    ta = t.data.float() - c
    num = _weighted_spatial_mean(pa * ta, t, w)
    den = torch.sqrt(_weighted_spatial_mean(pa * pa, t, w)
                     * _weighted_spatial_mean(ta * ta, t, w))
    out[name] = num / torch.clamp(den, min=1e-12)
  return out


def crps_ensemble(predictions: FieldSet, targets: FieldSet,
                  fair: bool = True) -> dict:
  """(Fair) CRPS per variable for an ensemble.

  predictions: ensemble members on the leading batch axis [M, ...];
  targets: batch-1 truth with the same trailing dims.

  CRPS = E|X − y| − ½·E|X − X'|; the *fair* variant divides the spread term
  by M(M−1) instead of M² (unbiased for finite ensembles). The pairwise
  spread is taken from the member-sorted values, Σᵢⱼ|xᵢ−xⱼ| =
  2·Σₖ(2k−M−1)·x₍ₖ₎, without an [M, M, ...] broadcast.
  """
  out = {}
  for name in targets.var_names:
    p = predictions[name].data.float()  # [M, ...]
    t = targets[name].data.float()      # [1, ...]
    m = p.shape[0]
    skill = torch.mean(torch.abs(p - t), dim=0)
    denom = m * (m - 1) if (fair and m > 1) else m * m
    p_sorted = torch.sort(p, dim=0).values
    coeffs = (2.0 * torch.arange(1, m + 1, dtype=torch.float32,
                                 device=p.device) - m - 1)
    coeffs = coeffs.reshape((m,) + (1,) * (p.ndim - 1))
    spread = 2.0 * torch.sum(coeffs * p_sorted, dim=0) / denom
    crps = skill - 0.5 * spread
    tf = targets[name]
    w = _lat_weights(targets, tf)
    out[name] = _weighted_spatial_mean(crps[None], tf, w)[0]
  return out


def ensemble_mean_rmse(predictions: FieldSet, targets: FieldSet) -> dict:
  """RMSE of the ensemble mean (the EM-RMSE of the reference's
  scorecards)."""
  mean_preds = predictions.map_data(
      lambda x: torch.mean(x.float(), dim=0, keepdim=True))
  return rmse(mean_preds, targets)
