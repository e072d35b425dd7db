"""Normalization + residual-prediction wrapper (port of graphcast_tpu/
wrappers/normalization.py; reference: normalization.py:73-196).

The inner predictor sees inputs/forcings normalized to ~zero mean and unit
variance; for target variables also present in the inputs it predicts
normalized residuals relative to the last input frame, and the inverse
transforms are applied to its predictions. The loss is taken on the
normalized residual targets (reference: normalization.py:160-196).
"""

from __future__ import annotations

import logging
from typing import Optional

from graphcast_tpu_torch.fields import Field, FieldSet, align_for_broadcast
from graphcast_tpu_torch.models.base import Predictor, WrapperPredictor

logger = logging.getLogger(__name__)


def _stat(stats: FieldSet, name: str, f: Field):
  """stats[name] aligned against ``f``, on its device and in its dtype."""
  s = stats[name]
  return align_for_broadcast(
      Field(s.data.to(device=f.data.device, dtype=f.data.dtype), s.dims), f)


def normalize(values: FieldSet, scales: FieldSet,
              locations: Optional[FieldSet]) -> FieldSet:
  """(v − location) / scale per variable; warn and skip missing stats
  (reference: normalization.py:29-48)."""
  def fn(name, f: Field) -> Field:
    data = f.data
    if locations is not None:
      if name in locations:
        data = data - _stat(locations, name, f)
      else:
        logger.warning("no normalization location found for %s", name)
    if name in scales:
      data = data / _stat(scales, name, f)
    else:
      logger.warning("no normalization scale found for %s", name)
    return Field(data, f.dims)
  return values.map(fn)


def unnormalize(values: FieldSet, scales: FieldSet,
                locations: Optional[FieldSet]) -> FieldSet:
  """v * scale + location per variable (reference: normalization.py:51-70)."""
  def fn(name, f: Field) -> Field:
    data = f.data
    if name in scales:
      data = data * _stat(scales, name, f)
    else:
      logger.warning("no normalization scale found for %s", name)
    if locations is not None:
      if name in locations:
        data = data + _stat(locations, name, f)
      else:
        logger.warning("no normalization location found for %s", name)
    return Field(data, f.dims)
  return values.map(fn)


class InputsAndResiduals(WrapperPredictor):
  """See module docstring. Stats FieldSets hold per-variable scalars or
  per-("level",) vectors."""

  def __init__(self, predictor: Predictor, stddev_by_level: FieldSet,
               mean_by_level: FieldSet, diffs_stddev_by_level: FieldSet):
    super().__init__(predictor)
    self._scales = stddev_by_level
    self._locations = mean_by_level
    self._residual_scales = diffs_stddev_by_level

  def _unnorm_prediction_and_add_input(self, inputs: FieldSet,
                                       norm_predictions: FieldSet):
    out = {}
    for name in norm_predictions.var_names:
      f = norm_predictions[name]
      if "time" in f.dims and f.sizes["time"] != 1:
        raise ValueError("InputsAndResiduals only supports single-timestep "
                         "predictions")
      if name in inputs:
        # Residual prediction: unnormalize with residual stats, add the last
        # input frame (reference: normalization.py:113-132).
        single = unnormalize(FieldSet({name: f}), self._residual_scales,
                             None)[name]
        last_input = inputs[name].isel("time", -1)
        data = single.data + align_for_broadcast(
            last_input.astype(single.data.dtype), single)
        out[name] = Field(data, single.dims)
      else:
        out[name] = unnormalize(FieldSet({name: f}), self._scales,
                                self._locations)[name]
    return FieldSet(out, coords=norm_predictions.coords)

  def _subtract_input_and_normalize_target(self, inputs: FieldSet,
                                           targets: FieldSet) -> FieldSet:
    out = {}
    for name in targets.var_names:
      f = targets[name]
      if "time" in f.dims and f.sizes["time"] != 1:
        raise ValueError("InputsAndResiduals only supports single-timestep "
                         "targets")
      if name in inputs:
        last_input = inputs[name].isel("time", -1)
        data = f.data - align_for_broadcast(last_input.astype(f.dtype), f)
        out[name] = normalize(FieldSet({name: Field(data, f.dims)}),
                              self._residual_scales, None)[name]
      else:
        out[name] = normalize(FieldSet({name: f}), self._scales,
                              self._locations)[name]
    return FieldSet(out, coords=targets.coords)

  def forward(self, inputs, targets_template, forcings, **kwargs):
    norm_inputs = normalize(inputs, self._scales, self._locations)
    norm_forcings = normalize(forcings, self._scales, self._locations)
    norm_predictions = self._predictor(
        norm_inputs, targets_template, norm_forcings, **kwargs)
    return self._unnorm_prediction_and_add_input(inputs, norm_predictions)

  def loss(self, inputs, targets, forcings, **kwargs):
    return self._predictor.loss(
        normalize(inputs, self._scales, self._locations),
        self._subtract_input_and_normalize_target(inputs, targets),
        normalize(forcings, self._scales, self._locations), **kwargs)

  def loss_and_predictions(self, inputs, targets, forcings, **kwargs):
    loss, norm_predictions = self._predictor.loss_and_predictions(
        normalize(inputs, self._scales, self._locations),
        self._subtract_input_and_normalize_target(inputs, targets),
        normalize(forcings, self._scales, self._locations), **kwargs)
    return loss, self._unnorm_prediction_and_add_input(inputs,
                                                       norm_predictions)
