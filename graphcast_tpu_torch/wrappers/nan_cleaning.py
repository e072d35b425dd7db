"""NaN cleaning wrapper (port of graphcast_tpu/wrappers/nan_cleaning.py;
reference: nan_cleaning.py:27-125).

Fills one variable's NaNs (sea_surface_temperature over land, in practice)
with a fill value before the inner predictor runs, and puts the NaN mask of
the last input frame back on that variable's prediction. The loss is taken
on the cleaned inputs, targets and forcings (graphcast_tpu/wrappers/
nan_cleaning.py:60-70).
"""

from __future__ import annotations

import torch

from graphcast_tpu_torch.fields import Field, FieldSet, align_for_broadcast
from graphcast_tpu_torch.models.base import Predictor, WrapperPredictor


class NaNCleaner(WrapperPredictor):

  def __init__(self, predictor: Predictor, var_to_clean: str,
               fill_value: float, reintroduce_nans: bool = True):
    super().__init__(predictor)
    self._var = var_to_clean
    self._fill_value = fill_value
    self._reintroduce_nans = reintroduce_nans

  def _clean(self, fs: FieldSet) -> FieldSet:
    if self._var not in fs:
      return fs
    f = fs[self._var]
    return fs.replace(**{self._var: Field(
        torch.nan_to_num(f.data, nan=self._fill_value), f.dims)})

  def _maybe_reintroduce_nans(self, stale_inputs: FieldSet,
                              predictions: FieldSet) -> FieldSet:
    """Reapplies the NaN mask of the last input frame (reference:
    nan_cleaning.py:54-63)."""
    if not self._reintroduce_nans or self._var not in predictions:
      return predictions
    src = stale_inputs[self._var].isel("time", -1)
    pred = predictions[self._var]
    mask = align_for_broadcast(Field(torch.isnan(src.data), src.dims), pred)
    data = torch.where(mask, torch.full_like(pred.data, float("nan")),
                       pred.data)
    return predictions.replace(**{self._var: Field(data, pred.dims)})

  def forward(self, inputs, targets_template, forcings, **kwargs):
    predictions = self._predictor(self._clean(inputs), targets_template,
                                  self._clean(forcings), **kwargs)
    return self._maybe_reintroduce_nans(inputs, predictions)

  def loss(self, inputs, targets, forcings, **kwargs):
    return self._predictor.loss(self._clean(inputs), self._clean(targets),
                                self._clean(forcings), **kwargs)

  def loss_and_predictions(self, inputs, targets, forcings, **kwargs):
    loss, predictions = self._predictor.loss_and_predictions(
        self._clean(inputs), self._clean(targets), self._clean(forcings),
        **kwargs)
    return loss, self._maybe_reintroduce_nans(inputs, predictions)

  def precompute_step_statics(self, inputs: FieldSet) -> dict:
    return self._predictor.precompute_step_statics(self._clean(inputs))
