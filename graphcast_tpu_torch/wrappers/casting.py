"""bfloat16 activation casting wrapper (port of graphcast_tpu/wrappers/
casting.py; reference: casting.py:31-152).

Casts floating inputs/targets/forcings to bfloat16 before the inner
predictor and casts predictions back to the target dtype. The f32-master /
bf16-compute half of the policy lives in nn/core.py (params cast at use).
"""

from __future__ import annotations

import torch

from graphcast_tpu_torch.fields import FieldSet
from graphcast_tpu_torch.models.base import WrapperPredictor


def infer_floating_dtype(fs: FieldSet) -> torch.dtype:
  """The single floating dtype of a FieldSet (reference: casting.py:120)."""
  dtypes = {f.data.dtype for f in fs.values() if f.data.is_floating_point()}
  if len(dtypes) != 1:
    raise ValueError(f"expected one floating dtype, found {dtypes}")
  return dtypes.pop()


class Bfloat16Cast(WrapperPredictor):
  """Wrapper casting to bf16 in, target dtype out."""

  def __init__(self, predictor, enabled: bool = True):
    super().__init__(predictor)
    self._enabled = enabled

  def precompute_step_statics(self, inputs: FieldSet) -> dict:
    # Hoisted statics are consumed inside the bf16 region.
    if self._enabled:
      inputs = inputs.astype(torch.bfloat16)
    return self._predictor.precompute_step_statics(inputs)

  def forward(self, inputs, targets_template, forcings, **kwargs):
    if not self._enabled:
      return self._predictor(inputs, targets_template, forcings, **kwargs)
    target_dtype = infer_floating_dtype(targets_template)
    predictions = self._predictor(
        inputs.astype(torch.bfloat16),
        targets_template.astype(torch.bfloat16),
        forcings.astype(torch.bfloat16), **kwargs)
    pred_dtype = infer_floating_dtype(predictions)
    if pred_dtype != torch.bfloat16:
      raise ValueError(f"inner predictor must output bf16, got {pred_dtype}")
    return predictions.astype(target_dtype)

  def loss(self, inputs, targets, forcings, **kwargs):
    if not self._enabled:
      return self._predictor.loss(inputs, targets, forcings, **kwargs)
    # The loss is reduced in f32 regardless (losses.py casts to f32).
    return self._predictor.loss(
        inputs.astype(torch.bfloat16), targets.astype(torch.bfloat16),
        forcings.astype(torch.bfloat16), **kwargs)

  def loss_and_predictions(self, inputs, targets, forcings, **kwargs):
    if not self._enabled:
      return self._predictor.loss_and_predictions(inputs, targets, forcings,
                                                  **kwargs)
    target_dtype = infer_floating_dtype(targets)
    loss, predictions = self._predictor.loss_and_predictions(
        inputs.astype(torch.bfloat16), targets.astype(torch.bfloat16),
        forcings.astype(torch.bfloat16), **kwargs)
    return loss, predictions.astype(target_dtype)
