"""The Predictor interface (port of graphcast_tpu/models/base.py).

A predictor is an ``nn.Module`` that maps FieldSets with (batch, time,
[level,] lat, lon) dims to a prediction:

- ``inputs``: the state at input times (time ≤ 0 lead), plus static vars;
- ``targets_template``: shapes/coords of what to predict (data unused);
- ``forcings``: externally-specified values at the target times.

Training: ``loss`` and ``loss_and_predictions`` take ``targets`` (data
used) in place of the template and return ``(loss [batch], {var:
[batch]})``, the JAX package's ``LossAndDiagnostics``.

Parameters live in the modules (f32 masters). The JAX package's ``rng``
argument becomes a keyword argument where a predictor draws random numbers:
GenCast's sampler and loss take ``generator=torch.Generator``; GraphCast is
deterministic and takes none.
"""

from __future__ import annotations

import abc

from torch import nn

from graphcast_tpu_torch.fields import FieldSet
from graphcast_tpu_torch.losses import LossAndDiagnostics


class Predictor(nn.Module, abc.ABC):
  """A one-or-multi-step weather predictor over FieldSets."""

  @abc.abstractmethod
  def forward(self, inputs: FieldSet, targets_template: FieldSet,
              forcings: FieldSet, **kwargs) -> FieldSet:
    """Predicts targets matching targets_template."""

  def loss(self, inputs: FieldSet, targets: FieldSet, forcings: FieldSet,
           **kwargs) -> LossAndDiagnostics:
    """Training loss: (loss [batch], {var: [batch]})."""
    raise NotImplementedError(f"{type(self).__name__} does not implement loss")

  def loss_and_predictions(
      self, inputs: FieldSet, targets: FieldSet, forcings: FieldSet,
      **kwargs) -> tuple[LossAndDiagnostics, FieldSet]:
    """The loss and the predictions it was taken on; needed for AR training
    (reference: predictor_base.py:133-170)."""
    raise NotImplementedError(
        f"{type(self).__name__} does not implement loss_and_predictions")

  def precompute_step_statics(self, inputs: FieldSet) -> dict:
    """kwargs holding values that are constant across autoregressive steps
    (e.g. embedded static edge features), computed once before a rollout.
    {} when the model has nothing to hoist."""
    del inputs
    return {}


class WrapperPredictor(Predictor):
  """Base for wrappers around an inner predictor."""

  def __init__(self, predictor: Predictor):
    super().__init__()
    self._predictor = predictor

  def precompute_step_statics(self, inputs: FieldSet) -> dict:
    return self._predictor.precompute_step_statics(inputs)
