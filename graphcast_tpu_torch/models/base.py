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


def refuse_unported_forms(model: str, cache_dir=None, decode_chunks=1,
                          encode_chunks=1, fused_aggregation=None, **forms):
  """Raises NotImplementedError, naming the form, where a keyword of the JAX
  package's constructor asks for a form the port does not have. Accepted:
  ``cache_dir`` None or "" (no artifact cache), ``decode_chunks`` and
  ``encode_chunks`` 1, ``fused_aggregation`` None or True (the fused
  kernels, which the port always runs at batch 1). ``forms`` maps the name
  of any other form to whether the caller asked for it."""
  forms = {
      "the geometry artifact cache (cache_dir)": cache_dir not in (None, ""),
      f"chunked decode (decode_chunks={decode_chunks!r})": decode_chunks != 1,
      f"chunked encode (encode_chunks={encode_chunks!r})": encode_chunks != 1,
      f"fused_aggregation={fused_aggregation!r} (the XLA-only and split "
      "modes)": fused_aggregation not in (None, True),
      **forms}
  for form, asked in forms.items():
    if asked:
      raise NotImplementedError(f"{model}: {form} is not ported")


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
