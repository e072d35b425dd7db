"""Autoregressive multi-step wrapper (port of graphcast_tpu/wrappers/
autoregressive.py; reference: autoregressive.py:39-312).

A one-step predictor is unrolled over the target times by a Python loop
(the JAX package's ``lax.scan``): the rolling input window is the loop
carry, and each step takes its own forcings time slice.

- Inference (``forward``, ``rollout_final``) runs under
  ``torch.inference_mode()`` and hoists the values constant across steps
  once (``precompute_step_statics``).
- Training (``loss``, ``loss_and_predictions``) feeds each step's
  predictions back as inputs and averages the per-step losses over time.
  It hoists nothing: the static edge parts are functions of the parameters,
  so each step computes its own. With ``gradient_checkpointing`` every AR
  step of a multi-step loss is a ``torch.utils.checkpoint`` region: only
  the carried windows are kept, and each step's forward is recomputed in
  the backward.

The JAX package's XLA- and TPU-memory forms of the loss scan
(``loss_scan_unroll``, ``loss_scan_block``, ``loss_carry_offload``,
``loss_offload_processor_carries``) are not ported and raise
NotImplementedError when set.
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint

from graphcast_tpu_torch.fields import Field, FieldSet
from graphcast_tpu_torch.models.base import Predictor, WrapperPredictor


def _split_constant_inputs(inputs: FieldSet, targets: FieldSet,
                           forcings: FieldSet):
  """Constant (timeless) inputs vs time-dependent ones
  (reference: autoregressive.py:88-98)."""
  constant_names = [n for n in inputs.var_names
                    if n not in targets and n not in forcings]
  for name in constant_names:
    if "time" in inputs[name].dims:
      raise ValueError(
          f"time-dependent input {name!r} must be a forcing or target "
          "variable to allow autoregressive feedback")
  return inputs.select(constant_names), inputs.drop(constant_names)


def _validate(targets: FieldSet, forcings: FieldSet):
  for name in targets.var_names:
    if "time" not in targets[name].dims:
      raise ValueError(f"target {name!r} must be time-dependent")
  for name in forcings.var_names:
    if "time" not in forcings[name].dims:
      raise ValueError(f"forcing {name!r} must be time-dependent")
  overlap = set(targets.var_names) & set(forcings.var_names)
  if overlap:
    raise ValueError(f"variables are both targets and forcings: {overlap}")


def _prepare(inputs: FieldSet, targets: FieldSet, forcings: FieldSet):
  """(constant inputs, input window, targets, forcings), validated, with
  the time coords stripped so every step sees the same ones (reference:
  autoregressive.py:121-125)."""
  constant_inputs, window = _split_constant_inputs(inputs, targets, forcings)
  _validate(targets, forcings)
  return (constant_inputs, window.assign_coords(time=None),
          targets.assign_coords(time=None), forcings.assign_coords(time=None))


def _update_window(window: FieldSet, next_frame: FieldSet) -> FieldSet:
  """Appends the new frame, keeps the trailing `num_input_times` frames
  (reference: autoregressive.py:114-125)."""
  num_times = window.sizes["time"]
  merged = FieldSet.concat(
      [window, next_frame.select(list(window.var_names))], "time")
  return merged.isel(time=slice(-num_times, None))


def _stack_time(steps: list[FieldSet], template: FieldSet) -> FieldSet:
  """Per-step one-time predictions → one FieldSet along "time"."""
  fields = {}
  for name in template.var_names:
    tf = template[name]
    t_axis = tf.dims.index("time")
    fields[name] = Field(torch.cat([p[name].data for p in steps], dim=t_axis),
                         tf.dims)
  return FieldSet(fields, coords=template.coords)


class Autoregressive(WrapperPredictor):
  """Multi-step predictor from a one-step predictor."""

  def __init__(self, predictor: Predictor,
               gradient_checkpointing: bool = False,
               loss_scan_unroll: int = 1, loss_scan_block: int = 1,
               loss_carry_offload: bool = False,
               loss_offload_processor_carries: bool = False):
    super().__init__(predictor)
    unported = {"loss_scan_unroll": loss_scan_unroll != 1,
                "loss_scan_block": loss_scan_block != 1,
                "loss_carry_offload": loss_carry_offload,
                "loss_offload_processor_carries":
                    loss_offload_processor_carries}
    for name, value in unported.items():
      if value:
        raise NotImplementedError(f"Autoregressive({name}=...) is not ported")
    self._gradient_checkpointing = gradient_checkpointing

  def _steps(self, inputs, targets_template, forcings, num_steps, kwargs):
    """Yields (step's predictions, window after the step)."""
    kwargs = {**kwargs, **self.precompute_step_statics(inputs)}
    constant_inputs, window, targets_template, forcings = _prepare(
        inputs, targets_template, forcings)
    template_1 = targets_template.isel(time=slice(0, 1))
    for t in range(num_steps):
      forcings_t = forcings.isel(time=slice(t, t + 1))
      all_inputs = FieldSet.merge([constant_inputs, window])
      predictions = self._predictor(all_inputs, template_1, forcings_t,
                                    **kwargs)
      window = _update_window(
          window, FieldSet.merge([predictions, forcings_t]))
      yield predictions, window

  @torch.inference_mode()
  def forward(self, inputs, targets_template, forcings, **kwargs):
    """Predictions at every target time, stacked along "time"."""
    num_steps = targets_template.sizes["time"]
    return _stack_time([p for p, _ in self._steps(
        inputs, targets_template, forcings, num_steps, kwargs)],
                       targets_template)

  @torch.inference_mode()
  def rollout_final(self, inputs, targets_template, forcings,
                    **kwargs) -> FieldSet:
    """Runs the full rollout but returns only the final input window (the
    state at the last lead time), keeping memory flat in the number of
    steps. The number of steps is the forcings' time length, so
    targets_template needs only one timestep."""
    window = None
    for _, window in self._steps(inputs, targets_template, forcings,
                                 forcings.sizes["time"], kwargs):
      pass
    return window

  def loss(self, inputs, targets, forcings, **kwargs):
    if targets.sizes["time"] == 1:
      # No feedback: delegate (reference: autoregressive.py:231-236).
      return self._predictor.loss(inputs, targets, forcings, **kwargs)
    loss, _ = self._loss_loop(inputs, targets, forcings, kwargs,
                              want_predictions=False)
    return loss

  def loss_and_predictions(self, inputs, targets, forcings, **kwargs):
    return self._loss_loop(inputs, targets, forcings, kwargs)

  def _loss_loop(self, inputs, targets, forcings, kwargs,
                 want_predictions=True):
    """The AR loss: per-step loss_and_predictions with feedback, averaged
    over time (reference: autoregressive.py:239-312)."""
    constant_inputs, window, targets_nc, forcings = _prepare(
        inputs, targets, forcings)
    num_steps = targets.sizes["time"]

    def step(window, targets_t, forcings_t):
      all_inputs = FieldSet.merge([constant_inputs, window])
      loss, predictions = self._predictor.loss_and_predictions(
          all_inputs, targets_t, forcings_t, **kwargs)
      next_window = _update_window(
          window, FieldSet.merge([predictions, forcings_t]))
      return loss, predictions, next_window

    losses, diagnostics, preds = [], [], []
    for t in range(num_steps):
      args = (window, targets_nc.isel(time=slice(t, t + 1)),
              forcings.isel(time=slice(t, t + 1)))
      if self._gradient_checkpointing and num_steps > 1:
        (loss, diag), predictions, window = checkpoint.checkpoint(
            step, *args, use_reentrant=False)
      else:
        (loss, diag), predictions, window = step(*args)
      losses.append(loss)
      diagnostics.append(diag)
      if want_predictions:
        preds.append(predictions)
    loss = torch.stack(losses).mean(0)
    diagnostics = {k: torch.stack([d[k] for d in diagnostics]).mean(0)
                   for k in diagnostics[0]}
    if not want_predictions:
      return (loss, diagnostics), None
    return (loss, diagnostics), _stack_time(preds, targets)
