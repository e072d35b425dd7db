"""Autoregressive multi-step wrapper (port of graphcast_tpu/wrappers/
autoregressive.py; reference: autoregressive.py:39-312), inference only.

A one-step predictor is unrolled over the target times by a Python loop
under ``torch.inference_mode()`` (the JAX package's ``lax.scan``): the
rolling input window is the loop carry, each step takes its own forcings
time slice, and values constant across steps are hoisted once
(``precompute_step_statics``).
"""

from __future__ import annotations

import torch

from graphcast_tpu_torch.fields import Field, FieldSet
from graphcast_tpu_torch.models.base import WrapperPredictor


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


def _update_window(window: FieldSet, next_frame: FieldSet) -> FieldSet:
  """Appends the new frame, keeps the trailing `num_input_times` frames
  (reference: autoregressive.py:114-125)."""
  num_times = window.sizes["time"]
  merged = FieldSet.concat(
      [window, next_frame.select(list(window.var_names))], "time")
  return merged.isel(time=slice(-num_times, None))


class Autoregressive(WrapperPredictor):
  """Multi-step predictor from a one-step predictor."""

  def _steps(self, inputs, targets_template, forcings, num_steps, kwargs):
    """Yields (step's predictions, window after the step)."""
    kwargs = {**kwargs, **self.precompute_step_statics(inputs)}
    constant_inputs, window = _split_constant_inputs(
        inputs, targets_template, forcings)
    _validate(targets_template, forcings)
    # Time coords are stripped so every step sees the same template
    # (reference: autoregressive.py:121-125).
    window = window.assign_coords(time=None)
    template_1 = targets_template.isel(
        time=slice(0, 1)).assign_coords(time=None)
    forcings = forcings.assign_coords(time=None)
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
    ys = [p for p, _ in self._steps(inputs, targets_template, forcings,
                                    num_steps, kwargs)]
    fields = {}
    for name in targets_template.var_names:
      tf = targets_template[name]
      t_axis = tf.dims.index("time")
      fields[name] = Field(torch.cat([p[name].data for p in ys], dim=t_axis),
                           tf.dims)
    return FieldSet(fields, coords=targets_template.coords)

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
