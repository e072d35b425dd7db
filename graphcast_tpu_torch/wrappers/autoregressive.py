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
  step of a multi-step loss is a recompute region (nn/remat.py): only the
  carried windows are kept, and each step's forward is recomputed in the
  backward.

The JAX package's memory forms of the loss (autoregressive.py:84-164 and
:306-526 there), same math in each, checked as there:

- ``loss_scan_unroll``: the scan's unroll factor, which the JAX package
  clamps to [1, steps]. The port's loop runs eagerly, step after step, so
  no value changes a number or the memory; any is accepted, as there.
- ``loss_scan_block = k`` (1 < k < steps, k dividing steps): a recompute
  region around each block of k per-step regions, so that only the windows
  at block boundaries are kept.
- ``loss_carry_offload``: the carried windows wait for the backward in
  host memory (pinned where they come from the card). Block 1: every
  step's window (the JAX host-carry scan); 1 < block < steps: block
  boundaries kept, the windows inside a block on the host; block ≥ steps:
  one region around all the steps, every window after the first on the
  host (the JAX unrolled form).
- ``loss_offload_processor_carries``: during each AR step, the processor's
  √N block boundaries (nn/deep_gnn.py ``run_steps``, with
  ``remat_processor``) go to the host instead of staying on the card.

Copies to the host are exact, so every form gives the per-step
checkpointed loss and gradients bit for bit.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from graphcast_tpu_torch.fields import Field, FieldSet
from graphcast_tpu_torch.models.base import Predictor, WrapperPredictor
from graphcast_tpu_torch.nn import remat


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
    """The memory forms of the loss (module doc), validated as the JAX
    package validates them."""
    super().__init__(predictor)
    if loss_scan_block < 1:
      raise ValueError(f"loss_scan_block must be >= 1, got {loss_scan_block}")
    if loss_scan_block > 1 and not gradient_checkpointing:
      raise ValueError(
          "loss_scan_block > 1 requires gradient_checkpointing=True (the "
          "block level IS a checkpoint boundary)")
    if loss_carry_offload and not gradient_checkpointing:
      raise ValueError(
          "loss_carry_offload requires gradient_checkpointing=True (the "
          "offloaded carries are checkpoint residuals)")
    if loss_offload_processor_carries and not gradient_checkpointing:
      raise ValueError(
          "loss_offload_processor_carries requires "
          "gradient_checkpointing=True (the offloaded boundaries are "
          "checkpoint residuals)")
    del loss_scan_unroll  # no effect on an eager loop (module doc)
    self._gradient_checkpointing = gradient_checkpointing
    self._loss_scan_block = loss_scan_block
    self._loss_carry_offload = loss_carry_offload
    self._loss_offload_processor_carries = loss_offload_processor_carries

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
      self._check_processor_offload_applies(1)
      # No feedback: delegate (reference: autoregressive.py:231-236).
      return self._predictor.loss(inputs, targets, forcings, **kwargs)
    loss, _ = self._loss_loop(inputs, targets, forcings, kwargs,
                              want_predictions=False)
    return loss

  def loss_and_predictions(self, inputs, targets, forcings, **kwargs):
    return self._loss_loop(inputs, targets, forcings, kwargs)

  def _check_processor_offload_applies(self, num_steps):
    """The processor offload rides the per-AR-step recompute region, which
    exists only for num_steps > 1 (graphcast_tpu
    wrappers/autoregressive.py:306-318)."""
    if self._loss_offload_processor_carries and num_steps == 1:
      raise ValueError(
          "loss_offload_processor_carries has no effect for 1-step losses "
          "(there is no per-AR-step checkpoint to attach the offload "
          "policy to) — disable it, or train with multiple AR steps")

  def _loss_loop(self, inputs, targets, forcings, kwargs,
                 want_predictions=True):
    """The AR loss: per-step loss_and_predictions with feedback, averaged
    over time (reference: autoregressive.py:239-312), in the memory form
    the constructor chose (module doc)."""
    constant_inputs, window, targets_nc, forcings = _prepare(
        inputs, targets, forcings)
    num_steps = targets.sizes["time"]
    self._check_processor_offload_applies(num_steps)
    names = window.var_names
    k = self._loss_scan_block
    if k > 1 and num_steps > k and num_steps % k:
      raise ValueError(
          f"loss_scan_block={k} must divide the number of AR steps "
          f"({num_steps})")

    def step(t, *carry):
      """AR step t from the window's tensors (the carry): ((loss,
      diagnostics), predictions or None) and the next window's tensors."""
      window = FieldSet({n: Field(c, dims) for n, c, dims
                         in zip(names, carry, window_dims)},
                        coords=window_coords)
      forcings_t = forcings.isel(time=slice(t, t + 1))
      all_inputs = FieldSet.merge([constant_inputs, window])
      offload = (remat.offloading("mp_block_carry")
                 if self._loss_offload_processor_carries
                 else contextlib.nullcontext())
      with offload:
        loss, predictions = self._predictor.loss_and_predictions(
            all_inputs, targets_nc.isel(time=slice(t, t + 1)), forcings_t,
            **kwargs)
      next_window = _update_window(
          window, FieldSet.merge([predictions, forcings_t]))
      return ((loss, predictions if want_predictions else None),
              tuple(next_window[n].data for n in names))

    window_dims = [window[n].dims for n in names]
    window_coords = window.coords
    carry = tuple(window[n].data for n in names)
    checkpointed = self._gradient_checkpointing and num_steps > 1
    offload = self._loss_carry_offload and checkpointed

    def checkpointed_step(t, carry, on_host):
      with (remat.on_host() if on_host else contextlib.nullcontext()):
        return remat.checkpoint(functools.partial(step, t), *carry)

    outputs = []
    if checkpointed and (1 < k < num_steps or (offload and k > 1)):
      # Two-level: a region around each block of k per-step regions, the
      # windows inside a block on the host with loss_carry_offload.
      k = min(k, num_steps)

      def block(t0, *carry):
        ys = []
        for i in range(k):
          y, carry = checkpointed_step(t0 + i, carry, offload and i > 0)
          ys.append(y)
        return ys, carry

      for t0 in range(0, num_steps, k):
        ys, carry = remat.checkpoint(functools.partial(block, t0), *carry)
        outputs.extend(ys)
    else:
      for t in range(num_steps):
        if checkpointed:
          y, carry = checkpointed_step(t, carry, offload)
        else:
          y, carry = step(t, *carry)
        outputs.append(y)

    per_step = [loss_and_diagnostics for loss_and_diagnostics, _ in outputs]
    loss = torch.stack([loss for loss, _ in per_step]).mean(0)
    diagnostics = {n: torch.stack([d[n] for _, d in per_step]).mean(0)
                   for n in per_step[0][1]}
    if not want_predictions:
      return (loss, diagnostics), None
    return (loss, diagnostics), _stack_time([p for _, p in outputs], targets)
