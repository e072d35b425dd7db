"""Long-horizon inference rollouts (port of graphcast_tpu/rollout.py;
reference: graphcast/rollout.py).

The multi-step rollout of a one-step predictor is wrappers.Autoregressive.
This module holds the chunked forms, a Python loop over chunks of a
predictor that feeds each chunk's predictions back as the next inputs:

- ``chunked_prediction_generator`` / ``chunked_prediction``: every chunk is
  called with the first chunk's time coordinates, and the yielded
  predictions are re-stamped with their own target times (equispaced
  targets only);
- ``chunked_ensemble_prediction``: N members as the batch axis
  (``tile_batch``), each drawing its own noise inside a probabilistic
  predictor (GenCast).

Randomness: the JAX package splits a key per chunk and hands the predictor
``rng=``. Here one ``torch.Generator`` is handed to every call as
``generator=`` and is drawn from in chunk order; a deterministic predictor
(GraphCast) is called with ``generator=None`` and takes none. The chunks run
under ``torch.inference_mode()``. The JAX package's ``mesh=`` (members
sharded over devices) and ``carry_constraint`` are not ported:
``chunked_ensemble_prediction(mesh=...)`` raises NotImplementedError.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np
import torch

from graphcast_tpu_torch.fields import Field, FieldSet

# predictor_fn(inputs=, targets_template=, forcings=[, generator=]) ->
# predictions
PredictorFn = Callable[..., FieldSet]


def _strip_time(fs: FieldSet) -> FieldSet:
  return fs.assign_coords(time=None)


def get_next_inputs(prev_inputs: FieldSet, predictions: FieldSet,
                    forcings: FieldSet) -> FieldSet:
  """Rolls the input window forward with predictions + forcings
  (reference: rollout.py:379-401)."""
  time_dep_names = [n for n in prev_inputs.var_names
                    if "time" in prev_inputs[n].dims]
  constant = prev_inputs.drop(time_dep_names)
  window = prev_inputs.select(time_dep_names)
  num_times = window.sizes["time"]
  next_frames = FieldSet.merge(
      [_strip_time(predictions), _strip_time(forcings)]).select(
          time_dep_names)
  merged = FieldSet.concat([_strip_time(window), next_frames], "time")
  return FieldSet.merge([constant,
                         merged.isel(time=slice(-num_times, None))])


def _check_equispaced(target_times):
  """The chunks reuse the first chunk's time coordinates, which is right
  only for evenly spaced targets (reference: rollout.py:302-303)."""
  if target_times is None or len(np.atleast_1d(target_times)) <= 1:
    return
  diffs = np.diff(np.atleast_1d(target_times))
  if np.issubdtype(diffs.dtype, np.inexact):
    equispaced = np.allclose(diffs, diffs.flat[0], rtol=1e-6, atol=0.0)
  else:
    equispaced = np.unique(diffs).size <= 1
  if not equispaced:
    raise ValueError(
        "targets_template time coordinates must be evenly spaced for "
        f"chunked prediction; got {target_times!r}")


def chunked_prediction_generator(
    predictor_fn: PredictorFn,
    generator: Optional[torch.Generator],
    inputs: FieldSet,
    targets_template: FieldSet,
    forcings: FieldSet,
    num_steps_per_chunk: int = 1,
    pull_to_host: bool = True,
) -> Iterator[FieldSet]:
  """Yields each chunk's predictions and feeds them back as the next inputs
  (graphcast_tpu/rollout.py:51-139). ``pull_to_host`` moves the yielded
  predictions to the CPU; the carried inputs stay on their device."""
  num_target_steps = targets_template.sizes["time"]
  if num_target_steps % num_steps_per_chunk:
    raise ValueError(
        f"num_steps_per_chunk {num_steps_per_chunk} must divide the "
        f"{num_target_steps} target steps")
  target_times = targets_template.coords.get("time")
  _check_equispaced(target_times)
  # Wall-clock "datetime" coords differ per chunk: strip them from what the
  # predictor sees and re-stamp the yields (reference: rollout.py:283-293).
  target_datetimes = targets_template.coords.get("datetime")
  inputs = inputs.assign_coords(datetime=None)
  targets_template = targets_template.assign_coords(datetime=None)
  forcings = _strip_time(forcings.assign_coords(datetime=None))
  chunk_template = _strip_time(
      targets_template.isel(time=slice(0, num_steps_per_chunk)))
  kwargs = {} if generator is None else {"generator": generator}
  current_inputs = inputs
  for t0 in range(0, num_target_steps, num_steps_per_chunk):
    chunk_forcings = forcings.isel(time=slice(t0, t0 + num_steps_per_chunk))
    with torch.inference_mode():
      predictions = predictor_fn(inputs=current_inputs,
                                 targets_template=chunk_template,
                                 forcings=chunk_forcings, **kwargs)
      current_inputs = get_next_inputs(current_inputs, predictions,
                                       chunk_forcings)
    if pull_to_host:
      predictions = predictions.to("cpu")
    if target_times is not None:
      predictions = predictions.assign_coords(
          time=target_times[t0:t0 + num_steps_per_chunk])
    if target_datetimes is not None:
      predictions = predictions.assign_coords(
          datetime=np.atleast_1d(target_datetimes)[
              ..., t0:t0 + num_steps_per_chunk])
    yield predictions


def chunked_prediction(
    predictor_fn: PredictorFn,
    generator: Optional[torch.Generator],
    inputs: FieldSet,
    targets_template: FieldSet,
    forcings: FieldSet,
    num_steps_per_chunk: int = 1,
    pull_to_host: bool = True,
) -> FieldSet:
  """All chunks concatenated along time (reference: rollout.py:205-242)."""
  out = FieldSet.concat(list(chunked_prediction_generator(
      predictor_fn, generator, inputs, targets_template, forcings,
      num_steps_per_chunk, pull_to_host)), "time")
  for name in ("time", "datetime"):
    value = targets_template.coords.get(name)
    if value is not None:
      out = out.assign_coords(**{name: value})
  return out


def tile_batch(fs: FieldSet, factor: int) -> FieldSet:
  """Repeats every batched variable along the batch axis, each element
  ``factor`` times in a row (the ensemble fan-out, jnp.repeat)."""
  def fn(name, f):
    if "batch" not in f.dims:
      return f
    return Field(torch.repeat_interleave(f.data, factor,
                                         dim=f.dims.index("batch")), f.dims)
  return fs.map(fn)


def chunked_ensemble_prediction(
    predictor_fn: PredictorFn,
    generator: Optional[torch.Generator],
    inputs: FieldSet,
    targets_template: FieldSet,
    forcings: FieldSet,
    num_samples: int,
    mesh=None,
    num_steps_per_chunk: int = 1,
    pull_to_host: bool = True,
) -> FieldSet:
  """Ensemble inference: ``num_samples`` members as the batch axis, each
  with its own noise inside the predictor (graphcast_tpu/rollout.py:
  176-214). Returns predictions of batch ``input_batch * num_samples``,
  the members of each input together. ``mesh`` (sharding the members over
  devices) is not ported."""
  if mesh is not None:
    raise NotImplementedError(
        "chunked_ensemble_prediction(mesh=...): sharding members over "
        "devices is not ported")
  return chunked_prediction(
      predictor_fn, generator, tile_batch(inputs, num_samples),
      tile_batch(targets_template, num_samples),
      tile_batch(forcings, num_samples),
      num_steps_per_chunk=num_steps_per_chunk, pull_to_host=pull_to_host)


def extend_targets_template(targets_template: FieldSet,
                            required_num_steps: int) -> FieldSet:
  """Extends a template along time to `required_num_steps`, zero-filled
  (reference: rollout.py:404-461)."""
  current = targets_template.sizes["time"]
  if current >= required_num_steps:
    return targets_template.isel(time=slice(0, required_num_steps))
  fields = {}
  for name in targets_template.var_names:
    f = targets_template[name]
    shape = list(f.shape)
    shape[f.dims.index("time")] = required_num_steps
    fields[name] = Field(
        torch.zeros(shape, dtype=f.dtype, device=f.data.device), f.dims)
  coords = targets_template.coords
  if "time" in coords and current >= 2:
    t = coords["time"]
    coords["time"] = t[0] + (t[1] - t[0]) * np.arange(required_num_steps)
  elif "time" in coords and current == 1:
    coords["time"] = coords["time"][0] * np.arange(1, required_num_steps + 1)
  return FieldSet(fields, coords=coords)
