"""Dataset preparation: derived forcings + train/eval splitting.

Port of graphcast_tpu/data/era5.py (reference: data_utils.py) over the
port's FieldSets, with numpy ``datetime64``/``timedelta64`` where the JAX
package uses pandas:

- year/day progress features (sin/cos, per-longitude phase for day
  progress), computed in numpy float32 exactly as the JAX package does and
  put on the dataset's device (data_utils.py:51-133);
- derived-variable injection incl. TOA incident solar radiation, which is
  computed on the dataset's device (data_utils.py:135-210);
- extraction of (inputs, targets, forcings) given an input duration and
  target lead times, shifting time coords so lead time 0 is the last input
  frame (data_utils.py:212-359). Forcings are taken from the *target*
  timesteps (the model may not see future ground truth).

Datetime handling: FieldSets carry a "datetime" coord of shape [batch,
time] (np.datetime64) alongside the relative "time" coord (timedelta64).
Durations are strings ("6h", "12h"), ``datetime.timedelta`` or
``np.timedelta64`` (data/durations.py).
"""

from __future__ import annotations

import datetime
from typing import Sequence, Union

import numpy as np
import torch

from graphcast_tpu_torch.data import durations, solar_radiation
from graphcast_tpu_torch.fields import Field, FieldSet

_SEC_PER_HOUR = 3600
_HOUR_PER_DAY = 24
SEC_PER_DAY = _SEC_PER_HOUR * _HOUR_PER_DAY
_AVG_DAY_PER_YEAR = 365.24219
AVG_SEC_PER_YEAR = SEC_PER_DAY * _AVG_DAY_PER_YEAR

DAY_PROGRESS = "day_progress"
YEAR_PROGRESS = "year_progress"
TISR = "toa_incident_solar_radiation"

DERIVED_VARS = {
    DAY_PROGRESS, f"{DAY_PROGRESS}_sin", f"{DAY_PROGRESS}_cos",
    YEAR_PROGRESS, f"{YEAR_PROGRESS}_sin", f"{YEAR_PROGRESS}_cos",
}

TimedeltaLike = Union[str, datetime.timedelta, np.timedelta64]
TargetLeadTimes = Union[TimedeltaLike, Sequence[TimedeltaLike], slice]


def _device(data: FieldSet) -> torch.device:
  return next(iter(data.values())).data.device


def get_year_progress(seconds_since_epoch: np.ndarray) -> np.ndarray:
  """Year progress in [0, 1) (reference: data_utils.py:51-72)."""
  years_since_epoch = (
      seconds_since_epoch / SEC_PER_DAY / np.float64(_AVG_DAY_PER_YEAR))
  return np.mod(years_since_epoch, 1.0).astype(np.float32)


def get_day_progress(seconds_since_epoch: np.ndarray,
                     longitude: np.ndarray) -> np.ndarray:
  """Day progress in [0, 1) per longitude (reference: data_utils.py:74-101).

  Returns array of shape seconds.shape + (num_longitudes,).
  """
  day_progress_greenwich = (
      np.mod(seconds_since_epoch, SEC_PER_DAY) / SEC_PER_DAY)
  longitude_offsets = np.deg2rad(longitude) / (2 * np.pi)
  return np.mod(day_progress_greenwich[..., np.newaxis] + longitude_offsets,
                1.0).astype(np.float32)


def featurize_progress(name: str, dims: tuple[str, ...],
                       progress: np.ndarray,
                       device: torch.device | str = "cpu"
                       ) -> dict[str, Field]:
  """progress plus sin/cos features, computed in numpy and put on
  ``device`` (reference: data_utils.py:103-133)."""
  if len(dims) != progress.ndim:
    raise ValueError(f"dims {dims} don't match data ndim {progress.ndim}")
  phase = progress * (2 * np.pi)

  def field(a):
    return Field(torch.from_numpy(np.ascontiguousarray(a)).to(device), dims)

  return {
      name: field(progress),
      f"{name}_sin": field(np.sin(phase).astype(np.float32)),
      f"{name}_cos": field(np.cos(phase).astype(np.float32)),
  }


def _seconds_since_epoch(datetimes: np.ndarray) -> np.ndarray:
  return (datetimes.astype("datetime64[s]").astype(np.int64)).astype(
      np.float64)


def add_derived_vars(data: FieldSet) -> FieldSet:
  """Adds year/day progress features (reference: data_utils.py:135-179).

  Requires coords: "datetime" [batch, time] and "lon".
  """
  coords = data.coords
  if "datetime" not in coords or "lon" not in coords:
    raise ValueError("add_derived_vars requires 'datetime' and 'lon' coords")
  seconds = _seconds_since_epoch(coords["datetime"])  # [batch, time]
  lon = coords["lon"]
  device = _device(data)

  fields: dict[str, Field] = {}
  year_progress = get_year_progress(seconds)
  fields.update(featurize_progress(
      YEAR_PROGRESS, ("batch", "time"), year_progress, device))
  day_progress = get_day_progress(seconds, lon)
  fields.update(featurize_progress(
      DAY_PROGRESS, ("batch", "time", "lon"), day_progress, device))
  # Don't overwrite existing variables (reference behavior).
  new = {k: v for k, v in fields.items() if k not in data}
  return FieldSet.merge([data, FieldSet(new, coords=coords)])


def add_tisr_var(data: FieldSet,
                 integration_period: TimedeltaLike = "1h") -> FieldSet:
  """Adds TOA incident solar radiation, computed on the dataset's device
  for every (batch, time) at once (reference: data_utils.py:181-210)."""
  if TISR in data:
    return data
  coords = data.coords
  datetimes = coords["datetime"]  # [batch, time]
  tisr = solar_radiation.get_toa_incident_solar_radiation(
      datetimes.reshape(-1), coords["lat"], coords["lon"],
      integration_period=integration_period, device=_device(data))
  tisr = tisr.reshape(datetimes.shape + tisr.shape[1:])
  return FieldSet.merge([data, FieldSet(
      {TISR: Field(tisr, ("batch", "time", "lat", "lon"))}, coords=coords)])


def _process_target_lead_times(target_lead_times: TargetLeadTimes,
                               step: np.timedelta64):
  """Normalizes lead-time spec; returns (list of timedelta64[ns], max
  duration) (reference: data_utils.py:293-316)."""
  td = durations.to_timedelta64
  if isinstance(target_lead_times, slice):
    start = (td(target_lead_times.start)
             if target_lead_times.start is not None else step)
    stop = td(target_lead_times.stop)
    leads = []
    t = start
    while t <= stop + np.timedelta64(1, "ns"):
      leads.append(t)
      t = t + step
    return leads, stop
  if isinstance(target_lead_times,
                (str, datetime.timedelta, np.timedelta64)):
    lead = td(target_lead_times)
    return [lead], lead
  leads = sorted(td(t) for t in target_lead_times)
  return leads, leads[-1]


def extract_input_target_times(
    dataset: FieldSet,
    input_duration: TimedeltaLike,
    target_lead_times: TargetLeadTimes,
) -> tuple[FieldSet, FieldSet]:
  """Splits a time series into input and target windows
  (reference: data_utils.py:212-290).

  Time coords are shifted so that lead time 0 = the final input frame.
  """
  time = np.asarray(dataset.coords["time"]).astype("timedelta64[ns]")
  if len(time) > 1:
    step = time[1] - time[0]
  else:
    step = np.timedelta64(6, "h").astype("timedelta64[ns]")
  leads, target_duration = _process_target_lead_times(target_lead_times, step)

  # Shift: final timestep of the dataset is at lead target_duration.
  shifted = time + (target_duration - time[-1])

  target_idx = []
  for lead in leads:
    matches = np.nonzero(np.abs(shifted - lead) < np.timedelta64(1, "s"))[0]
    if matches.size != 1:
      raise ValueError(f"lead time {lead} not found in dataset times")
    target_idx.append(int(matches[0]))

  input_duration = durations.to_timedelta64(input_duration)
  zero = np.timedelta64(0, "ns")
  input_mask = (shifted <= zero) & (shifted > -input_duration)
  input_idx = np.nonzero(input_mask)[0]

  dataset = dataset.assign_coords(time=shifted)
  if "datetime" in dataset.coords:
    dt = dataset.coords["datetime"]
    inputs = dataset.isel(time=input_idx).assign_coords(
        datetime=dt[:, input_idx])
    targets = dataset.isel(time=np.asarray(target_idx)).assign_coords(
        datetime=dt[:, target_idx])
  else:
    inputs = dataset.isel(time=input_idx)
    targets = dataset.isel(time=np.asarray(target_idx))
  return inputs, targets


def extract_inputs_targets_forcings(
    dataset: FieldSet,
    *,
    input_variables: Sequence[str],
    target_variables: Sequence[str],
    forcing_variables: Sequence[str],
    pressure_levels: Sequence[int],
    input_duration: TimedeltaLike,
    target_lead_times: TargetLeadTimes,
) -> tuple[FieldSet, FieldSet, FieldSet]:
  """The main train/eval splitting entry point
  (reference: data_utils.py:319-359)."""
  if "level" in dataset.coords:
    level = dataset.coords["level"]
    sel = [int(np.nonzero(level == p)[0][0]) for p in pressure_levels]
    dataset = dataset.isel(level=np.asarray(sel))

  overlap = set(forcing_variables) & set(target_variables)
  if overlap:
    raise ValueError(
        f"variables {overlap} are both targets and forcings")

  inputs, targets = extract_input_target_times(
      dataset, input_duration=input_duration,
      target_lead_times=target_lead_times)

  missing = set(input_variables) - set(dataset.var_names)
  if missing:
    raise ValueError(f"missing input variables: {missing}")

  inputs = inputs.select(
      [v for v in input_variables if v in inputs])
  # Forcings are taken from the TARGET timesteps (they are known analytically
  # in the future; reference: data_utils.py:348-357).
  forcings = targets.select(
      [v for v in forcing_variables if v in targets])
  targets = targets.select(list(target_variables))
  return inputs, targets, forcings
