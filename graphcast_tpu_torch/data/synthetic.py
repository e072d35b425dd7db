"""Synthetic data for tests, benchmarks and random-weights runs.

Port of graphcast_tpu/data/synthetic.py: the same numpy draws from the same
seed (tests/test_torch_rollout.py holds the arrays equal), handed back as
FieldSets of tensors on ``device``: the card unless the caller asks for
"cpu". The port adds ``make_era5_dataset``, an ERA5-shaped time series
drawn on the device, for the data pipeline of data/era5.py.
"""

from __future__ import annotations

import numpy as np
import torch

from graphcast_tpu_torch import devices
from graphcast_tpu_torch.fields import Field, FieldSet, from_numpy
from graphcast_tpu_torch.models import configs


def grid_coords(resolution: float, include_poles: bool = True):
  """lat/lon coordinate vectors for a global grid of the given resolution."""
  if include_poles:
    lat = np.arange(-90.0, 90.0 + resolution / 2, resolution)
  else:
    lat = np.arange(-90.0 + resolution / 2, 90.0, resolution)
  lon = np.arange(0.0, 360.0, resolution)
  return lat.astype(np.float32), lon.astype(np.float32)


def _random_field(rng, shape, dtype=np.float32):
  return rng.randn(*shape).astype(dtype)


def make_example_batch(
    task_config: configs.TaskConfig,
    resolution: float,
    batch: int = 1,
    num_input_times: int = 2,
    num_target_times: int = 1,
    time_step_hours: int = 6,
    seed: int = 0,
    dtype=np.float32,
    device: torch.device | str = devices.DEFAULT_DEVICE,
) -> tuple[FieldSet, FieldSet, FieldSet]:
  """Returns (inputs, targets, forcings) for the task, random data.

  Lead time 0h = last input frame; inputs at [-(n-1)Δ, ..., 0],
  targets/forcings at [Δ, ..., TΔ] (reference: data_utils.py:212-290).
  """
  device = devices.resolve(device)
  rng = np.random.RandomState(seed)
  lat, lon = grid_coords(resolution)
  nlat, nlon = lat.shape[0], lon.shape[0]
  levels = np.asarray(task_config.pressure_levels, np.int32)
  nlev = levels.shape[0]

  step = np.timedelta64(time_step_hours, "h")
  input_times = (np.arange(-(num_input_times - 1), 1) * step)
  target_times = (np.arange(1, num_target_times + 1) * step)

  def build(names, times, include_statics):
    fields = {}
    nt = times.shape[0]
    for name in names:
      if name in configs.STATIC_VARS:
        if include_statics:
          fields[name] = (_random_field(rng, (nlat, nlon), dtype),
                          ("lat", "lon"))
        continue
      if name in configs.ALL_ATMOSPHERIC_VARS:
        fields[name] = (_random_field(rng, (batch, nt, nlev, nlat, nlon),
                                      dtype),
                        ("batch", "time", "level", "lat", "lon"))
      else:
        fields[name] = (_random_field(rng, (batch, nt, nlat, nlon), dtype),
                        ("batch", "time", "lat", "lon"))
    return from_numpy(fields, coords={
        "lat": lat, "lon": lon, "level": levels,
        "time": times.astype("timedelta64[ns]")}).to(device)

  inputs = build(task_config.input_variables, input_times,
                 include_statics=True)
  targets = build(task_config.target_variables, target_times,
                  include_statics=False)
  forcings = build(task_config.forcing_variables, target_times,
                   include_statics=False)
  return inputs, targets, forcings


def make_norm_stats(task_config: configs.TaskConfig, seed: int = 1,
                    device: torch.device | str = devices.DEFAULT_DEVICE):
  """Random-but-positive per-variable normalization stats FieldSets:
  (stddev_by_level, mean_by_level, diffs_stddev_by_level)."""
  device = devices.resolve(device)
  rng = np.random.RandomState(seed)
  levels = np.asarray(task_config.pressure_levels, np.float32)
  var_names = set(task_config.input_variables) | set(
      task_config.target_variables) | set(task_config.forcing_variables)

  def build(offset):
    fields = {}
    for name in sorted(var_names):
      if name in configs.ALL_ATMOSPHERIC_VARS:
        fields[name] = (
            rng.rand(levels.shape[0]).astype(np.float32) + offset,
            ("level",))
      else:
        fields[name] = (np.float32(rng.rand() + offset).reshape(()), ())
    return from_numpy(fields, coords={"level": levels}).to(device)

  return build(0.5), build(0.0), build(0.5)


def make_era5_dataset(
    task_config: configs.TaskConfig,
    resolution: float,
    num_times: int,
    batch: int = 1,
    start: str = "2022-01-01T00:00",
    time_step_hours: int = 6,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = devices.DEFAULT_DEVICE,
) -> FieldSet:
  """An ERA5-shaped time series for the task, random data drawn on
  ``device`` from a ``torch.Generator`` seeded with ``seed``: the port's
  stand-in for an ERA5 slice (the reference demos' ``source-era5_...nc``
  datasets), the input of data/era5.py.

  Holds every variable of the task but the derived ones (the progress
  features and TOA incident solar radiation, which ``era5.add_derived_vars``
  and ``era5.add_tisr_var`` compute): atmospheric variables (batch, time,
  level, lat, lon) at the task's pressure levels, surface variables
  (batch, time, lat, lon), statics (lat, lon). Coords: lat, lon, level,
  "time" (timedelta64[ns] from 0, ``time_step_hours`` apart) and "datetime"
  [batch, time] (datetime64[ns] from ``start``).
  """
  device = devices.resolve(device)
  from graphcast_tpu_torch.data import era5
  names = sorted((set(task_config.input_variables)
                  | set(task_config.target_variables)
                  | set(task_config.forcing_variables))
                 - era5.DERIVED_VARS - {era5.TISR})
  lat, lon = grid_coords(resolution)
  nlat, nlon = lat.shape[0], lon.shape[0]
  levels = np.asarray(task_config.pressure_levels, np.int32)
  gen = torch.Generator(device=device).manual_seed(seed)
  fields = {}
  for name in names:
    if name in configs.STATIC_VARS:
      shape, dims = (nlat, nlon), ("lat", "lon")
    elif name in configs.ALL_ATMOSPHERIC_VARS:
      shape = (batch, num_times, levels.shape[0], nlat, nlon)
      dims = ("batch", "time", "level", "lat", "lon")
    else:
      shape, dims = (batch, num_times, nlat, nlon), ("batch", "time", "lat",
                                                     "lon")
    fields[name] = Field(torch.randn(shape, generator=gen, device=device,
                                     dtype=dtype), dims)
  time = (np.arange(num_times) * np.timedelta64(time_step_hours, "h")).astype(
      "timedelta64[ns]")
  datetime = np.broadcast_to(np.datetime64(start, "ns") + time,
                             (batch, num_times)).copy()
  return FieldSet(fields, coords={"lat": lat, "lon": lon, "level": levels,
                                  "time": time, "datetime": datetime})
