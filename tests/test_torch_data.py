"""The port's data pipeline (data/era5.py, data/solar_radiation.py,
data/durations.py) against the JAX package's, which works on pandas: the
progress features bit-equal; extraction equal in its time coordinates, its
datetimes and every field; the TSI and days since J2000 equal; TOA
incident solar radiation within 1e-4 of the field's maximum with its zeros
(where the sun is down all window long) equal, over several dates
including a leap day; the duration strings as pandas reads them."""

import datetime

import numpy as np
import pandas as pd
import pytest
import torch

from graphcast_tpu.data import era5 as jax_era5
from graphcast_tpu.data import solar_radiation as jax_solar
from graphcast_tpu.fields import Field as JaxField
from graphcast_tpu.fields import FieldSet as JaxFieldSet
from graphcast_tpu_torch.data import durations, era5, solar_radiation
from graphcast_tpu_torch.data import synthetic
from graphcast_tpu_torch.fields import from_numpy
from graphcast_tpu_torch.models import configs

TISR_ATOL = 1e-4  # of the field's maximum

DATES = {
    "leap_day": ["2020-02-28T23:00", "2020-02-29T06:00", "2020-02-29T18:30",
                 "2020-03-01T00:00"],
    "solstices": ["2021-06-21T12:00", "2021-12-21T00:00",
                  "1999-12-31T23:00"],
    "equinox_and_late": ["2023-09-25T12:00", "2024-12-31T18:00",
                         "2016-03-20T06:00"],
}


def _timeseries(start="2020-02-27T00:00", batch=2, nt=6, nlat=7, nlon=8,
                nlev=3):
  """The same random series as numpy arrays with coords, for both
  packages."""
  rng = np.random.RandomState(0)
  lat = np.linspace(-90, 90, nlat)
  lon = np.arange(0, 360, 360 / nlon)
  levels = np.array([500, 700, 850])[:nlev]
  time = (np.arange(nt) * np.timedelta64(6, "h")).astype("timedelta64[ns]")
  datetimes = np.stack([np.datetime64(start, "ns") + time
                        + np.timedelta64(b, "D") for b in range(batch)])
  arrays = {
      "temperature": (rng.randn(batch, nt, nlev, nlat, nlon).astype(
          np.float32), ("batch", "time", "level", "lat", "lon")),
      "2m_temperature": (rng.randn(batch, nt, nlat, nlon).astype(
          np.float32), ("batch", "time", "lat", "lon")),
      "land_sea_mask": (rng.randn(nlat, nlon).astype(np.float32),
                        ("lat", "lon")),
  }
  coords = {"lat": lat, "lon": lon, "level": levels, "time": time,
            "datetime": datetimes}
  jax_fs = JaxFieldSet({k: JaxField(a, d) for k, (a, d) in arrays.items()},
                       coords=coords)
  return jax_fs, from_numpy(arrays, coords=coords)


def _assert_same(got, want):
  assert got.var_names == want.var_names
  for name in want.var_names:
    assert got[name].dims == want[name].dims, name
    np.testing.assert_array_equal(got.data(name).numpy(),
                                  np.asarray(want.data(name)), err_msg=name)
  assert set(got.coords) == set(want.coords)
  for name, value in want.coords.items():
    np.testing.assert_array_equal(got.coords[name], value, err_msg=name)


def test_progress_features_bit_equal():
  seconds = np.array([0.0, 1.5e9, 1582934400.0, 1.7e9 + 12345.0])
  lon = np.arange(0, 360, 22.5)
  np.testing.assert_array_equal(era5.get_year_progress(seconds),
                                jax_era5.get_year_progress(seconds))
  np.testing.assert_array_equal(era5.get_day_progress(seconds, lon),
                                jax_era5.get_day_progress(seconds, lon))


def test_add_derived_vars_bit_equal():
  j, t = _timeseries()
  _assert_same(era5.add_derived_vars(t), jax_era5.add_derived_vars(j))


@pytest.mark.parametrize("leads", [slice("6h", "18h"), "6h", ["12h", "6h"],
                                   slice(None, "12h"),
                                   np.timedelta64(12, "h"),
                                   datetime.timedelta(hours=6)])
@pytest.mark.parametrize("input_duration", ["12h", "6h"])
def test_extraction_equals_jax(leads, input_duration):
  j, t = _timeseries()
  j, t = jax_era5.add_derived_vars(j), era5.add_derived_vars(t)
  jax_leads = leads
  if isinstance(leads, datetime.timedelta):
    jax_leads = pd.Timedelta(leads)
  kwargs = dict(
      input_variables=("2m_temperature", "temperature", "land_sea_mask",
                       "day_progress_sin", "year_progress_cos"),
      target_variables=("2m_temperature", "temperature"),
      forcing_variables=("day_progress_sin", "day_progress_cos"),
      pressure_levels=(850, 500), input_duration=input_duration)
  got = era5.extract_inputs_targets_forcings(t, target_lead_times=leads,
                                             **kwargs)
  want = jax_era5.extract_inputs_targets_forcings(
      j, target_lead_times=jax_leads, **kwargs)
  for g, w in zip(got, want):
    _assert_same(g, w)


def test_extraction_rejects_what_jax_rejects():
  j, t = _timeseries()
  with pytest.raises(ValueError, match="not found"):
    era5.extract_input_target_times(t, "12h", ["6h", "9h"])
  with pytest.raises(ValueError, match="not found"):
    jax_era5.extract_input_target_times(j, "12h", ["6h", "9h"])
  with pytest.raises(ValueError, match="both targets and forcings"):
    era5.extract_inputs_targets_forcings(
        t, input_variables=("temperature",),
        target_variables=("temperature",),
        forcing_variables=("temperature",), pressure_levels=(500,),
        input_duration="12h", target_lead_times="6h")


@pytest.mark.parametrize("dates", sorted(DATES))
def test_tsi_and_j2000_days_equal_jax(dates):
  stamps = [np.datetime64(d) for d in DATES[dates]]
  pd_stamps = [pd.Timestamp(d) for d in DATES[dates]]
  for tsi_data in (solar_radiation.era5_tsi_data(),
                   solar_radiation.reference_tsi_data()):
    np.testing.assert_array_equal(solar_radiation.get_tsi(stamps, *tsi_data),
                                  jax_solar.get_tsi(pd_stamps, *tsi_data))
  np.testing.assert_array_equal(
      solar_radiation.get_j2000_days(stamps),
      [jax_solar.get_j2000_days(s) for s in pd_stamps])


@pytest.mark.parametrize("dates", sorted(DATES))
def test_tisr_matches_jax(dates):
  lat = np.linspace(-90.0, 90.0, 46)
  lon = np.arange(0.0, 360.0, 4.0)
  stamps = [np.datetime64(d) for d in DATES[dates]]
  want = jax_solar.get_toa_incident_solar_radiation(
      [pd.Timestamp(s) for s in stamps], lat, lon)
  got = solar_radiation.get_toa_incident_solar_radiation(
      stamps, lat, lon, device="cpu").numpy()
  assert got.dtype == np.float32 and got.shape == want.shape
  np.testing.assert_allclose(got, want, rtol=0, atol=TISR_ATOL * want.max())
  np.testing.assert_array_equal(got == 0, want == 0)
  assert 0.3 < (want == 0).mean() < 0.7  # the night side is there


def test_add_tisr_var_matches_jax():
  j, t = _timeseries(nt=2)
  got = era5.add_tisr_var(t).data(era5.TISR).numpy()
  want = np.asarray(jax_era5.add_tisr_var(j).data(jax_era5.TISR))
  np.testing.assert_allclose(got, want, rtol=0, atol=TISR_ATOL * want.max())
  np.testing.assert_array_equal(got == 0, want == 0)


@pytest.mark.parametrize("text", ["6h", "12h", "1h", "0h", "24h", "-6h",
                                  "1D12h", "30min", "1.5h", "90s", "2 days",
                                  "365D", "6 hours"])
def test_durations_read_as_pandas_does(text):
  assert durations.to_timedelta64(text) == pd.Timedelta(text).to_timedelta64()


def test_durations_take_timedeltas_and_refuse_nonsense():
  assert durations.to_timedelta64(datetime.timedelta(hours=6)) == (
      np.timedelta64(6, "h"))
  assert durations.to_timedelta64(np.timedelta64(2, "D")) == (
      np.timedelta64(48, "h"))
  for bad in ("", "6", "six hours", "6 lightyears"):
    with pytest.raises(ValueError):
      durations.to_timedelta64(bad)
  with pytest.raises(TypeError):
    durations.to_timedelta64(6)


def test_era5_dataset_runs_the_pipeline():
  task = configs.TASK_13
  ds = synthetic.make_era5_dataset(task, 30.0, num_times=4, seed=2,
                                   device="cpu")
  assert era5.TISR not in ds and "day_progress_sin" not in ds
  ds = era5.add_tisr_var(era5.add_derived_vars(ds))
  inputs, targets, forcings = era5.extract_inputs_targets_forcings(
      ds, input_variables=task.input_variables,
      target_variables=task.target_variables,
      forcing_variables=task.forcing_variables,
      pressure_levels=task.pressure_levels,
      input_duration=task.input_duration,
      target_lead_times=slice("6h", "12h"))
  assert set(inputs.var_names) == set(task.input_variables)
  assert set(forcings.var_names) == set(task.forcing_variables)
  np.testing.assert_array_equal(
      inputs.coords["time"], np.array([-6, 0], "timedelta64[h]"))
  np.testing.assert_array_equal(
      targets.coords["time"], np.array([6, 12], "timedelta64[h]"))
  again = synthetic.make_era5_dataset(task, 30.0, num_times=4, seed=2,
                                      device="cpu")
  assert torch.equal(again.data("temperature"),
                     ds.data("temperature"))
