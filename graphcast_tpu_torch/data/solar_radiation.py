"""ERA5-compatible TOA incident solar radiation (port of
graphcast_tpu/data/solar_radiation.py; reference: solar_radiation.py).

Computes the `toa_incident_solar_radiation` forcing: the instantaneous
top-of-atmosphere solar flux from Earth's orbital position (the empirical
ECCC GEM polynomials used to match ERA5; reference solar_radiation.py:
197-290), yearly TSI data, and trapezoidal integration of the flux over the
accumulation window (1h for ERA5, J·m⁻²).

Dates are numpy ``datetime64`` (no pandas). The flux and its integral run
in torch on the caller's device, in float32 at the JAX package's casting
points: the days since J2000 and the TSI are float32 scalars, and the
window's offsets (float64 from ``np.linspace``) are float32 too, as JAX's
promotion makes them, so ``days + offsets`` is a float32 sum. The orbital
polynomials depend on time alone and are taken once per timestamp and
sample; the [lat, lon, sample] fluxes are made a block of latitude rows at
a time (at 0.25° one timestamp is 1,038,240 points × 361 samples, 1.5 GB),
and integrated as ``jax.numpy.trapezoid`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from graphcast_tpu_torch import devices
from graphcast_tpu_torch.data import durations

_SECONDS_PER_DAY = 24 * 3600
_J2000_EPOCH = 2451545.0  # Julian date of 2000-01-01 12:00 TT.
_JULIAN_YEAR_LENGTH_IN_DAYS = 365.25
# Elements of one block of [rows, lon, samples] fluxes (256 MiB of float32).
_FLUX_BLOCK_ELEMENTS = 1 << 26

# Reference Total Solar Irradiance in W·m⁻² (NOAA CDR / ecRad).
REFERENCE_TSI = 1361.0


def reference_tsi_data():
  """(years, tsi) arrays with a single reference value."""
  return np.array([0.0]), np.array([REFERENCE_TSI])


def era5_tsi_data():
  """Yearly TSI used by ERA5 (IFS cycle 41r2 table, scaled ×0.9965).

  Returns (fractional_years, tsi_w_m2). Data values as in the reference
  (solar_radiation.py:83-115) — an ECMWF-provided physical dataset.
  """
  time = np.arange(1951.5, 2035.5, 1.0)
  base = np.array([
      # 1951-1995
      1365.7765, 1365.7676, 1365.6284, 1365.6564, 1365.7773,
      1366.3109, 1366.6681, 1366.6328, 1366.3828, 1366.2767,
      1365.9199, 1365.7484, 1365.6963, 1365.6976, 1365.7341,
      1365.9178, 1366.1143, 1366.1644, 1366.2476, 1366.2426,
      1365.9580, 1366.0525, 1365.7991, 1365.7271, 1365.5345,
      1365.6453, 1365.8331, 1366.2747, 1366.6348, 1366.6482,
      1366.6951, 1366.2859, 1366.1992, 1365.8103, 1365.6416,
      1365.6379, 1365.7899, 1366.0826, 1366.6479, 1366.5533,
      1366.4457, 1366.3021, 1366.0286, 1365.7971, 1365.6996,
  ] + [
      # 1996-2008 cycle, repeated three times through 2034.
      1365.6121, 1365.7399, 1366.1021, 1366.3851, 1366.6836,
      1366.6022, 1366.6807, 1366.2300, 1366.0480, 1365.8545,
      1365.8107, 1365.7240, 1365.6918,
  ] * 3)
  return time, 0.9965 * base


def _as_datetimes(timestamps) -> np.ndarray:
  return np.asarray(timestamps, dtype="datetime64[ns]").reshape(-1)


def _year(datetimes: np.ndarray) -> np.ndarray:
  return datetimes.astype("datetime64[Y]").astype(np.int64) + 1970


def get_tsi(timestamps, tsi_years: np.ndarray, tsi_values: np.ndarray
            ) -> np.ndarray:
  """Interpolates yearly TSI at the given timestamps (float64; reference:
  solar_radiation.py:131-160)."""
  ts = _as_datetimes(timestamps)
  days = ts.astype("datetime64[D]")
  day_fraction = (ts - days) / np.timedelta64(1, "D")
  year = _year(ts)
  leap = ((year % 4 == 0) & (year % 100 != 0)) | (year % 400 == 0)
  year_length = 365 + leap.astype(np.int64)
  day_of_year = (days - ts.astype("datetime64[Y]").astype("datetime64[D]")
                 ).astype(np.int64) + 1
  year_fraction = (day_of_year - 1 + day_fraction) / year_length
  fractional_year = year + year_fraction
  return np.interp(fractional_year, tsi_years, tsi_values)


@dataclasses.dataclass(frozen=True)
class OrbitalParameters:
  theta: torch.Tensor
  rotational_phase: torch.Tensor
  sin_declination: torch.Tensor
  cos_declination: torch.Tensor
  eq_of_time_seconds: torch.Tensor
  solar_distance_au: torch.Tensor


def get_j2000_days(timestamps) -> np.ndarray:
  """Days since J2000 (float64), by the Julian-date formula of
  ``pandas.Timestamp.to_julian_date``."""
  ts = _as_datetimes(timestamps)
  year = _year(ts)
  month = ts.astype("datetime64[M]").astype(np.int64) % 12 + 1
  day = (ts.astype("datetime64[D]") - ts.astype("datetime64[M]").astype(
      "datetime64[D]")).astype(np.int64) + 1
  ns_of_day = (ts - ts.astype("datetime64[D]")).astype(np.int64)
  hour, ns = np.divmod(ns_of_day, 3_600_000_000_000)
  minute, ns = np.divmod(ns, 60_000_000_000)
  second, ns = np.divmod(ns, 1_000_000_000)
  microsecond, nanosecond = np.divmod(ns, 1000)
  early = month <= 2
  year = np.where(early, year - 1, year)
  month = np.where(early, month + 12, month)
  julian = (day + np.fix((153 * month - 457) / 5) + 365 * year
            + np.floor(year / 4) - np.floor(year / 100)
            + np.floor(year / 400) + 1721118.5
            + (hour + minute / 60.0 + second / 3600.0
               + microsecond / 3600.0 / 1e6
               + nanosecond / 3600.0 / 1e9) / 24.0)
  return julian - _J2000_EPOCH


def get_orbital_parameters(j2000_days: torch.Tensor) -> OrbitalParameters:
  """ECCC GEM empirical orbital polynomials (float32; reference:
  solar_radiation.py:197-290)."""
  theta = j2000_days / _JULIAN_YEAR_LENGTH_IN_DAYS
  rotational_phase = torch.remainder(j2000_days, 1.0)

  rel = 1.7535 + 6.283076 * theta     # mean longitude-ish angle
  rem = 6.240041 + 6.283020 * theta   # mean anomaly
  rlls = 4.8951 + 6.283076 * theta    # mean ecliptic longitude

  # Ecliptic longitude of the Sun.
  rllls = (4.8952 + 6.283320 * theta
           - 0.0075 * torch.sin(rel) - 0.0326 * torch.cos(rel)
           - 0.0003 * torch.sin(2.0 * rel) + 0.0002 * torch.cos(2.0 * rel))

  # Obliquity (23.4393°) in radians, a float32 scalar as in jnp.sin(0.409093).
  repsm = torch.tensor(0.409093, dtype=torch.float32,
                       device=j2000_days.device)

  sin_declination = torch.sin(repsm) * torch.sin(rllls)
  cos_declination = torch.sqrt(1.0 - sin_declination ** 2)

  eq_of_time_seconds = (
      591.8 * torch.sin(2.0 * rlls) - 459.4 * torch.sin(rem)
      + 39.5 * torch.sin(rem) * torch.cos(2.0 * rlls)
      - 12.7 * torch.sin(4.0 * rlls) - 4.8 * torch.sin(2.0 * rem))

  solar_distance_au = (1.0001 - 0.0163 * torch.sin(rel)
                       + 0.0037 * torch.cos(rel))

  return OrbitalParameters(
      theta=theta, rotational_phase=rotational_phase,
      sin_declination=sin_declination, cos_declination=cos_declination,
      eq_of_time_seconds=eq_of_time_seconds,
      solar_distance_au=solar_distance_au)


def get_solar_sin_altitude(op: OrbitalParameters, sin_latitude, cos_latitude,
                           longitude):
  """Sine of the solar altitude angle (reference: solar_radiation.py:
  293-325)."""
  solar_time = op.rotational_phase + op.eq_of_time_seconds / _SECONDS_PER_DAY
  hour_angle = 2.0 * math.pi * solar_time + longitude
  return (cos_latitude * op.cos_declination * torch.cos(hour_angle)
          + sin_latitude * op.sin_declination)


def get_radiation_flux(j2000_days, sin_latitude, cos_latitude, longitude,
                       tsi):
  """Instantaneous TOA incident flux in W·m⁻² (reference:
  solar_radiation.py:328-365)."""
  op = get_orbital_parameters(j2000_days)
  solar_factor = (1.0 / op.solar_distance_au) ** 2
  sin_altitude = get_solar_sin_altitude(op, sin_latitude, cos_latitude,
                                        longitude)
  return tsi * solar_factor * torch.clamp(sin_altitude, min=0.0)


def get_integrated_radiation(j2000_days: torch.Tensor,
                             sin_latitude: torch.Tensor,
                             cos_latitude: torch.Tensor,
                             longitude: torch.Tensor, tsi: torch.Tensor,
                             integration_period_seconds: float,
                             num_integration_bins: int) -> torch.Tensor:
  """Trapezoidal integral of the flux over the accumulation window ending at
  each timestamp; J·m⁻² (reference: solar_radiation.py:368-434).

  j2000_days, tsi: [T] float32; sin/cos_latitude [lat]; longitude [lon]
  (radians, float32). Returns [T, lat, lon] float32.
  """
  device = j2000_days.device
  offsets_days = torch.as_tensor(np.linspace(
      -integration_period_seconds / _SECONDS_PER_DAY, 0.0,
      num_integration_bins + 1), dtype=torch.float32, device=device)
  days = j2000_days[:, None] + offsets_days  # [T, S] float32
  op = get_orbital_parameters(days)
  # The flux's time-only factors, [T, 1, S] (lat) and [T, 1, 1, S] (lon).
  solar_factor = (1.0 / op.solar_distance_au) ** 2
  scale = (tsi[:, None] * solar_factor)[:, None, None]
  solar_time = op.rotational_phase + op.eq_of_time_seconds / _SECONDS_PER_DAY
  cos_hour = torch.cos(2.0 * math.pi * solar_time[:, None]
                       + longitude[None, :, None])  # [T, lon, S]
  cos_decl = op.cos_declination[:, None, None]
  sin_decl = op.sin_declination[:, None, None]
  num_lat, num_lon = sin_latitude.shape[0], longitude.shape[0]
  rows = max(1, _FLUX_BLOCK_ELEMENTS // (num_lon * days.shape[1]))
  dx = integration_period_seconds / num_integration_bins
  out = torch.empty((days.shape[0], num_lat, num_lon), dtype=torch.float32,
                    device=device)
  for t in range(days.shape[0]):
    for r0 in range(0, num_lat, rows):
      cl = cos_latitude[r0:r0 + rows, None, None]
      sl = sin_latitude[r0:r0 + rows, None, None]
      sin_altitude = (cl * cos_decl[t] * cos_hour[t]) + sl * sin_decl[t]
      fluxes = scale[t] * torch.clamp(sin_altitude, min=0.0)
      out[t, r0:r0 + rows] = 0.5 * (
          dx * (fluxes[..., 1:] + fluxes[..., :-1])).sum(-1)
  return out


def get_toa_incident_solar_radiation(
    timestamps: Sequence,
    latitude: np.ndarray,
    longitude: np.ndarray,
    tsi_data: Optional[tuple[np.ndarray, np.ndarray]] = None,
    integration_period="1h",
    num_integration_bins: int = 360,
    device: torch.device | str = devices.DEFAULT_DEVICE,
) -> torch.Tensor:
  """TISR for each (timestamp, lat, lon): a float32 tensor [T, n_lat,
  n_lon] in J·m⁻² on ``device`` (the card unless the caller asks for
  "cpu"; reference: solar_radiation.py:443-520)."""
  device = devices.resolve(device)
  if tsi_data is None:
    tsi_data = era5_tsi_data()
  period_s = (durations.to_timedelta64(integration_period)
              / np.timedelta64(1, "s"))
  lat_rad = np.deg2rad(np.asarray(latitude))
  lon_rad = np.deg2rad(np.asarray(longitude))

  def tensor(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

  return get_integrated_radiation(
      tensor(get_j2000_days(timestamps)), tensor(np.sin(lat_rad)),
      tensor(np.cos(lat_rad)), tensor(lon_rad),
      tensor(get_tsi(timestamps, *tsi_data)),
      integration_period_seconds=float(period_s),
      num_integration_bins=num_integration_bins)
