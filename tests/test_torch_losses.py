"""graphcast_tpu_torch.losses against graphcast_tpu.losses.

Weights are host numpy in both packages and must agree to f32 rounding
(rtol 1e-6). ``weighted_mse_per_level`` gets the same numpy inputs, made
from a seed, in both packages: f32 agrees to 1e-6 (only the order of the
mean's f32 sum differs); bf16 within 1e-2 relative, since both square and
weight in bf16 and round the mean to bf16 (one bf16 ulp is 2^-8 ≈ 4e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_tpu import fields as jax_fields
from graphcast_tpu import losses as jax_losses
from graphcast_tpu_torch import fields, losses

GRIDS = {
    "poles": np.linspace(-90.0, 90.0, 19),          # 10° with both poles
    "offset": np.arange(-87.5, 90.0, 5.0),          # 5°, cell centres
}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_latitude_weights_match_jax(grid):
  lat = GRIDS[grid]
  np.testing.assert_allclose(losses.latitude_cell_area_weights(lat),
                             jax_losses.latitude_cell_area_weights(lat),
                             rtol=1e-12)
  got = losses.normalized_latitude_weights(lat)
  assert got.dtype == np.float32
  np.testing.assert_allclose(got, jax_losses.normalized_latitude_weights(lat),
                             rtol=1e-6)


def test_latitude_weights_reject_bad_grids():
  for lat in (np.array([0.0, 1.0, 3.0]), np.linspace(-80.0, 90.0, 18),
              np.arange(-80.0, 80.0, 10.0)):
    with pytest.raises(ValueError):
      losses.normalized_latitude_weights(lat)


def test_level_weights_match_jax():
  level = np.array([50, 100, 250, 500, 850, 1000])
  np.testing.assert_allclose(losses.normalized_level_weights(level),
                             jax_losses.normalized_level_weights(level),
                             rtol=1e-6)


def _case(seed, lat):
  rng = np.random.RandomState(seed)
  coords = {"lat": lat, "lon": np.arange(0.0, 360.0, 30.0),
            "level": np.array([100, 500, 850])}
  nlat, nlon = lat.shape[0], 12
  arrays = {
      "temperature": (("batch", "time", "level", "lat", "lon"),
                      (2, 1, 3, nlat, nlon)),
      "2m_temperature": (("batch", "time", "lat", "lon"), (2, 1, nlat, nlon)),
      "10m_u_component_of_wind": (("batch", "time", "lat", "lon"),
                                  (2, 1, nlat, nlon)),
  }
  pred = {n: (rng.randn(*s).astype(np.float32), d)
          for n, (d, s) in arrays.items()}
  tgt = {n: (rng.randn(*s).astype(np.float32), d)
         for n, (d, s) in arrays.items()}
  return coords, pred, tgt


def _jax_fs(arrays, coords, dtype):
  return jax_fields.FieldSet(
      {n: jax_fields.Field(jnp.asarray(a, dtype), d)
       for n, (a, d) in arrays.items()}, coords=coords)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_weighted_mse_per_level_matches_jax(grid, dtype_name):
  jdtype, tdtype = {"f32": (jnp.float32, torch.float32),
                    "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype_name]
  coords, pred, tgt = _case(seed=len(grid), lat=GRIDS[grid])
  weights = {"2m_temperature": 1.0, "10m_u_component_of_wind": 0.1}
  want_total, want_diag = jax_losses.weighted_mse_per_level(
      _jax_fs(pred, coords, jdtype), _jax_fs(tgt, coords, jnp.float32),
      weights)
  got_total, got_diag = losses.weighted_mse_per_level(
      fields.from_numpy(pred, coords).astype(tdtype),
      fields.from_numpy(tgt, coords), weights)
  assert got_total.dtype == torch.float32 and got_total.shape == (2,)
  rtol = 1e-6 if dtype_name == "f32" else 1e-2
  np.testing.assert_allclose(got_total.numpy(), np.asarray(want_total),
                             rtol=rtol)
  assert set(got_diag) == set(want_diag)
  for name, value in got_diag.items():
    assert value.dtype == torch.float32
    np.testing.assert_allclose(value.numpy(), np.asarray(want_diag[name]),
                               rtol=rtol, err_msg=name)


def test_sum_per_variable_losses_defaults_and_rejects_unknown():
  per_var = {"a": torch.tensor([1.0]), "b": torch.tensor([2.0])}
  assert losses.sum_per_variable_losses(per_var, {"a": 0.5}).item() == 2.5
  with pytest.raises(ValueError, match="unknown"):
    losses.sum_per_variable_losses(per_var, {"c": 1.0})
