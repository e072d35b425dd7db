"""The port's evaluation metrics (evaluation.py) against the JAX package's
on the same seeded numpy data: latitude-weighted RMSE, ACC, fair and plain
CRPS, ensemble-mean RMSE, each within 1e-6 relative (f32, summation order
only), over fields with and without a level axis, on a grid with poles
and an offset one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_tpu import evaluation as jax_evaluation
from graphcast_tpu.fields import Field as JaxField
from graphcast_tpu.fields import FieldSet as JaxFieldSet
from graphcast_tpu_torch import evaluation
from graphcast_tpu_torch.fields import from_numpy

GRIDS = {"poles": np.linspace(-90.0, 90.0, 7),
         "offset": np.linspace(-75.0, 75.0, 6)}


def _pair(rng, batch, lat, nlev=3, nt=2, nlon=8, offset=0.0):
  """A FieldSet of each package holding the same random arrays."""
  arrays = {
      "temperature": ((rng.randn(batch, nt, nlev, lat.size, nlon)
                       + offset).astype(np.float32),
                      ("batch", "time", "level", "lat", "lon")),
      "2m_temperature": ((rng.randn(batch, nt, lat.size, nlon)
                          + offset).astype(np.float32),
                         ("batch", "time", "lat", "lon")),
  }
  coords = {"lat": lat, "lon": np.arange(nlon) * 45.0}
  jax_fs = JaxFieldSet({k: JaxField(jnp.asarray(a), d)
                        for k, (a, d) in arrays.items()}, coords=coords)
  return jax_fs, from_numpy(arrays, coords=coords)


def _assert_scores(got, want):
  assert set(got) == set(want)
  for name in want:
    w = np.asarray(want[name])
    assert tuple(got[name].shape) == w.shape, name
    np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-6, atol=0,
                               err_msg=name)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_rmse_matches_jax(grid):
  rng = np.random.RandomState(0)
  jp, tp = _pair(rng, 2, GRIDS[grid])
  jt, tt = _pair(rng, 2, GRIDS[grid])
  _assert_scores(evaluation.rmse(tp, tt), jax_evaluation.rmse(jp, jt))


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_acc_matches_jax(grid):
  rng = np.random.RandomState(1)
  jp, tp = _pair(rng, 2, GRIDS[grid], offset=0.3)
  jt, tt = _pair(rng, 2, GRIDS[grid], offset=0.3)
  clim = {"temperature": (rng.randn(3).astype(np.float32), ("level",)),
          "2m_temperature": (np.float32(0.1).reshape(()), ())}
  jc = JaxFieldSet({k: JaxField(jnp.asarray(a), d)
                    for k, (a, d) in clim.items()})
  _assert_scores(evaluation.acc(tp, tt, from_numpy(clim)),
                 jax_evaluation.acc(jp, jt, jc))


@pytest.mark.parametrize("fair", [True, False])
@pytest.mark.parametrize("members", [1, 2, 5])
def test_crps_ensemble_matches_jax(members, fair):
  rng = np.random.RandomState(2 + members)
  jp, tp = _pair(rng, members, GRIDS["poles"])
  jt, tt = _pair(rng, 1, GRIDS["poles"])
  _assert_scores(evaluation.crps_ensemble(tp, tt, fair=fair),
                 jax_evaluation.crps_ensemble(jp, jt, fair=fair))


def test_ensemble_mean_rmse_matches_jax():
  rng = np.random.RandomState(9)
  jp, tp = _pair(rng, 4, GRIDS["offset"])
  jt, tt = _pair(rng, 1, GRIDS["offset"])
  _assert_scores(evaluation.ensemble_mean_rmse(tp, tt),
                 jax_evaluation.ensemble_mean_rmse(jp, jt))


def test_bf16_predictions_score_in_f32():
  rng = np.random.RandomState(4)
  _, tp = _pair(rng, 3, GRIDS["poles"])
  _, tt = _pair(rng, 1, GRIDS["poles"])
  bf16 = tp.astype(torch.bfloat16)
  for metric in (evaluation.rmse(bf16, tt),
                 evaluation.crps_ensemble(bf16, tt)):
    assert all(v.dtype == torch.float32 for v in metric.values())
