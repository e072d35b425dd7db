"""The port's xarray boundary (xarray_bridge.py) against the JAX package's,
on tests/fake_xarray installed as ``xarray`` exactly as
tests/test_xarray_bridge.py installs it (neither this machine nor the
card's has xarray): the same Dataset converts to the same fields and
coords, FieldSets of tensors round-trip, and the notebook's data path
(Dataset → FieldSet → extraction → the port's GraphCast → Dataset) runs.
Without xarray the port imports and the bridge raises ImportError."""

import importlib
import os
import pathlib
import subprocess
import sys
import textwrap

import torch

# torch.optim and torch.utils.checkpoint import torch._dynamo at first use,
# which calls importlib.util.find_spec on optional packages and raises on a
# module without __spec__, such as the fake ``xarray``. Import it first.
_xarray = sys.modules.pop("xarray", None)
try:
  import torch._dynamo  # noqa: F401
finally:
  if _xarray is not None:
    sys.modules["xarray"] = _xarray

import numpy as np
import pytest

from tests import fake_xarray

xa = fake_xarray.install_if_missing()

from graphcast_tpu import xarray_bridge as jax_xb  # noqa: E402

if not jax_xb.HAVE_XARRAY:
  jax_xb = importlib.reload(jax_xb)

from graphcast_tpu_torch import xarray_bridge as xb  # noqa: E402
from graphcast_tpu_torch.data import era5, synthetic  # noqa: E402
from graphcast_tpu_torch.fields import from_numpy  # noqa: E402
from graphcast_tpu_torch.models import configs  # noqa: E402
from graphcast_tpu_torch.models.graphcast import GraphCast  # noqa: E402
from tests.test_torch_graphcast import TINY_MODEL, TINY_TASK  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def _dataset(batch=1, nt=3, datetime_1d=False):
  rng = np.random.RandomState(1)
  lat, lon = synthetic.grid_coords(30.0)
  levels = np.asarray(TINY_TASK["pressure_levels"], np.int32)
  time = np.arange(nt) * np.timedelta64(6, "h")
  stamps = np.datetime64("2020-06-01") + time
  shape = (batch, nt, lat.size, lon.size)
  data_vars = {
      "2m_temperature": xa.DataArray(
          rng.randn(*shape).astype(np.float32),
          dims=("batch", "time", "lat", "lon")),
      "temperature": xa.DataArray(
          rng.randn(batch, nt, levels.size, lat.size, lon.size).astype(
              np.float32), dims=("batch", "time", "level", "lat", "lon")),
      "land_sea_mask": xa.DataArray(
          rng.rand(lat.size, lon.size).astype(np.float32),
          dims=("lat", "lon")),
  }
  datetime = (xa.DataArray(stamps, dims=("time",)) if datetime_1d else
              xa.DataArray(stamps[None].repeat(batch, 0),
                           dims=("batch", "time")))
  return xa.Dataset(data_vars, coords={
      "lat": lat, "lon": lon, "level": levels, "time": time,
      "datetime": datetime})


@pytest.mark.parametrize("datetime_1d", [False, True])
def test_from_xarray_equals_jax(datetime_1d):
  ds = _dataset(batch=1, datetime_1d=datetime_1d)
  got = xb.from_xarray(ds, device="cpu")
  want = jax_xb.from_xarray(ds)
  assert got.var_names == want.var_names
  for name in want.var_names:
    assert got[name].dims == want[name].dims
    assert isinstance(got.data(name), torch.Tensor)
    np.testing.assert_array_equal(got.data(name).numpy(),
                                  np.asarray(want.data(name)))
  assert set(got.coords) == set(want.coords)
  for name in want.coords:
    np.testing.assert_array_equal(got.coords[name], want.coords[name])
  assert got.coords["datetime"].shape == (1, 3)


def test_round_trip_and_to_xarray_equals_jax():
  fs = xb.from_xarray(_dataset(batch=2), device="cpu")
  ds = xb.to_xarray(fs)
  want = jax_xb.to_xarray(jax_xb.from_xarray(_dataset(batch=2)))
  assert set(ds.data_vars) == set(want.data_vars)
  for name in want.data_vars:
    assert tuple(ds[name].dims) == tuple(want[name].dims)
    np.testing.assert_array_equal(np.asarray(ds[name].data),
                                  np.asarray(want[name].data))
  back = xb.from_xarray(ds, device="cpu")
  for name in fs.var_names:
    assert torch.equal(back.data(name), fs.data(name))
  for name in ("lat", "lon", "level", "time", "datetime"):
    np.testing.assert_array_equal(back.coords[name], fs.coords[name])


def test_to_xarray_takes_bf16_and_stats_from_xarray_equals_jax():
  fs = from_numpy({"x": (np.arange(6, dtype=np.float32).reshape(2, 3),
                         ("lat", "lon"))}).astype(torch.bfloat16)
  np.testing.assert_array_equal(np.asarray(xb.to_xarray(fs)["x"].data),
                                np.arange(6, dtype=np.float32).reshape(2, 3))
  ds = xa.Dataset(
      {"temperature": xa.DataArray(np.array([1.0, 2.0], np.float32),
                                   dims=("level",)),
       "2m_temperature": xa.DataArray(np.float32(3.0), dims=())},
      coords={"level": np.array([500, 850], np.int32)})
  got, want = xb.stats_from_xarray(ds, device="cpu"), jax_xb.stats_from_xarray(ds)
  for name in want.var_names:
    assert got[name].dims == want[name].dims
    np.testing.assert_array_equal(got.data(name).numpy(),
                                  np.asarray(want.data(name)))
  np.testing.assert_array_equal(got.coords["level"], want.coords["level"])


def test_dataset_to_forecast_to_dataset():
  """The notebook's data path: an ERA5-like Dataset enters through
  from_xarray, TISR is added, extraction splits it, the port's GraphCast
  predicts, and the predictions leave through to_xarray."""
  raw = era5.add_tisr_var(xb.from_xarray(_dataset(), device="cpu"))
  task = configs.TaskConfig(**TINY_TASK)
  inputs, targets, forcings = era5.extract_inputs_targets_forcings(
      raw, input_variables=task.input_variables,
      target_variables=task.target_variables,
      forcing_variables=task.forcing_variables,
      pressure_levels=task.pressure_levels,
      input_duration=task.input_duration, target_lead_times="6h")
  assert inputs.sizes["time"] == 2 and targets.sizes["time"] == 1
  model = GraphCast(configs.ModelConfig(**TINY_MODEL), task,
                    generator=torch.Generator().manual_seed(0), device="cpu")
  with torch.inference_mode():
    preds = model(inputs, targets, forcings)
  out = xb.to_xarray(preds)
  assert set(out.data_vars) == set(task.target_variables)
  for name in out.data_vars:
    assert np.isfinite(np.asarray(out[name].data)).all()


def test_bridge_raises_without_xarray_and_the_port_imports():
  code = textwrap.dedent("""
      import sys
      sys.modules["xarray"] = None
      from graphcast_tpu_torch import xarray_bridge as xb
      try:
        xb.from_xarray(None, device="cpu")
      except ImportError as e:
        print("ImportError", "xarray is not installed" in str(e))
      """)
  env = {**os.environ, "PYTHONPATH": str(REPO)}
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, env=env, cwd=REPO, timeout=120)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.split() == ["ImportError", "True"]
