"""The port's torch FieldSet against graphcast_tpu's: channel stacking (part
of checkpoint compatibility), its inverse, and the selection helpers the
rollout uses."""

import numpy as np
import pytest
import torch

from graphcast_tpu import fields as jax_fields
from graphcast_tpu_torch import fields
from graphcast_tpu_torch.field_tree import map_data


def _pair(seed=0):
  rng = np.random.RandomState(seed)
  arrays = {
      "z_atmos": (rng.randn(1, 2, 3, 4, 5).astype(np.float32),
                  ("batch", "time", "level", "lat", "lon")),
      "a_surface": (rng.randn(1, 2, 4, 5).astype(np.float32),
                    ("batch", "time", "lat", "lon")),
      "m_static": (rng.randn(4, 5).astype(np.float32), ("lat", "lon")),
  }
  coords = {"lat": np.arange(4.0), "lon": np.arange(5.0),
            "level": np.array([1, 2, 3]),
            "time": np.array([-6, 0]).astype("timedelta64[h]")}
  ours = fields.from_numpy(arrays, coords)
  ref = jax_fields.FieldSet(
      {n: jax_fields.Field(a, d) for n, (a, d) in arrays.items()}, coords)
  return ours, ref


def test_to_stacked_matches_jax_package():
  ours, ref = _pair()
  assert ours.var_names == ("a_surface", "m_static", "z_atmos")
  np.testing.assert_array_equal(fields.to_stacked(ours).numpy(),
                                np.asarray(jax_fields.to_stacked(ref)))
  assert fields.stacked_channels(ours) == jax_fields.stacked_channels(ref)


def test_from_stacked_inverts_to_stacked():
  ours, _ = _pair(1)
  template = ours.drop(["m_static"])
  back = fields.from_stacked(fields.to_stacked(template), template)
  for n in template.var_names:
    assert back[n].dims == template[n].dims
    assert torch.equal(back.data(n), template.data(n))
  with pytest.raises(ValueError, match="channels"):
    fields.from_stacked(torch.zeros(1, 4, 5, 3), template)


@pytest.mark.parametrize("op", ["isel_slice", "isel_int", "concat", "merge"])
def test_selection_helpers_match_jax_package(op):
  ours, ref = _pair(2)
  if op == "isel_slice":
    a, b = ours.isel(time=slice(-1, None)), ref.isel(time=slice(-1, None))
  elif op == "isel_int":
    a, b = ours.isel(time=0), ref.isel(time=0)
  elif op == "concat":
    sel = ["a_surface", "z_atmos"]
    a = fields.FieldSet.concat([ours.select(sel)] * 2, "time")
    b = jax_fields.FieldSet.concat([ref.select(sel)] * 2, "time")
  else:
    a = fields.FieldSet.merge([ours.select(["m_static"]),
                               ours.drop(["m_static"])])
    b = jax_fields.FieldSet.merge([ref.select(["m_static"]),
                                   ref.drop(["m_static"])])
  assert a.var_names == b.var_names
  assert sorted(a.coords) == sorted(b.coords)
  for k in a.coords:
    np.testing.assert_array_equal(a.coords[k], b.coords[k])
  for n in a.var_names:
    assert a[n].dims == b[n].dims
    np.testing.assert_array_equal(a.data(n).numpy(), np.asarray(b.data(n)))


def test_astype_casts_floating_only_and_map_data_keeps_dims():
  ours, _ = _pair(3)
  ints = fields.FieldSet({"i": fields.Field(torch.arange(3), ("x",))})
  merged = fields.FieldSet.merge([ours, ints]).astype(torch.bfloat16)
  assert merged.data("i").dtype == torch.int64
  assert merged.data("a_surface").dtype == torch.bfloat16
  doubled = map_data(lambda x: 2 * x, ours)
  assert doubled["z_atmos"].dims == ours["z_atmos"].dims
  assert torch.equal(doubled.data("m_static"), 2 * ours.data("m_static"))
