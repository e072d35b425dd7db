"""The port's pinned geometry copy must build the JAX package's artifact
exactly, both sides with the numpy connectivity backend: every array, bit
for bit, for GraphCast's multi-mesh and for GenCast's finest-only mesh in
banded (RCM) and patch-permuted node order. tests/
test_torch_native_geometry.py holds the native backend and the default
one."""

import numpy as np
import pytest

from graphcast_tpu.data import synthetic as jax_synthetic
from graphcast_tpu.geometry import artifact as jax_artifact
from graphcast_tpu_torch.data import synthetic
from graphcast_tpu_torch.geometry import artifact

_ARRAYS = ("grid_lat", "grid_lon", "mesh_vertices", "mesh_faces",
           "mesh_nodes_lat", "mesh_nodes_lon", "grid_nodes_lat",
           "grid_nodes_lon", "grid_node_features", "mesh_node_features")
_EDGES = ("grid2mesh", "mesh", "mesh2grid")


_GENCAST = dict(multimesh=False, permute_banded=True)


@pytest.mark.parametrize("resolution,mesh_size,kwargs", [
    pytest.param(30.0, 1, {}, id="30.0-1"),
    pytest.param(10.0, 3, {}, id="10.0-3"),
    pytest.param(15.0, 2, _GENCAST, id="15.0-2-rcm"),
    pytest.param(15.0, 2, dict(_GENCAST, banded_patch_size=64),
                 id="15.0-2-patch64"),
    pytest.param(10.0, 3, dict(_GENCAST, banded_patch_size=128),
                 id="10.0-3-patch128"),
])
def test_artifact_arrays_equal_jax_package(resolution, mesh_size, kwargs):
  lat, lon = synthetic.grid_coords(resolution)
  jlat, jlon = jax_synthetic.grid_coords(resolution)
  np.testing.assert_array_equal(lat, jlat)
  np.testing.assert_array_equal(lon, jlon)
  ours = artifact.build_artifact(lat, lon, mesh_size, backend="numpy",
                                 **kwargs)
  ref = jax_artifact.build_artifact(jlat, jlon, mesh_size, cache_dir="",
                                    backend="numpy", **kwargs)
  assert ours.num_grid_nodes == ref.num_grid_nodes
  assert ours.num_mesh_nodes == ref.num_mesh_nodes
  for name in _ARRAYS:
    a, b = getattr(ours, name), getattr(ref, name)
    assert a.dtype == b.dtype, name
    np.testing.assert_array_equal(a, b, err_msg=name)
  for name in _EDGES:
    for field in ("senders", "receivers", "features"):
      a = getattr(getattr(ours, name), field)
      b = getattr(getattr(ref, name), field)
      assert a.dtype == b.dtype, (name, field)
      np.testing.assert_array_equal(a, b, err_msg=f"{name}.{field}")


def test_edge_lists_are_receiver_sorted_with_three_per_grid_node():
  """The kernels' layout invariants: receiver-sorted rows, and exactly 3
  mesh2grid edges per grid node in rows 3v..3v+2."""
  lat, lon = synthetic.grid_coords(15.0)
  art = artifact.build_artifact(lat, lon, 2)
  for name in _EDGES:
    assert (np.diff(getattr(art, name).receivers) >= 0).all(), name
  np.testing.assert_array_equal(
      art.mesh2grid.receivers, np.repeat(np.arange(art.num_grid_nodes), 3))


def test_cached_artifact_builds_once_per_configuration(monkeypatch):
  """Models take their artifact from cached_artifact: a default given or
  left out is the same configuration, the artifact equals a fresh build,
  and the least recently used one goes beyond ARTIFACT_CACHE_SIZE."""
  monkeypatch.setattr(artifact, "_ARTIFACTS", type(artifact._ARTIFACTS)())
  lat, lon = synthetic.grid_coords(30.0)
  a = artifact.cached_artifact(lat, lon, 1)
  assert artifact.cached_artifact(
      grid_lat=lat, grid_lon=lon, mesh_size=1, multimesh=True,
      radius_query_fraction_edge_length=0.6) is a
  fresh = artifact.build_artifact(lat, lon, 1)
  for name in _ARRAYS:
    np.testing.assert_array_equal(getattr(a, name), getattr(fresh, name))
  banded = artifact.cached_artifact(lat, lon, 1, **_GENCAST)
  assert banded is not a
  for mesh_size in range(2, 2 + artifact.ARTIFACT_CACHE_SIZE - 1):
    artifact.cached_artifact(lat, lon, mesh_size)
  assert artifact.cached_artifact(lat, lon, 1, **_GENCAST) is banded
  assert artifact.cached_artifact(lat, lon, 1) is not a  # evicted
