"""The port's native geometry backend (graphcast_tpu_torch/native/
geometry.py, its own copy of the C++ kernels) against the JAX package's
(graphcast_tpu/native/build.py), and the backend's resolution.

- ``radius_query`` and ``containing_triangles`` equal the JAX library's,
  array for array, on icosahedral meshes of 2 and 3 splits and 10° and 5°
  grids.
- The default artifact ("auto") equals the JAX package's default artifact
  bit for bit at 1.0°/mesh-5, where the two backends choose different
  triangles for the grid points on shared mesh edges: the port's numpy and
  native mesh2grid lists differ in the same rows as the JAX package's.
- An explicit "native" raises, with the compiler's message, when the
  compiler is missing or the library is turned off; "auto" then resolves
  to numpy.
- The disk cache's key carries the resolved backend: the two backends'
  artifacts are two files, "auto" reads the native one, and the JAX
  package reads the port's file of its own key.

The tests that build the library skip, with a reason, only where g++ is
absent.
"""

import shutil

import numpy as np
import pytest

from graphcast_tpu.data import synthetic as jax_synthetic
from graphcast_tpu.geometry import artifact as jax_artifact
from graphcast_tpu.geometry import connectivity as jax_connectivity
from graphcast_tpu.native import build as jax_native
from graphcast_tpu_torch.data import synthetic
from graphcast_tpu_torch.geometry import artifact, connectivity, features
from graphcast_tpu_torch.geometry import icosahedron
from graphcast_tpu_torch.native import geometry as native

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="g++ is absent: no native library")

_ARRAYS = ("grid_lat", "grid_lon", "mesh_vertices", "mesh_faces",
           "mesh_nodes_lat", "mesh_nodes_lon", "grid_nodes_lat",
           "grid_nodes_lon", "grid_node_features", "mesh_node_features")
_EDGES = ("grid2mesh", "mesh", "mesh2grid")


def _assert_artifacts_equal(a, b):
  for name in _ARRAYS:
    x, y = getattr(a, name), getattr(b, name)
    assert x.dtype == y.dtype, name
    np.testing.assert_array_equal(x, y, err_msg=name)
  for name in _EDGES:
    for field in ("senders", "receivers", "features"):
      x = getattr(getattr(a, name), field)
      y = getattr(getattr(b, name), field)
      assert x.dtype == y.dtype, (name, field)
      np.testing.assert_array_equal(x, y, err_msg=f"{name}.{field}")


@needs_gxx
@pytest.mark.parametrize("splits,resolution", [(2, 10.0), (3, 5.0)])
def test_library_calls_equal_the_jax_library(splits, resolution):
  assert jax_native.have_native()
  mesh = icosahedron.get_mesh_hierarchy(splits)[-1]
  lat, lon = synthetic.grid_coords(resolution)
  grid = features.grid_lat_lon_to_node_coordinates(lat, lon).astype(
      np.float64)
  radius = icosahedron.max_edge_length(mesh) * 0.6
  got = native.radius_query(grid, mesh.vertices, radius)
  want = jax_native.radius_query(grid, mesh.vertices, radius)
  for g, w in zip(got, want):
    assert g.dtype == w.dtype == np.int32
    np.testing.assert_array_equal(g, w)
  assert got[0].size > grid.shape[0]  # every grid point has a mesh node
  points = grid / np.linalg.norm(grid, axis=-1, keepdims=True)
  got = native.containing_triangles(points, mesh.vertices, mesh.faces)
  want = jax_native.containing_triangles(points, mesh.vertices, mesh.faces)
  assert got.dtype == want.dtype == np.int32
  np.testing.assert_array_equal(got, want)


@needs_gxx
def test_default_artifact_equals_the_jax_default_at_1deg_mesh5():
  lat, lon = synthetic.grid_coords(1.0)
  jlat, jlon = jax_synthetic.grid_coords(1.0)
  assert connectivity.resolve_backend() == "native"
  assert jax_connectivity.resolve_backend() == "native"
  ours = artifact.build_artifact(lat, lon, 5, cache_dir="")
  ref = jax_artifact.build_artifact(jlat, jlon, 5, cache_dir="")
  _assert_artifacts_equal(ours, ref)
  ours_np = artifact.build_artifact(lat, lon, 5, cache_dir="",
                                    backend="numpy")
  ref_np = jax_artifact.build_artifact(jlat, jlon, 5, cache_dir="",
                                       backend="numpy")
  _assert_artifacts_equal(ours_np, ref_np)
  # Where the backends disagree: some grid points' triangles, nothing else.
  for name in ("grid2mesh", "mesh"):
    np.testing.assert_array_equal(getattr(ours, name).senders,
                                  getattr(ours_np, name).senders)
  differ = ours.mesh2grid.senders != ours_np.mesh2grid.senders
  jax_differ = ref.mesh2grid.senders != ref_np.mesh2grid.senders
  np.testing.assert_array_equal(differ, jax_differ)
  assert differ.any(), "no tie at 1.0°/mesh-5: the case tests nothing"


@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
  """A compiler that does not exist, and an empty build directory."""
  monkeypatch.setattr(native, "CXX", "g++-that-does-not-exist")
  monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")


def test_explicit_native_raises_without_the_compiler(no_compiler):
  with pytest.raises(RuntimeError, match="g\\+\\+-that-does-not-exist"):
    connectivity.resolve_backend("native")
  assert not native.available()
  assert connectivity.resolve_backend("auto") == "numpy"
  lat, lon = synthetic.grid_coords(30.0)
  with pytest.raises(RuntimeError, match="did not build"):
    artifact.build_artifact(lat, lon, 1, cache_dir="", backend="native")
  numpy_art = artifact.build_artifact(lat, lon, 1, cache_dir="",
                                      backend="numpy")
  _assert_artifacts_equal(
      artifact.build_artifact(lat, lon, 1, cache_dir=""), numpy_art)


def test_library_turned_off_by_the_environment(monkeypatch):
  monkeypatch.setenv(native.NO_NATIVE_ENV, "1")
  with pytest.raises(RuntimeError, match=native.NO_NATIVE_ENV):
    connectivity.resolve_backend("native")
  assert connectivity.resolve_backend("auto") == "numpy"
  with pytest.raises(ValueError, match="unknown geometry backend"):
    connectivity.resolve_backend("cpp")


@needs_gxx
def test_cache_key_carries_the_resolved_backend(tmp_path, monkeypatch):
  lat, lon = synthetic.grid_coords(10.0)
  built = {b: artifact.build_artifact(lat, lon, 2, cache_dir=str(tmp_path),
                                      backend=b)
           for b in ("numpy", "native")}
  files = sorted(tmp_path.iterdir())
  assert len(files) == 2  # one file per resolved backend
  # "auto" is native here: it reads the native file and writes none.
  auto = artifact.build_artifact(lat, lon, 2, cache_dir=str(tmp_path))
  _assert_artifacts_equal(auto, built["native"])
  jax_auto = jax_artifact.build_artifact(
      *jax_synthetic.grid_coords(10.0), 2, cache_dir=str(tmp_path))
  _assert_artifacts_equal(jax_auto, built["native"])
  assert sorted(tmp_path.iterdir()) == files
  # cached_artifact keys "auto" by what it resolves to.
  monkeypatch.setattr(artifact, "_ARTIFACTS", type(artifact._ARTIFACTS)())
  a = artifact.cached_artifact(lat, lon, 2, cache_dir="")
  assert artifact.cached_artifact(lat, lon, 2, cache_dir="",
                                  backend="native") is a
  assert artifact.cached_artifact(lat, lon, 2, cache_dir="",
                                  backend="numpy") is not a
