"""Grid ↔ mesh connectivity queries. Host-side, runs once.

Pinned copy of graphcast_tpu/geometry/connectivity.py with both of its
backends: ``"numpy"`` (numpy/scipy) and ``"native"`` (the port's copy of
the JAX package's C++ kernels, native/geometry.py). ``"auto"`` resolves as
the JAX package resolves it: native whenever the library builds, so that on
one machine the port's default graph is the JAX package's.
tests/test_torch_geometry.py and tests/test_torch_native_geometry.py assert
that the port's artifacts equal the JAX package's, backend by backend.

- grid2mesh edges: every (grid point, mesh vertex) pair within a fixed
  3D radius, via a cKDTree ball query (reference: radius_query_indices,
  grid_mesh_connectivity.py:40-86);
- mesh2grid edges: the 3 vertices of the spherical triangle containing each
  grid point (reference: in_mesh_triangle_indices, :89-133), chosen among
  KD-tree face-centroid candidates.
"""

from __future__ import annotations

import numpy as np
from scipy import spatial

from graphcast_tpu_torch.geometry.features import (
    grid_lat_lon_to_node_coordinates)
from graphcast_tpu_torch.geometry.icosahedron import TriangularMesh
from graphcast_tpu_torch.native import geometry as native

BACKENDS = ("auto", "native", "numpy")


def resolve_backend(backend: str = "auto") -> str:
  """A connectivity backend name resolved to "native" or "numpy"
  (graphcast_tpu geometry/connectivity.py:22-39): "auto" is native when
  the library builds, else numpy; "native" raises, with the compiler's
  message, when it does not build. Points on an edge shared by two
  triangles may resolve to different (both valid) faces in the two
  backends, so the resolved name is part of the artifact's cache key
  (artifact.py)."""
  if backend not in BACKENDS:
    raise ValueError(f"unknown geometry backend {backend!r}; one of "
                     f"{BACKENDS}")
  if backend == "auto":
    return "native" if native.available() else "numpy"
  if backend == "native":
    native.load_library()
  return backend


def radius_query_indices(
    grid_lat: np.ndarray,
    grid_lon: np.ndarray,
    mesh: TriangularMesh,
    radius: float,
    backend: str = "auto") -> tuple[np.ndarray, np.ndarray]:
  """Edges (grid_idx, mesh_idx) for all pairs within `radius` in R3.

  Grid nodes are flattened lat-major (index = i_lat * num_lon + i_lon).
  """
  grid_positions = grid_lat_lon_to_node_coordinates(grid_lat, grid_lon)
  if resolve_backend(backend) == "native":
    # The library's pair order differs; the artifact sorts the edges.
    return native.radius_query(grid_positions.astype(np.float64),
                               mesh.vertices.astype(np.float64), radius)
  kd_tree = spatial.cKDTree(mesh.vertices)
  query = kd_tree.query_ball_point(x=grid_positions, r=radius)
  grid_edge_indices = []
  mesh_edge_indices = []
  for grid_index, mesh_neighbors in enumerate(query):
    grid_edge_indices.append(
        np.full(len(mesh_neighbors), grid_index, dtype=np.int32))
    mesh_edge_indices.append(np.asarray(mesh_neighbors, dtype=np.int32))
  return (np.concatenate(grid_edge_indices, axis=0),
          np.concatenate(mesh_edge_indices, axis=0))


def containing_triangle_indices(
    points: np.ndarray,
    mesh: TriangularMesh,
    num_candidates: int = 12,
    backend: str = "auto") -> np.ndarray:
  """Index of the mesh face whose spherical triangle contains each point.

  For each unit-norm point we take the `num_candidates` nearest face
  centroids and pick the candidate maximizing the minimum signed "inside"
  margin min_i dot(p, v_i × v_{i+1}); for a containing CCW triangle all three
  margins are ≥ 0. Points on shared edges/vertices resolve to an arbitrary
  adjacent face (margin 0), like the reference's closest-point query.
  """
  if resolve_backend(backend) == "native":
    return native.containing_triangles(
        points, mesh.vertices.astype(np.float64), mesh.faces)
  verts = mesh.vertices.astype(np.float64)
  faces = mesh.faces
  centroids = verts[faces].mean(axis=1)
  centroids /= np.linalg.norm(centroids, axis=-1, keepdims=True)
  tree = spatial.cKDTree(centroids)
  k = min(num_candidates, faces.shape[0])
  _, cand = tree.query(points, k=k)  # [num_points, k]
  if k == 1:
    cand = cand[:, None]

  v0 = verts[faces[cand, 0]]  # [num_points, k, 3]
  v1 = verts[faces[cand, 1]]
  v2 = verts[faces[cand, 2]]
  p = points[:, None, :]
  # Signed margins against each edge plane through the origin.
  m0 = np.einsum("pkd,pkd->pk", np.cross(v0, v1), p)
  m1 = np.einsum("pkd,pkd->pk", np.cross(v1, v2), p)
  m2 = np.einsum("pkd,pkd->pk", np.cross(v2, v0), p)
  min_margin = np.minimum(np.minimum(m0, m1), m2)
  best = np.argmax(min_margin, axis=1)
  chosen = cand[np.arange(points.shape[0]), best]

  # Safety: if some point's best margin is decidedly negative the candidate
  # list was too small — retry those with a full scan.
  bad = min_margin[np.arange(points.shape[0]), best] < -1e-9
  if np.any(bad):
    bad_idx = np.nonzero(bad)[0]
    for i in bad_idx:
      pbad = points[i]
      mm0 = np.cross(verts[faces[:, 0]], verts[faces[:, 1]]) @ pbad
      mm1 = np.cross(verts[faces[:, 1]], verts[faces[:, 2]]) @ pbad
      mm2 = np.cross(verts[faces[:, 2]], verts[faces[:, 0]]) @ pbad
      chosen[i] = np.argmax(np.minimum(np.minimum(mm0, mm1), mm2))
  return chosen.astype(np.int32)


def in_mesh_triangle_indices(
    grid_lat: np.ndarray,
    grid_lon: np.ndarray,
    mesh: TriangularMesh,
    backend: str = "auto") -> tuple[np.ndarray, np.ndarray]:
  """Edges (grid_idx, mesh_idx): each grid point to the 3 vertices of its
  containing triangle. Exactly 3 edges per grid point."""
  grid_positions = grid_lat_lon_to_node_coordinates(
      grid_lat, grid_lon).astype(np.float64)
  grid_positions /= np.linalg.norm(grid_positions, axis=-1, keepdims=True)
  face_idx = containing_triangle_indices(grid_positions, mesh,
                                         backend=backend)
  mesh_edge_indices = mesh.faces[face_idx].reshape(-1)  # [n_grid * 3]
  grid_edge_indices = np.repeat(
      np.arange(grid_positions.shape[0], dtype=np.int32), 3)
  return grid_edge_indices, mesh_edge_indices.astype(np.int32)
