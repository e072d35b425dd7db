"""Icosahedral multi-mesh construction (host-side, runs once).

Pinned numpy copy of graphcast_tpu/geometry/icosahedron.py (that package
imports jax at its root); tests/test_torch_geometry.py asserts that the two
build identical artifacts.

Native re-implementation of the reference's icosahedral_mesh.py:
- regular icosahedron with circumscribed unit sphere, rotated with the same
  convention as the reference (icosahedral_mesh.py:145-165) so that mesh node
  positions — and therefore structural features — match;
- recursive 4-way face subdivision with midpoint dedup, projected back to the
  unit sphere (icosahedral_mesh.py:173-256);
- multi-mesh merge: finest vertices + union of faces at all refinement levels
  (icosahedral_mesh.py:37-56);
- faces → directed edge lists (icosahedral_mesh.py:259-284).

Unlike the reference we derive face orientation programmatically (outward
normals via convex hull) instead of a hand-checked table.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
from scipy.spatial import ConvexHull
from scipy.spatial import transform


class TriangularMesh(NamedTuple):
  """A triangular mesh on the unit sphere.

  vertices: [num_vertices, 3] unit-norm positions.
  faces: [num_faces, 3] vertex indices, counter-clockwise seen from outside.
  """
  vertices: np.ndarray
  faces: np.ndarray


def get_icosahedron() -> TriangularMesh:
  """Regular icosahedron with unit circumscribed sphere.

  Vertex layout and final orientation match the reference
  (icosahedral_mesh.py:91-170): canonical golden-ratio coordinates, then a
  rotation about the y axis placing a face plane horizontally at the top.
  """
  phi = (1.0 + np.sqrt(5.0)) / 2.0
  vertices = []
  for c1 in (1.0, -1.0):
    for c2 in (phi, -phi):
      vertices.append((c1, c2, 0.0))
      vertices.append((0.0, c1, c2))
      vertices.append((c2, 0.0, c1))
  vertices = np.array(vertices, dtype=np.float64)
  vertices /= np.linalg.norm([1.0, phi])

  # Faces from the convex hull, oriented counter-clockwise from outside.
  hull = ConvexHull(vertices)
  faces = []
  for simplex in hull.simplices:
    v0, v1, v2 = vertices[simplex]
    normal = np.cross(v1 - v0, v2 - v0)
    centroid = (v0 + v1 + v2) / 3.0
    if np.dot(normal, centroid) < 0:
      simplex = simplex[::-1]
    faces.append(simplex)
  faces = np.array(sorted(map(tuple, faces)), dtype=np.int32)

  # Same orientation convention as the reference: rotate about y by half the
  # supplement of the inter-face angle so a face plane sits at the top.
  angle_between_faces = 2 * np.arcsin(phi / np.sqrt(3.0))
  rotation_angle = (np.pi - angle_between_faces) / 2
  rotation_matrix = transform.Rotation.from_euler(
      seq="y", angles=rotation_angle).as_matrix()
  vertices = vertices @ rotation_matrix

  return TriangularMesh(vertices=vertices.astype(np.float32), faces=faces)


class _MidpointCache:
  """Dedups midpoint vertices across faces during subdivision."""

  def __init__(self, parent_vertices: np.ndarray):
    self._parent_count = parent_vertices.shape[0]
    self._new_positions: list[np.ndarray] = []
    self._index: dict[tuple[int, int], int] = {}
    self._parent_vertices = parent_vertices

  def midpoint_index(self, i: int, j: int) -> int:
    key = (i, j) if i < j else (j, i)
    idx = self._index.get(key)
    if idx is None:
      mid = self._parent_vertices[i] + self._parent_vertices[j]
      mid = mid / np.linalg.norm(mid)
      idx = self._parent_count + len(self._new_positions)
      self._new_positions.append(mid.astype(np.float32))
      self._index[key] = idx
    return idx

  def all_vertices(self) -> np.ndarray:
    if not self._new_positions:
      return self._parent_vertices
    return np.concatenate(
        [self._parent_vertices, np.stack(self._new_positions)], axis=0)


def split_mesh(mesh: TriangularMesh) -> TriangularMesh:
  """Splits every face into 4, projecting midpoints to the unit sphere.

  Child meshes reuse the parent's vertex array as a prefix, so vertex indices
  are consistent across refinement levels (required by merge_meshes).
  """
  cache = _MidpointCache(mesh.vertices)
  new_faces = []
  for a, b, c in mesh.faces:
    ab = cache.midpoint_index(a, b)
    bc = cache.midpoint_index(b, c)
    ca = cache.midpoint_index(c, a)
    # Orientation preserved: all four children counter-clockwise.
    new_faces.extend([(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)])
  return TriangularMesh(
      vertices=cache.all_vertices(),
      faces=np.array(new_faces, dtype=np.int32))


def get_mesh_hierarchy(splits: int) -> list[TriangularMesh]:
  """Meshes from icosahedron (level 0) to `splits` subdivisions, coarse→fine.

  Reference: get_hierarchy_of_triangular_meshes_for_sphere
  (icosahedral_mesh.py:59-88).
  """
  meshes = [get_icosahedron()]
  for _ in range(splits):
    meshes.append(split_mesh(meshes[-1]))
  return meshes


def merge_meshes(meshes: Sequence[TriangularMesh]) -> TriangularMesh:
  """Multi-mesh: finest vertices + union of faces at all levels.

  Reference: icosahedral_mesh.merge_meshes (icosahedral_mesh.py:37-56).
  """
  for i, mesh in enumerate(meshes[:-1]):
    num = mesh.vertices.shape[0]
    if not np.allclose(meshes[-1].vertices[:num], mesh.vertices):
      raise ValueError(f"mesh {i} vertices are not a prefix of the finest")
  return TriangularMesh(
      vertices=meshes[-1].vertices,
      faces=np.concatenate([m.faces for m in meshes], axis=0))


def faces_to_edges(faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
  """Directed edges from faces: (a,b,c) → a→b, b→c, c→a.

  On a closed orientable mesh every undirected edge appears in two faces with
  opposite orientation, so the result contains both directions of each edge
  (reference: icosahedral_mesh.py:259-284).
  """
  senders = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
  receivers = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
  return senders.astype(np.int32), receivers.astype(np.int32)


def max_edge_length(mesh: TriangularMesh) -> float:
  """Max 3D edge length (reference: graphcast.py:792-796)."""
  senders, receivers = faces_to_edges(mesh.faces)
  return float(np.linalg.norm(
      mesh.vertices[senders] - mesh.vertices[receivers], axis=-1).max())
