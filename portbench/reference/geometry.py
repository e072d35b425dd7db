"""The reference's own graph: the icosahedral multi-mesh, the grid2mesh and
mesh2grid edges and their structural features, worked out again from the
grid's coordinates and the configuration's mesh size.

A frozen copy of the port's host geometry (graphcast_tpu_torch/geometry/
icosahedron.py and features.py, and the edge builds of artifact.py), so
that the reference needs nothing the program made. The two connectivity
queries run in a frozen copy of the port's C++ kernels
(``geometry_kernels.cc`` beside this file), built with the port's flags
into ``portbench/_cache/reference/`` at first use: a grid point on an edge
shared by two triangles then resolves to the face the port picks. Built
graphs are kept as ``.npz`` files in the same directory, keyed by the
arguments.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import subprocess
from typing import NamedTuple, Optional, Sequence

import numpy as np
from scipy.spatial import ConvexHull
from scipy.spatial import transform

CACHE_DIR = pathlib.Path(__file__).resolve().parents[1] / "_cache" / "reference"
SOURCE = pathlib.Path(__file__).with_name("geometry_kernels.cc")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
GRAPH_VERSION = 1


# --- icosahedral meshes (copy of graphcast_tpu_torch/geometry/icosahedron.py)



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


# --- structural features (copy of graphcast_tpu_torch/geometry/features.py)




def lat_lon_deg_to_spherical(lat: np.ndarray, lon: np.ndarray):
  phi = np.deg2rad(lon)
  theta = np.deg2rad(90.0 - lat)
  return phi, theta


def spherical_to_lat_lon(phi: np.ndarray, theta: np.ndarray):
  lon = np.mod(np.rad2deg(phi), 360)
  lat = 90 - np.rad2deg(theta)
  return lat, lon


def cartesian_to_spherical(x, y, z):
  phi = np.arctan2(y, x)
  with np.errstate(invalid="ignore"):
    theta = np.arccos(z)  # unit radius
  return phi, theta


def spherical_to_cartesian(phi, theta):
  return (np.cos(phi) * np.sin(theta),
          np.sin(phi) * np.sin(theta),
          np.cos(theta))


def grid_lat_lon_to_node_coordinates(grid_lat: np.ndarray,
                                     grid_lon: np.ndarray) -> np.ndarray:
  """[num_lat*num_lon, 3] unit sphere positions, lat-major flattening."""
  lon2d, lat2d = np.meshgrid(grid_lon, grid_lat)
  phi, theta = lat_lon_deg_to_spherical(lat2d.reshape(-1), lon2d.reshape(-1))
  return np.stack(spherical_to_cartesian(phi, theta), axis=-1)


def rotation_matrices_to_receiver_local(
    reference_phi: np.ndarray,
    reference_theta: np.ndarray,
    rotate_latitude: bool = True,
    rotate_longitude: bool = True) -> np.ndarray:
  """Per-node rotation matrices to a receiver-local frame.

  Reference semantics (model_utils.py:283-356):
  - both: rotate about z by −phi (to lon 0), then about y to lat 0 ("zy");
  - longitude only: "z" by −phi;
  - latitude only: "zyz" — to lon 0, to lat 0, back by +phi so the polar
    geodesic stays axis-aligned.
  """
  azimuthal = -reference_phi
  polar = -reference_theta + np.pi / 2
  if rotate_longitude and rotate_latitude:
    return transform.Rotation.from_euler(
        "zy", np.stack([azimuthal, polar], axis=1)).as_matrix()
  if rotate_longitude:
    return transform.Rotation.from_euler("z", azimuthal).as_matrix()
  if rotate_latitude:
    return transform.Rotation.from_euler(
        "zyz", np.stack([azimuthal, polar, -azimuthal], axis=1)).as_matrix()
  raise ValueError("at least one of latitude/longitude must be rotated")


def _relative_positions_receiver_local(
    sender_pos: np.ndarray, receiver_pos: np.ndarray,
    receiver_phi: np.ndarray, receiver_theta: np.ndarray,
    rotate_latitude: bool, rotate_longitude: bool) -> np.ndarray:
  """sender − receiver displacement, in each receiver's local frame.

  sender_pos/receiver_pos: [num_edges, 3] already gathered per edge.
  receiver_phi/theta: [num_edges] angles of each edge's receiver.
  """
  if not (rotate_latitude or rotate_longitude):
    return sender_pos - receiver_pos
  rot = rotation_matrices_to_receiver_local(
      receiver_phi, receiver_theta,
      rotate_latitude=rotate_latitude, rotate_longitude=rotate_longitude)
  rotated_sender = np.einsum("eji,ei->ej", rot, sender_pos)
  rotated_receiver = np.einsum("eji,ei->ej", rot, receiver_pos)
  return rotated_sender - rotated_receiver


def node_features_from_lat_lon(lat: np.ndarray, lon: np.ndarray,
                               add_positions: bool = False,
                               add_latitude: bool = True,
                               add_longitude: bool = True) -> np.ndarray:
  """[num_nodes, F] structural features: [cos θ (=sin lat), cos λ, sin λ].

  Feature column order matches the reference (model_utils.py:78-96):
  positions (optional), cos(theta), cos(phi), sin(phi).
  """
  phi, theta = lat_lon_deg_to_spherical(lat, lon)
  cols = []
  if add_positions:
    cols.extend(spherical_to_cartesian(phi, theta))
  if add_latitude:
    cols.append(np.cos(theta))
  if add_longitude:
    cols.append(np.cos(phi))
    cols.append(np.sin(phi))
  if not cols:
    return np.zeros([lat.shape[0], 0], dtype=np.float32)
  return np.stack(cols, axis=-1).astype(np.float32)


def edge_features_from_positions(
    sender_lat: np.ndarray, sender_lon: np.ndarray,
    receiver_lat: np.ndarray, receiver_lon: np.ndarray,
    senders: np.ndarray, receivers: np.ndarray,
    *,
    rotate_latitude: bool = True,
    rotate_longitude: bool = True,
    edge_normalization_factor: Optional[float] = None) -> np.ndarray:
  """[num_edges, 4] edge features: [|d|, dx, dy, dz] / normalization.

  d is the sender−receiver displacement in the receiver-local rotated frame;
  normalization defaults to the max edge length so features land in [-1, 1]
  (reference: model_utils.py:114-131 and the bipartite variant :364-533; the
  explicit `edge_normalization_factor` supports loading weights trained on a
  different graph — graphcast.py:190-193).
  """
  s_phi, s_theta = lat_lon_deg_to_spherical(sender_lat, sender_lon)
  r_phi, r_theta = lat_lon_deg_to_spherical(receiver_lat, receiver_lon)
  sender_pos = np.stack(spherical_to_cartesian(s_phi, s_theta), axis=-1)
  receiver_pos = np.stack(spherical_to_cartesian(r_phi, r_theta), axis=-1)

  rel = _relative_positions_receiver_local(
      sender_pos[senders], receiver_pos[receivers],
      r_phi[receivers], r_theta[receivers],
      rotate_latitude, rotate_longitude)
  dist = np.linalg.norm(rel, axis=-1, keepdims=True)
  norm = edge_normalization_factor
  if norm is None:
    norm = dist.max()
  return np.concatenate([dist / norm, rel / norm], axis=-1).astype(np.float32)


def graph_spatial_features(node_lat, node_lon, senders, receivers,
                           **edge_kwargs):
  """Node + edge features for a unipartite graph (model_utils.py:24-141)."""
  node_feats = node_features_from_lat_lon(node_lat, node_lon)
  edge_feats = edge_features_from_positions(
      node_lat, node_lon, node_lat, node_lon, senders, receivers,
      **edge_kwargs)
  return node_feats, edge_feats


def bipartite_graph_spatial_features(
    sender_lat, sender_lon, receiver_lat, receiver_lon, senders, receivers,
    **edge_kwargs):
  """Sender/receiver node + edge features for a bipartite graph
  (model_utils.py:364-533)."""
  sender_feats = node_features_from_lat_lon(sender_lat, sender_lon)
  receiver_feats = node_features_from_lat_lon(receiver_lat, receiver_lon)
  edge_feats = edge_features_from_positions(
      sender_lat, sender_lon, receiver_lat, receiver_lon, senders, receivers,
      **edge_kwargs)
  return sender_feats, receiver_feats, edge_feats


# --- the C++ connectivity queries


def _library() -> ctypes.CDLL:
  """The frozen C++ kernels, compiled at first use under ``CACHE_DIR``
  (the file name carries a hash of the source, flags and target)."""
  target = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True, check=True).stdout
  h = hashlib.sha256(SOURCE.read_bytes())
  h.update(repr(CXX_FLAGS).encode())
  h.update(target.encode())
  path = CACHE_DIR / f"geometry_kernels_{h.hexdigest()[:16]}.so"
  if not path.exists():
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, path)
  lib = ctypes.CDLL(str(path))
  d, i64, i32 = ctypes.c_double, ctypes.c_int64, ctypes.c_int32
  lib.radius_query.restype = i64
  lib.radius_query.argtypes = [
      ctypes.POINTER(d), i64, ctypes.POINTER(d), i64, d,
      ctypes.POINTER(i32), ctypes.POINTER(i32), i64]
  lib.containing_triangles.restype = None
  lib.containing_triangles.argtypes = [
      ctypes.POINTER(d), i64, ctypes.POINTER(d), i64,
      ctypes.POINTER(i32), i64, ctypes.POINTER(i32)]
  return lib


def _ptr(a: np.ndarray, ctype):
  return a.ctypes.data_as(ctypes.POINTER(ctype))


def radius_query(lib, grid_pos: np.ndarray, mesh_pos: np.ndarray,
                 radius: float) -> tuple[np.ndarray, np.ndarray]:
  """Every (grid, mesh) pair within ``radius`` in R3."""
  grid_pos = np.ascontiguousarray(grid_pos, dtype=np.float64)
  mesh_pos = np.ascontiguousarray(mesh_pos, dtype=np.float64)
  args = (_ptr(grid_pos, ctypes.c_double), grid_pos.shape[0],
          _ptr(mesh_pos, ctypes.c_double), mesh_pos.shape[0], float(radius))
  count = lib.radius_query(*args, None, None, 0)
  out_grid = np.empty(count, dtype=np.int32)
  out_mesh = np.empty(count, dtype=np.int32)
  lib.radius_query(*args, _ptr(out_grid, ctypes.c_int32),
                   _ptr(out_mesh, ctypes.c_int32), count)
  return out_grid, out_mesh


def containing_triangles(lib, points: np.ndarray, vertices: np.ndarray,
                         faces: np.ndarray) -> np.ndarray:
  """The face whose spherical triangle contains each unit-norm point."""
  points = np.ascontiguousarray(points, dtype=np.float64)
  vertices = np.ascontiguousarray(vertices, dtype=np.float64)
  faces = np.ascontiguousarray(faces, dtype=np.int32)
  out = np.empty(points.shape[0], dtype=np.int32)
  lib.containing_triangles(
      _ptr(points, ctypes.c_double), points.shape[0],
      _ptr(vertices, ctypes.c_double), vertices.shape[0],
      _ptr(faces, ctypes.c_int32), faces.shape[0],
      _ptr(out, ctypes.c_int32))
  return out


# --- the graph


@dataclasses.dataclass(frozen=True)
class Graph:
  """Edge lists (senders, receivers, int64) with [E, 4] float32 features,
  and [N, 3] float32 node features. The processor edges are the union of
  every refinement level's (``multimesh``) or the finest level's."""
  grid_features: np.ndarray
  mesh_features: np.ndarray
  g2m: tuple
  mesh: tuple
  m2g: tuple

  @property
  def num_grid(self) -> int:
    return self.grid_features.shape[0]

  @property
  def num_mesh(self) -> int:
    return self.mesh_features.shape[0]


def _sorted(senders, receivers, feats) -> tuple:
  order = np.lexsort((senders, receivers))
  return (senders[order].astype(np.int64), receivers[order].astype(np.int64),
          feats[order])


def build_graph(grid_lat: np.ndarray, grid_lon: np.ndarray, mesh_size: int,
                radius_fraction: float, multimesh: bool,
                use_cache: bool = True) -> Graph:
  """The graph of a lat-major flattened grid and a ``mesh_size`` mesh,
  read from or written to ``CACHE_DIR`` when ``use_cache``."""
  grid_lat = np.asarray(grid_lat, np.float32)
  grid_lon = np.asarray(grid_lon, np.float32)
  h = hashlib.sha256(grid_lat.tobytes())
  h.update(grid_lon.tobytes())
  h.update(repr((mesh_size, radius_fraction, multimesh,
                 GRAPH_VERSION)).encode())
  path = CACHE_DIR / f"graph_{h.hexdigest()[:16]}.npz"
  if use_cache and path.exists():
    with np.load(path) as z:
      return Graph(z["grid_features"], z["mesh_features"],
                   tuple(z[f"g2m_{i}"] for i in range(3)),
                   tuple(z[f"mesh_{i}"] for i in range(3)),
                   tuple(z[f"m2g_{i}"] for i in range(3)))
  lib = _library()
  meshes = get_mesh_hierarchy(mesh_size)
  finest = meshes[-1]
  phi, theta = cartesian_to_spherical(*finest.vertices.T)
  mesh_lat, mesh_lon = (a.astype(np.float32)
                        for a in spherical_to_lat_lon(phi, theta))
  lon2d, lat2d = np.meshgrid(grid_lon, grid_lat)
  g_lat = lat2d.reshape(-1).astype(np.float32)
  g_lon = lon2d.reshape(-1).astype(np.float32)
  grid_pos = grid_lat_lon_to_node_coordinates(grid_lat, grid_lon)

  radius = max_edge_length(finest) * radius_fraction
  g2m_grid, g2m_mesh = radius_query(lib, grid_pos, finest.vertices, radius)
  grid_feats, mesh_feats, g2m_feats = bipartite_graph_spatial_features(
      g_lat, g_lon, mesh_lat, mesh_lon, g2m_grid, g2m_mesh)

  faces = merge_meshes(meshes).faces if multimesh else finest.faces
  m_send, m_recv = faces_to_edges(faces)
  _, mesh_feats_e = graph_spatial_features(mesh_lat, mesh_lon, m_send, m_recv)

  unit = grid_pos / np.linalg.norm(grid_pos, axis=-1, keepdims=True)
  face = containing_triangles(lib, unit, finest.vertices, finest.faces)
  m2g_mesh = finest.faces[face].reshape(-1)
  m2g_grid = np.repeat(np.arange(unit.shape[0], dtype=np.int32), 3)
  _, _, m2g_feats = bipartite_graph_spatial_features(
      mesh_lat, mesh_lon, g_lat, g_lon, m2g_mesh, m2g_grid)

  graph = Graph(grid_feats, mesh_feats,
                _sorted(g2m_grid, g2m_mesh, g2m_feats),
                _sorted(m_send, m_recv, mesh_feats_e),
                _sorted(m2g_mesh, m2g_grid, m2g_feats))
  if use_cache:
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    payload = {"grid_features": graph.grid_features,
               "mesh_features": graph.mesh_features}
    for name in ("g2m", "mesh", "m2g"):
      for i, a in enumerate(getattr(graph, name)):
        payload[f"{name}_{i}"] = a
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
    np.savez(tmp, **payload)
    os.replace(tmp, path)
  return graph


def k_hop_mask(senders: np.ndarray, receivers: np.ndarray, num_nodes: int,
               hops: int) -> np.ndarray:
  """bool [N, N]: whether receiver row i may attend to node j, i.e. j is
  within ``hops`` edges of i, i included."""
  from scipy.sparse import csr_matrix, identity
  adj = csr_matrix((np.ones(senders.shape[0], np.float32),
                    (receivers, senders)), shape=(num_nodes, num_nodes))
  adj = ((adj + adj.T) > 0).astype(np.float32)
  reach = identity(num_nodes, dtype=np.float32, format="csr")
  step = (identity(num_nodes, dtype=np.float32, format="csr") + adj)
  for _ in range(hops):
    reach = ((reach @ step) > 0).astype(np.float32)
  return reach.toarray() > 0
