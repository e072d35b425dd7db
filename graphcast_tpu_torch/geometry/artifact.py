"""The geometry compiler: static graph artifacts built once on the host.

Pinned numpy copy of graphcast_tpu/geometry/artifact.py, cut to what
GraphCast needs: the multi-mesh (or finest-level) processor graph, with no
disk cache, no banded / spatial permutations and no C++ backend.
``sort_edges_by_receiver`` comes along from graphcast_tpu/nn/typed_graph.py.
tests/test_torch_geometry.py asserts that every array of this artifact
equals the JAX package's (numpy backend).

All edge lists are sorted by receiver: the port's kernels walk them as
receiver-sorted rows (ops/fused_edge.py) or as exactly 3 rows per grid node
(ops/fused_decoder.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from graphcast_tpu_torch.geometry import connectivity, features, icosahedron


@dataclasses.dataclass(frozen=True)
class EdgeArrays:
  senders: np.ndarray    # [E] int32, sorted by receiver
  receivers: np.ndarray  # [E] int32, non-decreasing
  features: np.ndarray   # [E, F] float32


@dataclasses.dataclass(frozen=True)
class GridMeshArtifact:
  """Static graph data for one (grid, mesh) configuration."""
  mesh_size: int
  grid_lat: np.ndarray
  grid_lon: np.ndarray
  mesh_vertices: np.ndarray      # finest mesh, [V, 3]
  mesh_faces: np.ndarray         # finest mesh faces
  mesh_nodes_lat: np.ndarray     # [V]
  mesh_nodes_lon: np.ndarray     # [V]
  grid_nodes_lat: np.ndarray     # [num_grid]
  grid_nodes_lon: np.ndarray     # [num_grid]
  grid_node_features: np.ndarray  # [num_grid, 3]
  mesh_node_features: np.ndarray  # [V, 3]
  grid2mesh: EdgeArrays          # grid → mesh (radius query)
  mesh: EdgeArrays               # multi-mesh (all refinement levels)
  mesh2grid: EdgeArrays          # mesh → grid (triangle containment)

  @property
  def num_grid_nodes(self) -> int:
    return self.grid_nodes_lat.shape[0]

  @property
  def num_mesh_nodes(self) -> int:
    return self.mesh_vertices.shape[0]


def sort_edges_by_receiver(senders: np.ndarray, receivers: np.ndarray,
                           *extras: np.ndarray):
  """Stable-sorts an edge list by receiver (then sender) index
  (copy of graphcast_tpu/nn/typed_graph.py:61). Returns
  (senders, receivers, *extras) sorted."""
  order = np.lexsort((senders, receivers))
  out = [senders[order].astype(np.int32), receivers[order].astype(np.int32)]
  out.extend(e[order] for e in extras)
  return tuple(out)


def _sorted_edges(senders, receivers, feats) -> EdgeArrays:
  s, r, f = sort_edges_by_receiver(senders, receivers, feats)
  return EdgeArrays(senders=s, receivers=r, features=f)


def build_artifact(
    grid_lat: np.ndarray,
    grid_lon: np.ndarray,
    mesh_size: int,
    radius_query_fraction_edge_length: float = 0.6,
    mesh2grid_edge_normalization_factor: Optional[float] = None,
    multimesh: bool = True,
) -> GridMeshArtifact:
  """Builds the full graph artifact.

  Args:
    grid_lat/grid_lon: 1D coordinate arrays in degrees.
    mesh_size: number of icosahedron splits (finest level).
    radius_query_fraction_edge_length: grid2mesh query radius as a fraction
      of the finest mesh's max edge length (reference: graphcast.py:323-326).
    mesh2grid_edge_normalization_factor: optional fixed edge-feature
      normalization for checkpoint compatibility (graphcast.py:190-193).
    multimesh: if True the processor edge set is the union over all
      refinement levels (GraphCast); if False only the finest level.
  """
  grid_lat = np.asarray(grid_lat, dtype=np.float32)
  grid_lon = np.asarray(grid_lon, dtype=np.float32)

  meshes = icosahedron.get_mesh_hierarchy(mesh_size)
  finest = meshes[-1]
  processor_faces = (icosahedron.merge_meshes(meshes).faces if multimesh
                     else None)
  mesh_phi, mesh_theta = features.cartesian_to_spherical(
      finest.vertices[:, 0], finest.vertices[:, 1], finest.vertices[:, 2])
  mesh_lat, mesh_lon = features.spherical_to_lat_lon(mesh_phi, mesh_theta)
  mesh_lat = mesh_lat.astype(np.float32)
  mesh_lon = mesh_lon.astype(np.float32)

  lon2d, lat2d = np.meshgrid(grid_lon, grid_lat)
  grid_nodes_lat = lat2d.reshape(-1).astype(np.float32)
  grid_nodes_lon = lon2d.reshape(-1).astype(np.float32)

  radius = (icosahedron.max_edge_length(finest)
            * radius_query_fraction_edge_length)

  # --- grid2mesh (radius query), receivers are mesh nodes ---
  g2m_grid, g2m_mesh = connectivity.radius_query_indices(
      grid_lat, grid_lon, finest, radius)
  grid_feats, mesh_feats, g2m_edge_feats = (
      features.bipartite_graph_spatial_features(
          grid_nodes_lat, grid_nodes_lon, mesh_lat, mesh_lon,
          g2m_grid, g2m_mesh))
  grid2mesh = _sorted_edges(g2m_grid, g2m_mesh, g2m_edge_feats)

  # --- mesh processor edges (multi-mesh or finest) ---
  processor_mesh = (icosahedron.TriangularMesh(
      vertices=finest.vertices, faces=processor_faces) if multimesh
                    else finest)
  m_send, m_recv = icosahedron.faces_to_edges(processor_mesh.faces)
  _, mesh_edge_feats = features.graph_spatial_features(
      mesh_lat, mesh_lon, m_send, m_recv)
  mesh_edges = _sorted_edges(m_send, m_recv, mesh_edge_feats)

  # --- mesh2grid (triangle containment), receivers are grid nodes ---
  m2g_grid, m2g_mesh = connectivity.in_mesh_triangle_indices(
      grid_lat, grid_lon, finest)
  _, _, m2g_edge_feats = features.bipartite_graph_spatial_features(
      mesh_lat, mesh_lon, grid_nodes_lat, grid_nodes_lon,
      m2g_mesh, m2g_grid,
      edge_normalization_factor=mesh2grid_edge_normalization_factor)
  mesh2grid = _sorted_edges(m2g_mesh, m2g_grid, m2g_edge_feats)

  return GridMeshArtifact(
      mesh_size=mesh_size,
      grid_lat=grid_lat,
      grid_lon=grid_lon,
      mesh_vertices=finest.vertices,
      mesh_faces=finest.faces,
      mesh_nodes_lat=mesh_lat,
      mesh_nodes_lon=mesh_lon,
      grid_nodes_lat=grid_nodes_lat,
      grid_nodes_lon=grid_nodes_lon,
      grid_node_features=grid_feats,
      mesh_node_features=mesh_feats,
      grid2mesh=grid2mesh,
      mesh=mesh_edges,
      mesh2grid=mesh2grid)
