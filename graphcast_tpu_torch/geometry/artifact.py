"""The geometry compiler: static graph artifacts built once on the host.

Pinned numpy copy of graphcast_tpu/geometry/artifact.py, cut to what
GraphCast and GenCast need: the multi-mesh (GraphCast) or finest-level
(GenCast) processor graph, the latter in the banded node order that keeps
the transformer's k-hop attention mask block-compact (RCM bands, or BFS
patches with ``banded_patch_size``), and the disk cache; no multi-mesh
spatial permutation. ``sort_edges_by_receiver`` comes along from
graphcast_tpu/nn/typed_graph.py. ``backend`` picks the connectivity
backend as the JAX package does (geometry/connectivity.py
``resolve_backend``): ``"auto"``, the default, is the native C++ library
whenever it builds, else numpy. tests/test_torch_geometry.py and
tests/test_torch_native_geometry.py assert that every array of this
artifact equals the JAX package's, backend by backend.

All edge lists are sorted by receiver: the port's kernels walk them as
receiver-sorted rows (ops/fused_edge.py) or as exactly 3 rows per grid node
(ops/fused_decoder.py).

The models take their artifact from ``cached_artifact``: one build per
process for each grid and mesh configuration (the last
``ARTIFACT_CACHE_SIZE`` kept), shared read-only by every model of that
configuration. Behind it, ``build_artifact`` reads and writes the JAX
package's disk cache (``cache_dir``, artifact.py:330-381 there): the same
key, file name and arrays, so a file written by either package serves the
other. The key names the resolved connectivity backend, so an artifact of
one backend is never served as the other's. ``cache_dir=None`` means
``$GRAPHCAST_TPU_CACHE``, else ``~/.cache/graphcast_tpu``; ``""`` disables
the cache. One difference: an empty ``GRAPHCAST_TPU_CACHE`` disables the
port's cache, where the JAX package reads it as the current directory.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import inspect
import os
import pathlib
import threading
from typing import Optional

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import reverse_cuthill_mckee

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
    permute_banded: bool = False,
    banded_patch_size: Optional[int] = None,
    cache_dir: Optional[str] = None,
    backend: str = "auto",
) -> GridMeshArtifact:
  """Builds (or loads from the disk cache) the full graph artifact.

  Args:
    grid_lat/grid_lon: 1D coordinate arrays in degrees.
    mesh_size: number of icosahedron splits (finest level).
    radius_query_fraction_edge_length: grid2mesh query radius as a fraction
      of the finest mesh's max edge length (reference: graphcast.py:323-326).
    mesh2grid_edge_normalization_factor: optional fixed edge-feature
      normalization for checkpoint compatibility (graphcast.py:190-193).
    multimesh: if True the processor edge set is the union over all
      refinement levels (GraphCast); if False only the finest level
      (GenCast's denoiser).
    permute_banded: reorder the finest mesh's vertices so the k-hop
      attention mask is block-compact (GenCast; only with multimesh=False).
    banded_patch_size: with permute_banded, contiguous BFS patches of this
      many nodes instead of RCM bands (see ``patch_permutation``).
    cache_dir: disk cache directory (module doc); "" disables it.
    backend: connectivity backend, "auto" (native if it builds, else
      numpy), "native" (raises if it does not build) or "numpy"; the
      resolved name is part of the cache key.
  """
  grid_lat = np.asarray(grid_lat, dtype=np.float32)
  grid_lon = np.asarray(grid_lon, dtype=np.float32)
  if permute_banded and multimesh:
    raise ValueError("permute_banded requires multimesh=False")
  # The JAX package's key tuple: (multimesh, permute_banded,
  # spatial_permutation, resolved backend[, banded_patch_size]).
  backend = connectivity.resolve_backend(backend)
  options = (multimesh, permute_banded, False, backend)
  if banded_patch_size is not None:
    options += (banded_patch_size,)
  cache_path = _cache_path(
      cache_dir, grid_lat, grid_lon, mesh_size,
      radius_query_fraction_edge_length, mesh2grid_edge_normalization_factor,
      options)
  if cache_path is not None and cache_path.exists():
    return _load(cache_path, mesh_size, grid_lat, grid_lon)

  meshes = icosahedron.get_mesh_hierarchy(mesh_size)
  finest = meshes[-1]
  processor_faces = (icosahedron.merge_meshes(meshes).faces if multimesh
                     else None)
  if permute_banded:
    finest = permute_mesh_to_banded(finest, patch_size=banded_patch_size)
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
      grid_lat, grid_lon, finest, radius, backend=backend)
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
      grid_lat, grid_lon, finest, backend=backend)
  _, _, m2g_edge_feats = features.bipartite_graph_spatial_features(
      mesh_lat, mesh_lon, grid_nodes_lat, grid_nodes_lon,
      m2g_mesh, m2g_grid,
      edge_normalization_factor=mesh2grid_edge_normalization_factor)
  mesh2grid = _sorted_edges(m2g_mesh, m2g_grid, m2g_edge_feats)

  artifact = GridMeshArtifact(
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
  if cache_path is not None:
    _save(cache_path, artifact)
  return artifact


# --- disk cache (graphcast_tpu/geometry/artifact.py:330-381) ---

_CACHE_VERSION = 2
CACHE_ENV = "GRAPHCAST_TPU_CACHE"


def default_cache_dir() -> Optional[str]:
  """``$GRAPHCAST_TPU_CACHE``, else ``~/.cache/graphcast_tpu``; None (no
  cache) where the variable is set and empty."""
  value = os.environ.get(CACHE_ENV)
  if value is None:
    return os.path.join(os.path.expanduser("~"), ".cache", "graphcast_tpu")
  return value or None


def _cache_path(cache_dir, grid_lat, grid_lon, mesh_size, fraction,
                norm_factor, options) -> Optional[pathlib.Path]:
  """The JAX package's cache file for these arguments, or None."""
  if cache_dir == "":
    return None
  if cache_dir is None:
    cache_dir = default_cache_dir()
    if cache_dir is None:
      return None
  h = hashlib.sha256()
  h.update(grid_lat.tobytes())
  h.update(grid_lon.tobytes())
  h.update(repr((mesh_size, fraction, norm_factor, options,
                 _CACHE_VERSION)).encode())
  return pathlib.Path(cache_dir) / f"artifact_{h.hexdigest()[:16]}.npz"


_ARRAY_FIELDS = (
    "mesh_vertices", "mesh_faces", "mesh_nodes_lat", "mesh_nodes_lon",
    "grid_nodes_lat", "grid_nodes_lon", "grid_node_features",
    "mesh_node_features")
_EDGE_FIELDS = ("grid2mesh", "mesh", "mesh2grid")


def _save(path: pathlib.Path, artifact: GridMeshArtifact):
  """Writes the artifact's arrays under the JAX package's names, through a
  temporary file of this process and thread renamed into place (a reader
  never sees half a file, and processes that build the same artifact at
  once, the ranks of a job, never write one file)."""
  path.parent.mkdir(parents=True, exist_ok=True)
  payload = {f: getattr(artifact, f) for f in _ARRAY_FIELDS}
  for name in _EDGE_FIELDS:
    e = getattr(artifact, name)
    payload[f"{name}_senders"] = e.senders
    payload[f"{name}_receivers"] = e.receivers
    payload[f"{name}_features"] = e.features
  tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.npz")
  np.savez_compressed(tmp, **payload)
  os.replace(tmp, path)


def _load(path: pathlib.Path, mesh_size, grid_lat, grid_lon
          ) -> GridMeshArtifact:
  with np.load(path) as data:
    kwargs = {f: data[f] for f in _ARRAY_FIELDS}
    for name in _EDGE_FIELDS:
      kwargs[name] = EdgeArrays(
          senders=data[f"{name}_senders"],
          receivers=data[f"{name}_receivers"],
          features=data[f"{name}_features"])
  return GridMeshArtifact(mesh_size=mesh_size, grid_lat=grid_lat,
                          grid_lon=grid_lon, **kwargs)


ARTIFACT_CACHE_SIZE = 4
_ARTIFACTS: collections.OrderedDict = collections.OrderedDict()


def cached_artifact(grid_lat: np.ndarray, grid_lon: np.ndarray,
                    mesh_size: int, **kwargs) -> GridMeshArtifact:
  """``build_artifact`` with the same arguments, built once per process:
  models of one configuration (a card and a CPU copy, a model loaded from
  a checkpoint beside a fresh one) share the artifact, which nobody
  modifies. The least recently used entry beyond ``ARTIFACT_CACHE_SIZE``
  is dropped. ``cache_dir`` (the disk cache behind this one) is not part
  of the key: it changes where an artifact is kept, not the artifact.
  ``backend`` enters the key resolved: "auto" and the backend it resolves
  to share an entry."""
  grid_lat = np.asarray(grid_lat, dtype=np.float32)
  grid_lon = np.asarray(grid_lon, dtype=np.float32)
  args = inspect.signature(build_artifact).bind(grid_lat, grid_lon,
                                                mesh_size, **kwargs)
  args.apply_defaults()  # a default given or left out is the same key
  args.arguments["backend"] = connectivity.resolve_backend(
      args.arguments["backend"])
  key = (grid_lat.tobytes(), grid_lon.tobytes(),
         tuple((k, v) for k, v in args.arguments.items()
               if k not in ("grid_lat", "grid_lon", "cache_dir")))
  if key in _ARTIFACTS:
    _ARTIFACTS.move_to_end(key)
  else:
    _ARTIFACTS[key] = build_artifact(*args.args, **args.kwargs)
    while len(_ARTIFACTS) > ARTIFACT_CACHE_SIZE:
      _ARTIFACTS.popitem(last=False)
  return _ARTIFACTS[key]


def permute_mesh_to_banded(
    mesh: icosahedron.TriangularMesh,
    patch_size: Optional[int] = None) -> icosahedron.TriangularMesh:
  """Reorders a mesh's vertices so the attention mask is block-compact:
  RCM bands or, with ``patch_size``, contiguous BFS patches."""
  senders, receivers = icosahedron.faces_to_edges(mesh.faces)
  num_nodes = mesh.vertices.shape[0]
  if patch_size is not None:
    perm = patch_permutation(senders, receivers, num_nodes,
                             mesh.vertices, patch_size)
  else:
    perm = rcm_permutation(senders, receivers, num_nodes)
  inverse = np.empty(num_nodes, dtype=np.int32)
  inverse[perm] = np.arange(num_nodes, dtype=np.int32)
  return icosahedron.TriangularMesh(
      vertices=mesh.vertices[perm],
      faces=inverse[mesh.faces].astype(np.int32))


def rcm_permutation(senders: np.ndarray, receivers: np.ndarray,
                    num_nodes: int) -> np.ndarray:
  """Reverse-Cuthill-McKee node ordering, which makes the adjacency
  banded."""
  data = np.ones_like(senders, dtype=np.int8)
  adj = csr_matrix((data, (senders, receivers)),
                   shape=(num_nodes, num_nodes))
  perm = reverse_cuthill_mckee(adj, symmetric_mode=True)
  return np.asarray(perm, dtype=np.int32)


def patch_permutation(senders: np.ndarray, receivers: np.ndarray,
                      num_nodes: int, vertices: np.ndarray,
                      patch_size: int) -> np.ndarray:
  """Orders nodes into contiguous BFS patches of ``patch_size`` nodes.

  Patches grow by BFS on the mesh adjacency from seeds taken in
  z-then-longitude sweep order, so consecutive patches are spatially
  adjacent too; the unplaced BFS frontier is released for later patches,
  so every patch but the last has exactly ``patch_size`` nodes. A k-hop
  ball around a node then touches few (q-tile, kv-tile) pairs of the
  attention."""
  data = np.ones_like(senders, dtype=np.int8)
  adj = csr_matrix((data, (senders, receivers)),
                   shape=(num_nodes, num_nodes)).tocsr()
  indptr, indices = adj.indptr, adj.indices
  visited = np.zeros(num_nodes, dtype=bool)
  order = np.empty(num_nodes, dtype=np.int32)
  pos = 0
  z = vertices[:, 2]
  lon = np.arctan2(vertices[:, 1], vertices[:, 0])
  seeds_sorted = np.argsort(z * 1000.0 + lon, kind="stable")
  si = 0
  queue = collections.deque()
  while pos < num_nodes:
    while si < num_nodes and visited[seeds_sorted[si]]:
      si += 1
    seed = seeds_sorted[si]
    queue.clear()
    queue.append(seed)
    visited[seed] = True
    count = 0
    while queue and count < patch_size:
      u = queue.popleft()
      order[pos] = u
      pos += 1
      count += 1
      for v in indices[indptr[u]:indptr[u + 1]]:
        if not visited[v]:
          visited[v] = True
          queue.append(v)
    while queue:
      visited[queue.pop()] = False
  return order
