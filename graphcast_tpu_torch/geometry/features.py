"""Structural (position-derived) node & edge features. Host-side numpy.

Pinned numpy copy of graphcast_tpu/geometry/features.py (that package
imports jax at its root); tests/test_torch_geometry.py asserts that the two
build identical artifacts.

Native re-implementation of the geometry half of the reference's
model_utils.py (:24-592): latitude/longitude features for nodes, and edge
displacement features expressed in a local coordinate frame rotated so the
receiver sits at latitude/longitude zero.

Coordinate conventions (reference: model_utils.py:170-202):
  phi   = longitude in radians,
  theta = polar angle = 90° − latitude in radians.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.spatial import transform


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
