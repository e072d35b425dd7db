"""Balanced node-aligned chunks of a receiver-sorted edge list.

Pinned numpy copy of graphcast_tpu/geometry/chunking.py (``NodeChunkPlan``,
``plan_balanced_node_chunks``); tests/test_torch_memory_forms.py asserts
that its plan equals the JAX package's field for field.

The chunked grid2mesh encoders (models/graphcast.py, models/denoiser.py)
run the edge set in sequential chunks, so that peak memory scales with
E / num_chunks. Chunk boundaries sit on receiver-node boundaries (the edges
are receiver-sorted) such that every chunk carries about E / k edges; each
chunk's receivers are then local to its node range, and its aggregation is
a small sorted segment sum into that range alone.

The JAX package runs the chunks with ``lax.map``, which needs uniform
shapes, and so pads each chunk's edges and nodes to the largest
(``edge_layout``, ``local_receivers``, ``node_gather``). The port's loop
over chunks is a Python loop: it reads chunk i's edges as the contiguous
range ``[edge_bounds[i], edge_bounds[i + 1])`` of the original arrays, with
receivers ``receivers - node_bounds[i]`` and no padding slots. The padded
fields are kept all the same, so that the plan can be pinned.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class NodeChunkPlan:
  """Balanced node-aligned chunking of a receiver-sorted edge list."""
  num_chunks: int
  num_nodes: int
  num_edges: int
  max_nodes: int           # padded node count per chunk
  max_edges: int           # padded edge count per chunk
  node_bounds: np.ndarray  # [k+1] node-range boundaries
  # [k * max_edges] int64 into the original edge arrays; padding slots = E.
  edge_layout: np.ndarray
  # [k * max_edges] int32 receiver local to the chunk; padding = max_nodes.
  local_receivers: np.ndarray
  # [num_nodes] int32 into the flattened [k * max_nodes] per-chunk outputs.
  node_gather: np.ndarray

  @property
  def expansion(self) -> float:
    return self.num_chunks * self.max_edges / max(self.num_edges, 1)

  @property
  def edge_bounds(self) -> np.ndarray:
    """[k+1] int64 edge-range boundaries: chunk i owns the contiguous edges
    edge_bounds[i]:edge_bounds[i+1] of the receiver-sorted list."""
    valid = self.edge_layout < self.num_edges
    per_chunk = valid.reshape(self.num_chunks, self.max_edges).sum(1)
    return np.concatenate([[0], np.cumsum(per_chunk)]).astype(np.int64)

  def pad_edge_array(self, array: np.ndarray, fill=0) -> np.ndarray:
    """Reorders a per-edge host array into the [k * max_edges] padded
    chunk layout (padding slots = `fill`)."""
    array = np.asarray(array)
    out = np.full((self.edge_layout.shape[0],) + array.shape[1:], fill,
                  array.dtype)
    valid = self.edge_layout < self.num_edges
    out[valid] = array[self.edge_layout[valid]]
    return out


def plan_balanced_node_chunks(receivers: np.ndarray, num_nodes: int,
                              num_chunks: int) -> NodeChunkPlan:
  """Plans `num_chunks` node-aligned chunks with ≈ equal edge counts.

  Args:
    receivers: [E] non-decreasing receiver node ids.
    num_nodes: total receiver-node count.
    num_chunks: requested chunk count (clamped to [1, num_nodes]).
  """
  receivers = np.asarray(receivers, np.int32)
  if receivers.size and (np.diff(receivers) < 0).any():
    raise ValueError("receivers must be sorted")
  num_edges = int(receivers.shape[0])
  k = max(1, min(int(num_chunks), num_nodes))

  counts = np.bincount(receivers, minlength=num_nodes)
  offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

  # Node boundaries at ~equal cumulative edge counts.
  targets = (np.arange(1, k) * num_edges) / k
  inner = np.searchsorted(offsets[1:num_nodes], targets, side="left") + 1
  node_bounds = np.concatenate([[0], inner, [num_nodes]]).astype(np.int64)
  node_bounds = np.maximum.accumulate(node_bounds)  # monotone under ties

  node_counts = np.diff(node_bounds)
  edge_starts = offsets[node_bounds[:-1]]
  edge_ends = offsets[node_bounds[1:]]
  edge_counts = edge_ends - edge_starts
  max_nodes = int(node_counts.max()) if k else 1
  max_edges = max(int(edge_counts.max()), 1)

  edge_layout = np.full(k * max_edges, num_edges, np.int64)
  local_receivers = np.full(k * max_edges, max_nodes, np.int32)
  node_gather = np.zeros(num_nodes, np.int32)
  for i in range(k):
    dst = i * max_edges
    span = int(edge_counts[i])
    edge_layout[dst:dst + span] = np.arange(edge_starts[i], edge_ends[i])
    local_receivers[dst:dst + span] = (
        receivers[edge_starts[i]:edge_ends[i]] - node_bounds[i])
    lo, hi = int(node_bounds[i]), int(node_bounds[i + 1])
    node_gather[lo:hi] = i * max_nodes + np.arange(hi - lo, dtype=np.int32)

  return NodeChunkPlan(
      num_chunks=k, num_nodes=num_nodes, num_edges=num_edges,
      max_nodes=max_nodes, max_edges=max_edges, node_bounds=node_bounds,
      edge_layout=edge_layout, local_receivers=local_receivers,
      node_gather=node_gather)
