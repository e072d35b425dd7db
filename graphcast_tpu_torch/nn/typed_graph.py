"""Typed graph containers (port of graphcast_tpu/nn/typed_graph.py;
reference: graphcast/typed_graph.py:45-97).

A ``TypedGraph`` holds named node sets and edge sets; each edge set is keyed
by its name and its (sender set, receiver set) pair. As in the JAX package
there is one graph per tensor: the batch lives inside the features, laid out
[num_nodes, batch, channels] and [num_edges, batch, channels], and edge
indices are receiver-sorted int32 tensors on the features' device.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple


class EdgesIndices(NamedTuple):
  senders: Any    # [num_edges] int32
  receivers: Any  # [num_edges] int32
  # Optional (sender, receiver) ops.gather.RowGather pair of these indices:
  # the edge update gathers node rows through it (a fixed-order backward).
  gathers: Any = None


class EdgeSet(NamedTuple):
  indices: EdgesIndices
  features: Any  # [num_edges, ...]


class NodeSet(NamedTuple):
  n_node: int
  features: Any  # [num_nodes, ...]


class Context(NamedTuple):
  features: Any  # () or [batch, channels]


class EdgeSetKey(NamedTuple):
  name: str
  node_sets: tuple[str, str]  # (sender node set, receiver node set)


class TypedGraph(NamedTuple):
  context: Context
  nodes: Mapping[str, NodeSet]
  edges: Mapping[EdgeSetKey, EdgeSet]

  def edge_key_by_name(self, name: str) -> EdgeSetKey:
    for key in self.edges:
      if key.name == name:
        return key
    raise KeyError(f"no edge set named {name!r}")

  def edge_set_by_name(self, name: str) -> EdgeSet:
    return self.edges[self.edge_key_by_name(name)]
