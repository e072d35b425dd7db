"""Typed-graph message passing (port of graphcast_tpu/nn/message_passing.py;
reference: graphcast/typed_graph_net.py).

The Graph Nets algorithm over ``TypedGraph``s in the layout [entities,
batch, channels] with receiver-sorted edge indices:

- edge update: gather sender and receiver node features, concat with the
  edge features (and the broadcast context), apply the edge function; or,
  with ``factored_edge_fns``, hand the edge function the full node arrays
  and the indices so it can project per node before gathering;
- node update: aggregate the updated edge messages into their receivers
  (and, with ``include_sent_messages_in_node_update``, into their senders:
  an unsorted aggregation), concat with the node features, apply the node
  function;
- an optional global update over every node and edge set.

Aggregators take ``(data, indices, num_nodes, edge_set_name=,
indices_are_sorted=)``; the default is ops/segment.py's segment sum.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Union

import torch

from graphcast_tpu_torch.nn.typed_graph import TypedGraph
from graphcast_tpu_torch.ops import segment

UpdateFn = Callable[..., torch.Tensor]
AggregateFn = Callable[..., torch.Tensor]


def default_aggregation(data, receivers, num_nodes, edge_set_name=None,
                        indices_are_sorted=True):
  del edge_set_name
  return segment.aggregate_edges_for_nodes(
      data, receivers, num_nodes, indices_are_sorted=indices_are_sorted)


def _has_context(graph: TypedGraph) -> bool:
  f = graph.context.features
  return isinstance(f, torch.Tensor) and f.numel() > 0


def _broadcast_context(graph: TypedGraph, like: torch.Tensor):
  """The context repeated per entity (reference: typed_graph_net.py:146-152;
  one graph per tensor, so the repeat is a broadcast)."""
  ctx = graph.context.features
  return ctx[None].expand(tuple(like.shape[:-1]) + (ctx.shape[-1],)).to(
      like.dtype)


def apply_graph_network(
    graph: TypedGraph, *,
    update_edge_fn: Mapping[str, UpdateFn],
    update_node_fn: Mapping[str, UpdateFn],
    aggregate_edges_for_nodes_fn: Union[
        AggregateFn, Mapping[str, AggregateFn]] = default_aggregation,
    include_sent_messages_in_node_update: bool = False,
    factored_edge_fns: bool = False,
    update_global_fn: Optional[UpdateFn] = None,
    aggregate_nodes_for_globals_fn: Optional[AggregateFn] = None,
    aggregate_edges_for_globals_fn: Optional[AggregateFn] = None,
) -> TypedGraph:
  """One step of typed-graph message passing (graphcast_tpu/nn/
  message_passing.py:53-172): edge sets in ``update_edge_fn`` first, then
  node sets in ``update_node_fn`` from the updated edges, then the optional
  global update. ``aggregate_edges_for_nodes_fn`` is one aggregator or a
  mapping from edge set name to aggregator (default elsewhere). Factored
  edge functions are called as fn(edge_feats, sender_full, receiver_full,
  senders, receivers).
  """
  has_ctx = _has_context(graph)
  if isinstance(aggregate_edges_for_nodes_fn, Mapping):
    edge_aggregators = aggregate_edges_for_nodes_fn

    def aggregate(data, idx, num, edge_set_name=None,
                  indices_are_sorted=True):
      fn = edge_aggregators.get(edge_set_name, default_aggregation)
      return fn(data, idx, num, edge_set_name=edge_set_name,
                indices_are_sorted=indices_are_sorted)
  else:
    aggregate = aggregate_edges_for_nodes_fn

  updated_edges = dict(graph.edges)
  for name, edge_fn in update_edge_fn.items():
    key = graph.edge_key_by_name(name)
    edge_set = graph.edges[key]
    senders = edge_set.indices.senders
    receivers = edge_set.indices.receivers
    sender_full = graph.nodes[key.node_sets[0]].features
    receiver_full = graph.nodes[key.node_sets[1]].features
    if factored_edge_fns:
      if has_ctx:
        raise ValueError(
            "factored edge updates don't support global-to-edge broadcast; "
            "concat context onto nodes first (as DeepGraphNet does) or use "
            "factored_edge_fns=False")
      new_feats = edge_fn(edge_set.features, sender_full, receiver_full,
                          senders, receivers)
    else:
      inputs = [edge_set.features, sender_full.index_select(0, senders),
                receiver_full.index_select(0, receivers)]
      if has_ctx:
        inputs.append(_broadcast_context(graph, edge_set.features))
      new_feats = edge_fn(*inputs)
    updated_edges[key] = edge_set._replace(features=new_feats)
  graph = graph._replace(edges=updated_edges)

  updated_nodes = dict(graph.nodes)
  for node_set_name, node_fn in update_node_fn.items():
    node_set = graph.nodes[node_set_name]
    num_nodes = node_set.features.shape[0]
    inputs = [node_set.features]
    if include_sent_messages_in_node_update:
      for key, edge_set in graph.edges.items():
        if key.node_sets[0] == node_set_name:
          # Sender ids of a receiver-sorted list are unsorted: the
          # aggregator must take its unsorted path (never K3).
          inputs.append(aggregate(
              edge_set.features, edge_set.indices.senders, num_nodes,
              edge_set_name=key.name, indices_are_sorted=False))
    for key, edge_set in graph.edges.items():
      if key.node_sets[1] == node_set_name:
        inputs.append(aggregate(
            edge_set.features, edge_set.indices.receivers, num_nodes,
            edge_set_name=key.name))
    if has_ctx:
      inputs.append(_broadcast_context(graph, node_set.features))
    updated_nodes[node_set_name] = node_set._replace(
        features=node_fn(*inputs))
  graph = graph._replace(nodes=updated_nodes)

  # Global update (reference: typed_graph_net.py:187-225): one graph per
  # tensor, so the per-graph aggregation is a reduction over the entity
  # axis; inputs in name order, as jraph.concatenated_args flattens them.
  if update_global_fn is not None:
    def _reduce(agg_fn, feats):
      if agg_fn is None:
        return feats.sum(0)
      zeros = torch.zeros(feats.shape[0], dtype=torch.int32,
                          device=feats.device)
      return agg_fn(feats, zeros, 1)[0]
    inputs = [_reduce(aggregate_nodes_for_globals_fn,
                      graph.nodes[name].features)
              for name in sorted(graph.nodes)]
    inputs += [_reduce(aggregate_edges_for_globals_fn,
                       graph.edges[key].features)
               for key in sorted(graph.edges, key=lambda k: k.name)]
    if has_ctx:
      inputs.append(graph.context.features)
    graph = graph._replace(
        context=graph.context._replace(features=update_global_fn(*inputs)))
  return graph


def apply_graph_map_features(
    graph: TypedGraph, *,
    embed_edge_fn: Optional[Mapping[str, UpdateFn]] = None,
    embed_node_fn: Optional[Mapping[str, UpdateFn]] = None) -> TypedGraph:
  """Maps node and edge features independently (reference:
  typed_graph_net.py:278-317, GraphMapFeatures)."""
  updated_edges = dict(graph.edges)
  for name, fn in (embed_edge_fn or {}).items():
    key = graph.edge_key_by_name(name)
    updated_edges[key] = graph.edges[key]._replace(
        features=fn(graph.edges[key].features))
  updated_nodes = dict(graph.nodes)
  for name, fn in (embed_node_fn or {}).items():
    updated_nodes[name] = graph.nodes[name]._replace(
        features=fn(graph.nodes[name].features))
  return graph._replace(edges=updated_edges, nodes=updated_nodes)


def receiving_edge_sets(graph: TypedGraph, node_set_name: str):
  """Edge set keys whose receiver is ``node_set_name``, in graph order."""
  return [k for k in graph.edges if k.node_sets[1] == node_set_name]


def sending_edge_sets(graph: TypedGraph, node_set_name: str):
  """Edge set keys whose sender is ``node_set_name``, in graph order."""
  return [k for k in graph.edges if k.node_sets[0] == node_set_name]
