"""Deep typed-graph GNN (port of graphcast_tpu/nn/deep_gnn.py; reference:
deep_typed_graph_net.py).

``DeepGraphNet`` is a ModuleDict of ``MLPWithNorm``s named as in the JAX
package (encoder_*/processor_{i}_*/decoder_*), so its parameter names are
that package's flat param keys. Two ways to run it:

- ``forward``, the general path (graphcast_tpu nn/deep_gnn.py:166-322):
  context concat, embed, ``num_message_passing_steps`` InteractionNetwork
  steps (nn/message_passing.py, factored edge updates) with node and edge
  residuals, node decode, on any TypedGraph with features laid out
  [entities, batch, channels]. The receiver aggregation of an edge set
  named in ``edge_aggregators`` goes through that aggregator, K3 in the
  models (ops/segment_sum.py); other sets through the plain segment sum
  (ops/segment.py). The models run it at batch > 1.
- ``processor_step``, the batch-1 fused step: the edge MLP, LayerNorm, edge
  residual and aggregation go through ops.fused_edge (K1); the node update
  and residual run here. It takes one hidden layer, layer norm on and no
  norm conditioning.

With ``norm_conditioning_size`` (GenCast's denoiser) every MLP but the
decoder's is norm-conditioned: a parameter-free LayerNorm, then a
``NormConditioning`` of the noise-level encoding (graphcast_tpu nn/
deep_gnn.py:75-96). All MLPs are swish MLPs with layer norm, as in both
models. ``remat_steps`` (the JAX package's processor rematerialisation) is
not ported and raises NotImplementedError.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
from torch import nn

from graphcast_tpu_torch.nn import message_passing as mp
from graphcast_tpu_torch.nn.core import MLPWithNorm
from graphcast_tpu_torch.nn.typed_graph import Context, TypedGraph
from graphcast_tpu_torch.ops import segment
from graphcast_tpu_torch.ops.fused_edge import EdgeIndex, fused_edge


class DeepGraphNet(nn.ModuleDict):
  """Encoder → processor steps → decoder MLPs over typed node/edge sets.

  Args:
    node_input_size / edge_input_size: feature width of each node / edge
      set (a node set's width includes the graph's context, if any).
    edge_sets: {edge set name: (sender node set, receiver node set)}, in
      the graph's edge order.
    Other arguments mirror graphcast_tpu.nn.deep_gnn.DeepGraphNet.
  """

  def __init__(self, node_latent_size: Mapping[str, int],
               edge_latent_size: Mapping[str, int],
               node_input_size: Mapping[str, int],
               edge_input_size: Mapping[str, int],
               edge_sets: Mapping[str, tuple[str, str]],
               mlp_hidden_size: int,
               mlp_num_hidden_layers: int,
               num_message_passing_steps: int,
               embed_nodes: bool = True,
               node_output_size: Optional[Mapping[str, int]] = None,
               norm_conditioning_size: Optional[int] = None,
               f32_aggregation: bool = False,
               aggregate_normalization: Optional[float] = None,
               remat_steps: bool = False):
    if remat_steps:
      raise NotImplementedError("DeepGraphNet(remat_steps=True) is not "
                                "ported")
    super().__init__()
    self.node_latent_size = dict(node_latent_size)
    self.edge_latent_size = dict(edge_latent_size)
    self.node_output_size = dict(node_output_size or {})
    self.num_message_passing_steps = num_message_passing_steps
    self.embed_nodes = embed_nodes
    self.norm_conditioning_size = norm_conditioning_size
    self.f32_aggregation = f32_aggregation
    self.aggregate_normalization = aggregate_normalization

    def mlp(in_size, out_size, use_layer_norm=True):
      return MLPWithNorm(
          in_size, mlp_hidden_size, mlp_num_hidden_layers, out_size,
          use_layer_norm=use_layer_norm,
          norm_conditioning_size=(norm_conditioning_size if use_layer_norm
                                  else None))

    def node_latent(name):
      return node_latent_size.get(name, node_input_size[name])

    specs = {}
    for name, latent in edge_latent_size.items():
      specs[f"encoder_edges_{name}"] = mlp(edge_input_size[name], latent)
    if embed_nodes:
      for name, latent in node_latent_size.items():
        specs[f"encoder_nodes_{name}"] = mlp(node_input_size[name], latent)
    for i in range(num_message_passing_steps):
      for name, latent in edge_latent_size.items():
        sender, receiver = edge_sets[name]
        specs[f"processor_{i}_edges_{name}"] = mlp(
            latent + node_latent(sender) + node_latent(receiver), latent)
      for name, latent in node_latent_size.items():
        received = sum(edge_latent_size[e] for e in edge_latent_size
                       if edge_sets[e][1] == name)
        specs[f"processor_{i}_nodes_{name}"] = mlp(latent + received, latent)
    for name, out in self.node_output_size.items():
      specs[f"decoder_nodes_{name}"] = mlp(node_latent_size[name], out,
                                           use_layer_norm=False)
    for name in sorted(specs):
      self[name] = specs[name]

  # ----- the general path -----

  def forward(self, graph: TypedGraph, cond: Optional[torch.Tensor] = None,
              edge_aggregators: Optional[Mapping[
                  str, Callable[[torch.Tensor], torch.Tensor]]] = None
              ) -> TypedGraph:
    """Embed, process and decode ``graph`` (module doc).

    Args:
      graph: features [entities, batch, channels].
      cond: [batch, K] norm-conditioning vectors (exactly when the net was
        built with ``norm_conditioning_size``).
      edge_aggregators: {edge set name: fn(messages [E, batch, C]) ->
        [N, batch, C]} for the receiver-sorted aggregations of those sets,
        summing in f32 and returning the messages' dtype (K3).
    """
    if (cond is None) != (self.norm_conditioning_size is None):
      raise ValueError("pass cond exactly when norm conditioning is on")
    gnc = cond[None] if cond is not None and cond.ndim == 2 else cond
    aggregators = edge_aggregators or {}

    def fn(name):
      module = self[name]
      if module.norm_conditioning is None:
        return module
      return lambda *xs: module(*xs, cond=gnc)

    def factored_fn(name):
      module = self[name]
      return lambda *xs: module.factored_edge_update(*xs, cond=(
          gnc if module.norm_conditioning is not None else None))

    def aggregate(data, indices, num_nodes, edge_set_name=None,
                  indices_are_sorted=True):
      kernel = aggregators.get(edge_set_name) if indices_are_sorted else None
      if kernel is not None:
        out = kernel(data)
        if self.aggregate_normalization is not None:
          out = out / self.aggregate_normalization
        return out
      return segment.aggregate_edges_for_nodes(
          data, indices, num_nodes, f32_aggregation=self.f32_aggregation,
          normalization=self.aggregate_normalization,
          indices_are_sorted=indices_are_sorted)

    # 1. Context broadcast-concatenated onto every node set (reference:
    # deep_typed_graph_net.py:333-350).
    ctx = graph.context.features
    if isinstance(ctx, torch.Tensor) and ctx.numel():
      nodes = {}
      for name, ns in graph.nodes.items():
        x = ns.features
        c = ctx[None].expand(tuple(x.shape[:-1]) + (ctx.shape[-1],))
        nodes[name] = ns._replace(features=torch.cat([x, c.to(x.dtype)], -1))
      graph = graph._replace(nodes=nodes, context=Context(features=()))

    # 2. Embed.
    graph = mp.apply_graph_map_features(
        graph,
        embed_edge_fn={n: fn(f"encoder_edges_{n}")
                       for n in self.edge_latent_size},
        embed_node_fn=({n: fn(f"encoder_nodes_{n}")
                        for n in self.node_latent_size}
                       if self.embed_nodes else None))

    # 3. Process, with node and edge residuals (reference:
    # deep_typed_graph_net.py:373-394).
    for i in range(self.num_message_passing_steps):
      prev = graph
      graph = mp.apply_graph_network(
          graph,
          update_edge_fn={n: factored_fn(f"processor_{i}_edges_{n}")
                          for n in self.edge_latent_size},
          update_node_fn={n: fn(f"processor_{i}_nodes_{n}")
                          for n in self.node_latent_size},
          aggregate_edges_for_nodes_fn=aggregate, factored_edge_fns=True)
      graph = graph._replace(
          nodes={k: ns._replace(features=prev.nodes[k].features + ns.features)
                 for k, ns in graph.nodes.items()},
          edges={k: es._replace(features=prev.edges[k].features + es.features)
                 for k, es in graph.edges.items()})

    # 4. Decode.
    return mp.apply_graph_map_features(
        graph, embed_node_fn={n: fn(f"decoder_nodes_{n}")
                              for n in self.node_output_size})

  # ----- the batch-1 fused step -----

  def processor_step(self, i: int, edge_name: str, node_name: str,
                     edges: EdgeIndex, x: torch.Tensor, e: torch.Tensor):
    """One fused processor step on a single node set / edge set graph
    (graphcast_tpu nn/deep_gnn.py:346-383). x: [N, C] node latents,
    e: [E, C] edge latents in ``edges`` order. Returns (x', e')."""
    if e.shape[0] != edges.num_edges:
      raise ValueError(f"{e.shape[0]} edge rows for {edges.num_edges} edges")
    dtype = e.dtype
    pe = self[f"processor_{i}_edges_{edge_name}"]
    if len(pe.mlp) != 2 or pe.layer_norm is None:
      raise NotImplementedError("the fused edge step takes one hidden layer "
                                "and layer norm without conditioning")
    we, ws, wr, b0 = pe.factored_first_layer(e.shape[-1], x.shape[-1], dtype)
    lin1 = pe.mlp["linear_1"]
    e_new, agg = fused_edge(edges, e, x @ ws, x @ wr, we, b0, lin1.w, lin1.b,
                            pe.layer_norm.scale, pe.layer_norm.offset,
                            write_edges=True)
    n_upd = self[f"processor_{i}_nodes_{node_name}"](x, agg.to(dtype))
    return x + n_upd, e_new
