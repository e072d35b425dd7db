"""Deep typed-graph GNN, batch-1 fused path
(port of graphcast_tpu/nn/deep_gnn.py; reference: deep_typed_graph_net.py).

``DeepGraphNet`` is a ModuleDict of ``MLPWithNorm``s named as in the JAX
package (encoder_*/processor_{i}_*/decoder_*), so its parameter names are
that package's flat param keys. It holds the embed, node-update and output
MLPs and runs the fused processor step (``processor_step``): the edge MLP,
LayerNorm, edge residual and aggregation go through ops.fused_edge (K1); the
node update and residual run here.

Only what the batch-1 fused paths need is ported: swish MLPs with exactly
one hidden layer, layer norm on, no sent messages in the node update. With
``norm_conditioning_size`` (GenCast's denoiser) every MLP but the decoder's
is norm-conditioned: a parameter-free LayerNorm, then a ``NormConditioning``
of the noise-level encoding (graphcast_tpu nn/deep_gnn.py:75-96). The general message-passing path of the JAX
package (nn/message_passing.py, batch > 1) is not ported; anything outside
the slice raises NotImplementedError.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from graphcast_tpu_torch.nn.core import MLPWithNorm
from graphcast_tpu_torch.ops.fused_edge import EdgeIndex, fused_edge


class DeepGraphNet(nn.ModuleDict):
  """Encoder → processor steps → decoder MLPs over typed node/edge sets.

  Args:
    node_input_size / edge_input_size: feature width of each node / edge set.
    edge_sets: {edge set name: (sender node set, receiver node set)}.
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
               norm_conditioning_size: Optional[int] = None):
    if mlp_num_hidden_layers != 1:
      raise NotImplementedError(
          "the fused edge step takes exactly one hidden layer; the general "
          "message-passing path is not ported")
    super().__init__()
    self.num_message_passing_steps = num_message_passing_steps

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
    for name, out in (node_output_size or {}).items():
      specs[f"decoder_nodes_{name}"] = mlp(node_latent_size[name], out,
                                           use_layer_norm=False)
    for name in sorted(specs):
      self[name] = specs[name]

  def processor_step(self, i: int, edge_name: str, node_name: str,
                     edges: EdgeIndex, x: torch.Tensor, e: torch.Tensor):
    """One fused processor step on a single node set / edge set graph
    (graphcast_tpu nn/deep_gnn.py:346-383). x: [N, C] node latents,
    e: [E, C] edge latents in ``edges`` order. Returns (x', e')."""
    if e.shape[0] != edges.num_edges:
      raise ValueError(f"{e.shape[0]} edge rows for {edges.num_edges} edges")
    dtype = e.dtype
    pe = self[f"processor_{i}_edges_{edge_name}"]
    we, ws, wr, b0 = pe.factored_first_layer(e.shape[-1], x.shape[-1], dtype)
    lin1 = pe.mlp["linear_1"]
    e_new, agg = fused_edge(edges, e, x @ ws, x @ wr, we, b0, lin1.w, lin1.b,
                            pe.layer_norm.scale, pe.layer_norm.offset,
                            write_edges=True)
    n_upd = self[f"processor_{i}_nodes_{node_name}"](x, agg.to(dtype))
    return x + n_upd, e_new
