"""GraphCast: the encode-process-decode GNN one-step predictor.

Port of graphcast_tpu/models/graphcast.py (reference: graphcast.py:213-796).
At batch 1, its fused inference path:

  1. FieldSets → grid node features [num_grid_nodes, C]
  2. grid2mesh: embed grid and mesh nodes, one aggregation-only fused edge
     step (K1, encoder mode) into the mesh nodes, node updates + residuals
  3. mesh processor: embed the multi-mesh edges, gnn_msg_steps fused edge
     steps (K1, processor mode)
  4. mesh2grid: the fused decoder (K2) → [num_grid_nodes, num_outputs]
  5. outputs → FieldSet via the targets template

At batch > 1, the JAX package's general path (graphcast.py:864-903): the
three DeepGraphNets' ``forward`` on TypedGraphs laid out [nodes, batch, C],
with the mesh and grid2mesh aggregations through K3 (ops/segment_sum.py),
where the JAX package installs ``BlockedSegmentSum``, and the mesh2grid one
through the plain segment sum, as there. Nothing is hoisted at batch > 1
(``precompute_step_statics`` returns {}), as in the JAX package.

Which code runs is decided by the tensors' device alone: CUDA tensors go
through the CUDA kernels, CPU tensors through their plain-PyTorch twins
(ops/). The constructor takes the JAX package's keywords; ``hidden_layers !=
1``, chunked encode/decode (``decode_chunks``/``encode_chunks`` > 1), the
XLA-only and split ``fused_aggregation`` modes, ``remat_processor=True`` and
the artifact cache (``cache_dir``) are not ported and raise
NotImplementedError. ``GC_PIPELINED_EDGE`` (env_flags.py), read once at the
first call, as the JAX package builds its ``FusedEdgeStep``s then, runs the
encoder's and the processor's edge steps through K1p instead of K1.

The static graph (geometry/artifact.py) is built on the host at the first
call from the inputs' lat/lon coords and kept on the device of the call.
The encoder/decoder edge features are structural, so their edge-embed MLP
output times the first layer's edge block (+ bias) is constant across a
rollout: ``precompute_step_statics`` computes it once.

Training (``loss``, ``loss_and_predictions``): the weighted MSE of
losses.py with ``configs.GRAPHCAST_LOSS_WEIGHTS``. Under grad those static
edge parts are functions of the parameters, so they are computed inside
each step, chunk by chunk under ``torch.utils.checkpoint``: the edge-embed
MLP's intermediates over the 1.6M and 3.1M edges at 0.25° are recomputed in
the backward instead of kept. CUDA tensors run the backward kernels K4/K5.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.utils import checkpoint

from graphcast_tpu_torch import devices, env_flags, losses
from graphcast_tpu_torch.fields import FieldSet, from_stacked, to_stacked
from graphcast_tpu_torch.geometry import artifact as artifact_lib
from graphcast_tpu_torch.models import configs
from graphcast_tpu_torch.models.base import Predictor, refuse_unported_forms
from graphcast_tpu_torch.nn import core
from graphcast_tpu_torch.nn.deep_gnn import DeepGraphNet
from graphcast_tpu_torch.nn.typed_graph import (
    Context, EdgeSet, EdgeSetKey, EdgesIndices, NodeSet, TypedGraph)
from graphcast_tpu_torch.ops.fused_decoder import fused_decode
from graphcast_tpu_torch.ops.fused_edge import EdgeIndex, fused_edge
from graphcast_tpu_torch.ops.segment_sum import sorted_segment_sum

NODE_STRUCT_FEATURES = 3   # sin(lat), cos(lon), sin(lon)
EDGE_STRUCT_FEATURES = 4   # |d|, dx, dy, dz in the receiver's frame
_CONST_CHUNK_ROWS = 1 << 18


def add_batch_second_axis(data: torch.Tensor, batch: int, dtype):
  """[n, f] → [n, batch, f] in ``dtype`` (reference: graphcast.py:785-789)."""
  return data.to(dtype)[:, None].expand(data.shape[0], batch, data.shape[-1])


def edge_set(edges: EdgeIndex, features: torch.Tensor) -> EdgeSet:
  """A TypedGraph edge set over ``edges``' sender and receiver indices."""
  return EdgeSet(EdgesIndices(edges.senders, edges.receivers), features)


def grid2mesh_graph(st: dict, grid_node_features: torch.Tensor
                    ) -> TypedGraph:
  """The grid2mesh TypedGraph of [num_grid, batch, C] grid node features:
  grid nodes carry [features ++ structural], mesh nodes [zeros ++
  structural] (reference: graphcast.py:609-663). ``st``: a model's device
  statics (edge lists, structural node and edge features)."""
  batch, dtype = grid_node_features.shape[1], grid_node_features.dtype
  edges = st["g2m"]
  dummy = grid_node_features.new_zeros(
      (edges.num_receivers,) + tuple(grid_node_features.shape[1:]))
  return TypedGraph(
      context=Context(features=()),
      nodes={
          "grid_nodes": NodeSet(edges.num_senders, torch.cat(
              [grid_node_features, add_batch_second_axis(
                  st["grid_node_features"], batch, dtype)], dim=-1)),
          "mesh_nodes": NodeSet(edges.num_receivers, torch.cat(
              [dummy, add_batch_second_axis(st["mesh_node_features"], batch,
                                            dtype)], dim=-1)),
      },
      edges={EdgeSetKey("grid2mesh", ("grid_nodes", "mesh_nodes")): edge_set(
          edges, add_batch_second_axis(st["g2m_edge_features"], batch,
                                       dtype))})


def mesh2grid_graph(st: dict, latent_mesh_nodes: torch.Tensor,
                    latent_grid_nodes: torch.Tensor) -> TypedGraph:
  """The mesh2grid TypedGraph (reference: graphcast.py:701-738)."""
  batch, dtype = latent_mesh_nodes.shape[1], latent_mesh_nodes.dtype
  edges = st["m2g"]
  return TypedGraph(
      context=Context(features=()),
      nodes={"grid_nodes": NodeSet(edges.num_receivers, latent_grid_nodes),
             "mesh_nodes": NodeSet(edges.num_senders, latent_mesh_nodes)},
      edges={EdgeSetKey("mesh2grid", ("mesh_nodes", "grid_nodes")): edge_set(
          edges, add_batch_second_axis(st["m2g_edge_features"], batch,
                                       dtype))})


def num_grid_input_channels(task_config: configs.TaskConfig,
                            step_hours: int = 6) -> int:
  """Stacked input + forcing channels per grid node, for steps of
  ``step_hours``: time-dependent inputs carry input_duration / step frames,
  statics one, forcings one target frame."""
  duration = task_config.input_duration
  if not duration.endswith("h") or int(duration[:-1]) % step_hours:
    raise ValueError(f"input_duration {duration!r} is not a multiple of "
                     f"{step_hours}h")
  frames = int(duration[:-1]) // step_hours
  nlev = len(task_config.pressure_levels)

  def width(name):
    return nlev if name in configs.ALL_ATMOSPHERIC_VARS else 1

  inputs = sum(width(n) * (1 if n in configs.STATIC_VARS else frames)
               for n in task_config.input_variables)
  return inputs + sum(width(n) for n in task_config.forcing_variables)


class GraphCast(Predictor):
  """The GraphCast one-step predictor (f32 master parameters)."""

  def __init__(self, model_config: configs.ModelConfig,
               task_config: configs.TaskConfig,
               cache_dir: Optional[str] = None,
               decode_chunks: int = 1,
               encode_chunks: int = 1,
               fused_aggregation: Optional[bool] = None,
               remat_processor: bool = False, *,
               generator: torch.Generator,
               device: torch.device | str = devices.DEFAULT_DEVICE):
    """Parameters are drawn on the CPU from ``generator`` (a CPU generator),
    then moved to ``device`` (the card unless the caller asks for "cpu");
    or loaded later with params.load_params. The keywords between are the
    JAX package's (module doc: the values of unported forms raise)."""
    refuse_unported_forms(
        "GraphCast", cache_dir, decode_chunks, encode_chunks,
        fused_aggregation,
        **{"processor remat (remat_processor=True)": remat_processor})
    device = devices.resolve(device)
    super().__init__()
    if model_config.hidden_layers != 1:
      raise NotImplementedError("only hidden_layers=1 is ported")
    self._mc = model_config
    self._tc = task_config
    self._pipelined: Optional[bool] = None
    self._artifact: Optional[artifact_lib.GridMeshArtifact] = None
    self._graph: dict = {}
    latent = model_config.latent_size
    node_in = num_grid_input_channels(task_config) + NODE_STRUCT_FEATURES
    self.num_outputs = configs.num_output_channels(task_config)
    common = dict(mlp_hidden_size=latent, mlp_num_hidden_layers=1)

    # Encoder (reference: graphcast.py:261-277).
    self.grid2mesh_gnn = DeepGraphNet(
        node_latent_size={"mesh_nodes": latent, "grid_nodes": latent},
        edge_latent_size={"grid2mesh": latent},
        node_input_size={"mesh_nodes": node_in, "grid_nodes": node_in},
        edge_input_size={"grid2mesh": EDGE_STRUCT_FEATURES},
        edge_sets={"grid2mesh": ("grid_nodes", "mesh_nodes")},
        num_message_passing_steps=1, f32_aggregation=True, **common)
    # Processor over the multi-mesh (reference: graphcast.py:280-293).
    self.mesh_gnn = DeepGraphNet(
        embed_nodes=False,
        node_latent_size={"mesh_nodes": latent},
        edge_latent_size={"mesh": latent},
        node_input_size={"mesh_nodes": latent},
        edge_input_size={"mesh": EDGE_STRUCT_FEATURES},
        edge_sets={"mesh": ("mesh_nodes", "mesh_nodes")},
        num_message_passing_steps=model_config.gnn_msg_steps, **common)
    # Decoder (reference: graphcast.py:304-321).
    self.mesh2grid_gnn = DeepGraphNet(
        node_output_size={"grid_nodes": self.num_outputs},
        embed_nodes=False,
        node_latent_size={"mesh_nodes": latent, "grid_nodes": latent},
        edge_latent_size={"mesh2grid": latent},
        node_input_size={"mesh_nodes": latent, "grid_nodes": latent},
        edge_input_size={"mesh2grid": EDGE_STRUCT_FEATURES},
        edge_sets={"mesh2grid": ("mesh_nodes", "grid_nodes")},
        num_message_passing_steps=1, **common)
    core.reset_parameters(self, generator)
    self.to(device)

  # ----- static graph -----

  def _maybe_init(self, inputs: FieldSet):
    if self._artifact is not None:
      return
    self._pipelined = env_flags.env_flag("GC_PIPELINED_EDGE")
    coords = inputs.coords
    self._artifact = artifact_lib.cached_artifact(
        grid_lat=coords["lat"],
        grid_lon=coords["lon"],
        mesh_size=self._mc.mesh_size,
        radius_query_fraction_edge_length=(
            self._mc.radius_query_fraction_edge_length),
        mesh2grid_edge_normalization_factor=(
            self._mc.mesh2grid_edge_normalization_factor),
        multimesh=True)

  def _statics(self, device: torch.device) -> dict:
    """Edge lists and structural features on ``device`` (built once per
    device, as normal tensors even under inference mode: a model that
    forecast first can still be trained)."""
    key = str(device)
    if key not in self._graph:
      with torch.inference_mode(False):
        art = self._artifact
        g, m = art.num_grid_nodes, art.num_mesh_nodes

        def edges(e, ns, nr):
          return EdgeIndex(e.senders, e.receivers, ns, nr, device=device)

        def tensor(a):
          return torch.as_tensor(np.ascontiguousarray(a), device=device)

        self._graph[key] = {
            "g2m": edges(art.grid2mesh, g, m),
            "mesh": edges(art.mesh, m, m),
            "m2g": edges(art.mesh2grid, m, g),
            "grid_node_features": tensor(art.grid_node_features),
            "mesh_node_features": tensor(art.mesh_node_features),
            "g2m_edge_features": tensor(art.grid2mesh.features),
            "mesh_edge_features": tensor(art.mesh.features),
            "m2g_edge_features": tensor(art.mesh2grid.features),
        }
    return self._graph[key]

  # ----- hoisted static edge latents -----

  def precompute_step_statics(self, inputs: FieldSet) -> dict:
    """The encoder's and decoder's static first-layer edge parts,
    embed(edge features) @ We + b0, once per rollout; {} at batch > 1,
    whose general path hoists nothing."""
    if inputs.sizes.get("batch", 1) != 1:
      return {}
    self._maybe_init(inputs)
    data = inputs[inputs.var_names[0]].data
    dtype = data.dtype if data.is_floating_point() else torch.float32
    st = self._statics(data.device)
    return {"static_edge_latents": {
        "g2m_const": self._static_edge_const(
            self.grid2mesh_gnn, "grid2mesh", st["g2m_edge_features"], dtype),
        "m2g_const": self._static_edge_const(
            self.mesh2grid_gnn, "mesh2grid", st["m2g_edge_features"], dtype),
    }}

  def _static_edge_const(self, gnn: DeepGraphNet, edge_name: str,
                         edge_features: torch.Tensor, dtype) -> torch.Tensor:
    """embed(edge_features) @ We + b0 → [E, latent], in row chunks to bound
    the embed MLP's temporaries (under grad: each chunk checkpointed)."""
    latent = self._mc.latent_size
    embed = gnn[f"encoder_edges_{edge_name}"]
    we, _, _, b0 = gnn[f"processor_0_edges_{edge_name}"].factored_first_layer(
        latent, latent, dtype)
    b0 = b0.to(dtype)

    def part(features):
      return embed(features.to(dtype)) @ we + b0

    num_edges = edge_features.shape[0]
    chunks = [edge_features[s:s + _CONST_CHUNK_ROWS]
              for s in range(0, num_edges, _CONST_CHUNK_ROWS)]
    if torch.is_grad_enabled():
      return torch.cat([checkpoint.checkpoint(part, c, use_reentrant=False)
                        for c in chunks])
    out = torch.empty(num_edges, latent, dtype=dtype,
                      device=edge_features.device)
    for i, c in enumerate(chunks):
      out[i * _CONST_CHUNK_ROWS:i * _CONST_CHUNK_ROWS + c.shape[0]] = part(c)
    return out

  # ----- the three GNN stages -----

  def _run_grid2mesh(self, st, grid_features, const):
    """Embeds grid/mesh nodes, aggregates the encoder edge MLP into the mesh
    nodes (K1, encoder mode), node updates + residuals."""
    gnn = self.grid2mesh_gnn
    latent = self._mc.latent_size
    dtype = grid_features.dtype
    num_mesh = self._artifact.num_mesh_nodes
    grid_in = torch.cat(
        [grid_features, st["grid_node_features"].to(dtype)], dim=-1)
    mesh_in = torch.cat(
        [grid_features.new_zeros(num_mesh, grid_features.shape[-1]),
         st["mesh_node_features"].to(dtype)], dim=-1)
    grid_emb = gnn["encoder_nodes_grid_nodes"](grid_in)
    mesh_emb = gnn["encoder_nodes_mesh_nodes"](mesh_in)
    pe = gnn["processor_0_edges_grid2mesh"]
    _, ws, wr, _ = pe.factored_first_layer(latent, latent, dtype)
    lin1 = pe.mlp["linear_1"]
    agg = fused_edge(st["g2m"], const, grid_emb @ ws, mesh_emb @ wr, None,
                     None, lin1.full_w, lin1.full_b, pe.layer_norm.scale,
                     pe.layer_norm.offset, write_edges=False,
                     pipelined=self._pipelined)
    mesh_upd = gnn["processor_0_nodes_mesh_nodes"](mesh_emb, agg.to(dtype))
    grid_upd = gnn["processor_0_nodes_grid_nodes"](grid_emb)
    return mesh_emb + mesh_upd, grid_emb + grid_upd

  def _run_mesh(self, st, latent_mesh_nodes):
    gnn = self.mesh_gnn
    dtype = latent_mesh_nodes.dtype
    e = gnn["encoder_edges_mesh"](st["mesh_edge_features"].to(dtype))
    x = latent_mesh_nodes
    for i in range(gnn.num_message_passing_steps):
      x, e = gnn.processor_step(i, "mesh", "mesh_nodes", st["mesh"], x, e,
                                pipelined=self._pipelined)
    return x

  def _run_mesh2grid(self, st, latent_mesh_nodes, latent_grid_nodes, const):
    """The whole decoder in one fused pass (K2)."""
    gnn = self.mesh2grid_gnn
    latent = self._mc.latent_size
    dtype = latent_mesh_nodes.dtype
    pe = gnn["processor_0_edges_mesh2grid"]
    pn = gnn["processor_0_nodes_grid_nodes"]
    pd = gnn["decoder_nodes_grid_nodes"]
    _, ws, wr, _ = pe.factored_first_layer(latent, latent, dtype)
    wn0 = pn.mlp["linear_0"].full_w
    weights = {
        "wr": wr,
        "w1": pe.mlp["linear_1"].full_w, "b1": pe.mlp["linear_1"].full_b,
        "escale": pe.layer_norm.scale, "eoffset": pe.layer_norm.offset,
        "wng": wn0[:latent], "wna": wn0[latent:],
        "bn0": pn.mlp["linear_0"].full_b,
        "wn1": pn.mlp["linear_1"].full_w, "bn1": pn.mlp["linear_1"].full_b,
        "nscale": pn.layer_norm.scale, "noffset": pn.layer_norm.offset,
        "wd0": pd.mlp["linear_0"].full_w, "bd0": pd.mlp["linear_0"].full_b,
        "wd1": pd.mlp["linear_1"].full_w, "bd1": pd.mlp["linear_1"].full_b,
    }
    return fused_decode(st["m2g"], latent_grid_nodes,
                        latent_mesh_nodes @ ws, const, weights)

  def _run_general(self, st, features):
    """Batch > 1: the three GNNs' general path on [nodes, batch, C]
    (graphcast_tpu models/graphcast.py:864-903); K3 aggregates the
    grid2mesh and mesh edge sets."""
    g2m = self.grid2mesh_gnn(
        grid2mesh_graph(st, features), edge_aggregators={
            "grid2mesh": functools.partial(sorted_segment_sum, st["g2m"])})
    mesh_nodes = g2m.nodes["mesh_nodes"]
    batch, dtype = features.shape[1], features.dtype
    mesh = self.mesh_gnn(
        TypedGraph(
            context=Context(features=()), nodes={"mesh_nodes": mesh_nodes},
            edges={EdgeSetKey("mesh", ("mesh_nodes", "mesh_nodes")): edge_set(
                st["mesh"], add_batch_second_axis(st["mesh_edge_features"],
                                                  batch, dtype))}),
        edge_aggregators={
            "mesh": functools.partial(sorted_segment_sum, st["mesh"])})
    m2g = self.mesh2grid_gnn(mesh2grid_graph(
        st, mesh.nodes["mesh_nodes"].features,
        g2m.nodes["grid_nodes"].features))
    return m2g.nodes["grid_nodes"].features

  # ----- feature packing -----

  def _inputs_to_grid_node_features(self, inputs: FieldSet,
                                    forcings: FieldSet) -> torch.Tensor:
    """FieldSets → [num_grid_nodes, batch, C] (reference:
    graphcast.py:739-758)."""
    stacked = torch.cat([to_stacked(inputs), to_stacked(forcings)], dim=-1)
    stacked = stacked.permute(1, 2, 0, 3)  # [lat, lon, batch, C]
    return stacked.reshape((-1,) + tuple(stacked.shape[2:]))

  def _grid_node_outputs_to_prediction(self, grid_node_outputs,
                                       targets_template: FieldSet):
    """[num_grid_nodes, batch, out] → FieldSet (reference:
    graphcast.py:760-783)."""
    art = self._artifact
    grid_shape = (art.grid_lat.shape[0], art.grid_lon.shape[0])
    data = grid_node_outputs.reshape(grid_shape
                                     + tuple(grid_node_outputs.shape[1:]))
    return from_stacked(data.permute(2, 0, 1, 3), targets_template)

  # ----- Predictor API -----

  def forward(self, inputs: FieldSet, targets_template: FieldSet,
              forcings: FieldSet, static_edge_latents=None) -> FieldSet:
    self._maybe_init(inputs)
    features = self._inputs_to_grid_node_features(inputs, forcings)
    expected = num_grid_input_channels(self._tc)
    if features.shape[-1] != expected:
      raise ValueError(f"stacked inputs have {features.shape[-1]} channels, "
                       f"the task config implies {expected}")
    st = self._statics(features.device)
    if features.shape[1] != 1:
      return self._grid_node_outputs_to_prediction(
          self._run_general(st, features), targets_template)
    x = features[:, 0]
    sel = static_edge_latents or self.precompute_step_statics(
        inputs)["static_edge_latents"]
    latent_mesh, latent_grid = self._run_grid2mesh(st, x, sel["g2m_const"])
    latent_mesh = self._run_mesh(st, latent_mesh)
    out = self._run_mesh2grid(st, latent_mesh, latent_grid,
                              sel["m2g_const"])
    return self._grid_node_outputs_to_prediction(out[:, None],
                                                 targets_template)

  def loss_and_predictions(self, inputs, targets, forcings, **kwargs):
    """(weighted MSE, {var: loss}) and the predictions (reference:
    graphcast_tpu/models/graphcast.py:908-916)."""
    predictions = self(inputs, targets, forcings, **kwargs)
    weights = {k: v for k, v in configs.GRAPHCAST_LOSS_WEIGHTS.items()
               if k in targets.var_names}
    loss = losses.weighted_mse_per_level(predictions, targets,
                                         per_variable_weights=weights)
    return loss, predictions

  def loss(self, inputs, targets, forcings, **kwargs):
    loss, _ = self.loss_and_predictions(inputs, targets, forcings, **kwargs)
    return loss
