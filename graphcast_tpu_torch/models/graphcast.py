"""GraphCast: the encode-process-decode GNN one-step predictor.

Port of graphcast_tpu/models/graphcast.py (reference: graphcast.py:213-796).
Each of the three stages runs in one of the JAX package's forms (its
dispatch, graphcast.py:842-903, and its setup, :152-253):

- grid2mesh encoder: at batch 1 and with the fused encoder, one
  aggregation-only fused edge step (K1, encoder mode) into the mesh nodes;
  else with ``encode_chunks`` > 1, in balanced node-aligned chunks
  (geometry/chunking.py), each chunk's edge MLP and LayerNorm a recompute
  region and its f32 sum into its own node range a sorted segment sum (K3),
  the whole encoder a recompute region under grad; else the general path.
- mesh processor: at batch 1 and with the fused processor,
  ``gnn_msg_steps`` fused edge steps (K1, processor mode); else the
  general path. ``remat_processor`` checkpoints its steps in √N blocks
  (nn/deep_gnn.py ``run_steps``).
- mesh2grid decoder: at batch 1 and with the fused decoder, the whole
  decoder in one pass (K2); else with ``decode_chunks`` > 1, in chunks of
  grid nodes, each a recompute region whose 3 edges per node are summed by
  a reshape-sum (a fixed order); else the general path.

The general path is the three DeepGraphNets' ``forward`` on TypedGraphs
laid out [nodes, batch, C], with every aggregation through K3
(ops/segment_sum.py: f32 sums, one rounding to the messages' dtype), where
the JAX package installs ``BlockedSegmentSum`` for grid2mesh and the mesh
and sums mesh2grid plainly, and every node-row gather through the edge
sets' ``RowGather`` pairs (ops/gather.py), whose backward sums by K3: all
of its sums run in a fixed order, so a rerun is bit-equal, as the fused
and chunked forms' are.

``fused_aggregation`` picks the fused stages: None and True all three (the
JAX package's None means "on a TPU"; the port's kernels run on the card and
their twins on the CPU), "encoder" the processor and the encoder,
"processor" the processor alone, False none. ``encode_chunks`` applies
only where there is no fused encoder, ``decode_chunks`` where there is no
fused decoder or the batch is > 1, as in the JAX package.

Which code runs is decided by the tensors' device alone: CUDA tensors go
through the CUDA kernels, CPU tensors through their plain-PyTorch twins
(ops/). ``hidden_layers`` (the MLPs' hidden layers, as in the JAX
package's ``ModelConfig``) other than 1 turns the fused stages off, as the
JAX package's setup does (graphcast.py:184,236 and its processor's
``_fused_step_target``): the kernels compute one hidden layer. At batch 1
such a model then runs the chunked stages where their chunks are > 1 and
the general path elsewhere, with every sum in a fixed order.
``GC_PIPELINED_EDGE`` (env_flags.py), read once at the first call, as the
JAX package builds its ``FusedEdgeStep``s then, runs the encoder's and the
processor's edge steps through K1p instead of K1. ``cache_dir`` is the
geometry artifact's disk cache (geometry/artifact.py).

The static graph (geometry/artifact.py) is built on the host at the first
call from the inputs' lat/lon coords and kept on the device of the call.
The encoder/decoder edge features are structural, so their edge-embed MLP
output times the first layer's edge block (+ bias) is constant across a
rollout: ``precompute_step_statics`` computes it once, for the stages that
take it (the fused and the chunked ones).

Training (``loss``, ``loss_and_predictions``): the weighted MSE of
losses.py with ``configs.GRAPHCAST_LOSS_WEIGHTS``. Under grad the fused
stages' static edge parts are functions of the parameters, so they are
computed inside each step, in max(chunks, 8) row chunks, each a recompute
region: the edge-embed MLP's intermediates over the 1.6M and 3.1M edges at
0.25° are recomputed in the backward instead of kept. The chunked stages
embed each chunk's edges inside its own region. CUDA tensors run the
backward kernels K4/K5.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch

from graphcast_tpu_torch import devices, env_flags, losses
from graphcast_tpu_torch.fields import FieldSet, from_stacked, to_stacked
from graphcast_tpu_torch.geometry import artifact as artifact_lib
from graphcast_tpu_torch.geometry import chunking
from graphcast_tpu_torch.models import configs
from graphcast_tpu_torch.models.base import Predictor
from graphcast_tpu_torch.nn import core, remat
from graphcast_tpu_torch.nn.deep_gnn import DeepGraphNet
from graphcast_tpu_torch.nn.typed_graph import (
    Context, EdgeSet, EdgeSetKey, EdgesIndices, NodeSet, TypedGraph)
from graphcast_tpu_torch.ops.fused_decoder import fused_decode
from graphcast_tpu_torch.ops.fused_edge import EdgeIndex, fused_edge
from graphcast_tpu_torch.ops.gather import RowGather, edge_gathers
from graphcast_tpu_torch.ops.segment_sum import sorted_segment_sum

NODE_STRUCT_FEATURES = 3   # sin(lat), cos(lon), sin(lon)
EDGE_STRUCT_FEATURES = 4   # |d|, dx, dy, dz in the receiver's frame
FUSED_FORMS = (None, True, False, "processor", "encoder")


def add_batch_second_axis(data: torch.Tensor, batch: int, dtype):
  """[n, f] → [n, batch, f] in ``dtype`` (reference: graphcast.py:785-789)."""
  return data.to(dtype)[:, None].expand(data.shape[0], batch, data.shape[-1])


def edge_set(st: dict, name: str, features: torch.Tensor) -> EdgeSet:
  """A TypedGraph edge set over the sender and receiver indices of the
  edge list ``st[name]``, with their gathers (ops/gather.py: fixed-order
  backward sums), built at the first call and kept in ``st``."""
  edges = st[name]
  key = f"{name}_gathers"
  if key not in st:
    st[key] = edge_gathers(edges)
  return EdgeSet(EdgesIndices(edges.senders, edges.receivers, st[key]),
                 features)


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
          st, "g2m", add_batch_second_axis(st["g2m_edge_features"], batch,
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
          st, "m2g", add_batch_second_axis(st["m2g_edge_features"], batch,
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


def fused_stages(fused_aggregation, hidden_layers: int = 1
                 ) -> tuple[bool, bool, bool]:
  """(processor, encoder, decoder): which stages run fused at batch 1 for
  a ``fused_aggregation`` value and the MLPs' ``hidden_layers`` (module
  doc): none unless ``hidden_layers`` is 1."""
  if fused_aggregation not in FUSED_FORMS:
    raise ValueError(f"fused_aggregation must be one of {FUSED_FORMS}, got "
                     f"{fused_aggregation!r}")
  processor = fused_aggregation is not False and hidden_layers == 1
  encoder = processor and fused_aggregation != "processor"
  return processor, encoder, encoder and fused_aggregation != "encoder"


def choose_chunks(total: int, requested: int) -> int:
  """Largest divisor of ``total`` that is ≤ requested (≥ 1)."""
  k = max(1, min(requested, total))
  while total % k:
    k -= 1
  return k


class NodeChunk:
  """One chunk of a node-chunk plan on a device: its contiguous edge range
  e0:e1, its node range n0:n1, and the gathers of its senders (rows of all
  senders) and its receivers (local to n0:n1), whose backward sums in a
  fixed order (ops/gather.py). ``receivers.edges`` is the chunk's edge list
  into its nodes, on which K3 keeps its plan."""

  def __init__(self, plan: chunking.NodeChunkPlan, i: int,
               edges: artifact_lib.EdgeArrays, num_senders: int, device):
    self.e0, self.e1 = (int(b) for b in plan.edge_bounds[i:i + 2])
    self.n0, self.n1 = (int(b) for b in plan.node_bounds[i:i + 2])
    self.senders = RowGather(edges.senders[self.e0:self.e1], num_senders,
                             device)
    self.receivers = RowGather(edges.receivers[self.e0:self.e1] - self.n0,
                               self.n1 - self.n0, device)


def node_chunks(plan: chunking.NodeChunkPlan, edges: artifact_lib.EdgeArrays,
                num_senders: int, device) -> list[NodeChunk]:
  return [NodeChunk(plan, i, edges, num_senders, device)
          for i in range(plan.num_chunks)]


def chunk_aggregate(chunk: NodeChunk, messages: torch.Tensor) -> torch.Tensor:
  """The f32 sum of a chunk's [e, B, C] messages into its nodes (K3)."""
  if chunk.e1 == chunk.e0:
    return messages.new_zeros((chunk.n1 - chunk.n0,) + tuple(
        messages.shape[1:]), dtype=torch.float32)
  return sorted_segment_sum(chunk.receivers.edges,
                            messages.float().contiguous())


def decode_chunk_senders(edges: artifact_lib.EdgeArrays, num_senders: int,
                         num_chunks: int, device) -> list[RowGather]:
  """The sender gathers of ``num_chunks`` equal chunks of a mesh2grid edge
  list (3 edges per grid node)."""
  per = edges.senders.size // num_chunks
  return [RowGather(edges.senders[i * per:(i + 1) * per], num_senders,
                    device) for i in range(num_chunks)]


def three_per_node(x: torch.Tensor) -> torch.Tensor:
  """[n, ...] node rows → [3n, ...], each row three times: the receiver
  rows of a 3-edges-per-node edge list (its backward sums the three)."""
  return x[:, None].expand(x.shape[0], 3, *x.shape[1:]).reshape(
      3 * x.shape[0], *x.shape[1:])


def edge_mlp_tail(pe: core.MLPWithNorm, x: torch.Tensor, cond=None):
  """The layers of an edge MLP after its first (each behind the MLP's
  activation), then its norm."""
  return pe._norm(pe.mlp.tail(x), cond)


def embed_nodes(gnn: DeepGraphNet, st: dict, features: torch.Tensor,
                cond=None):
  """(grid_emb, mesh_emb): the grid2mesh encoder's node embeddings of
  [G, B, C] features ++ structural (grid) and zeros ++ structural (mesh);
  ``cond`` [1, B, K] where the MLPs are norm-conditioned."""
  batch, dtype = features.shape[1], features.dtype
  num_mesh = st["g2m"].num_receivers
  grid_in = torch.cat([features, add_batch_second_axis(
      st["grid_node_features"], batch, dtype)], dim=-1)
  mesh_in = torch.cat([features.new_zeros((num_mesh,) + tuple(
      features.shape[1:])), add_batch_second_axis(
          st["mesh_node_features"], batch, dtype)], dim=-1)
  return (gnn["encoder_nodes_grid_nodes"](grid_in, cond=cond),
          gnn["encoder_nodes_mesh_nodes"](mesh_in, cond=cond))


def embed_edges(embed: core.MLPWithNorm, features: torch.Tensor, cond,
                dtype) -> torch.Tensor:
  """Raw [E, F] edge features → [E, 1, L] embeddings, or [E, B, L] with
  the conditioning ``cond`` [1, B, K]: the MLP and its parameter-free
  LayerNorm run once per edge, the conditioning per member."""
  if cond is None:
    return embed(features.to(dtype))[:, None]
  h = core.layer_norm_no_params(embed.mlp(features.to(dtype)))
  return embed.norm_conditioning(h[:, None], cond)


def grid2mesh_chunked(gnn: DeepGraphNet, st: dict, features: torch.Tensor,
                      cond=None, const=None, normalization=None):
  """The grid2mesh encoder in balanced node chunks (graphcast_tpu
  models/graphcast.py:449-558, denoiser.py:411-488): the edge latents feed
  only the one aggregation into the mesh nodes, so each chunk embeds,
  updates and sums its edges into its own node range (K3, f32), a
  recompute region, and is freed. Node embeddings and projections are
  computed once, outside the chunks. [G, B, C] features → ([M, B, L],
  [G, B, L]); ``cond`` [B, K] norm conditioning; ``const`` [E, L] the
  hoisted static first-layer part; ``normalization`` divides the sums."""
  gnc = None if cond is None else cond[None]
  dtype = features.dtype
  grid_emb, mesh_emb = embed_nodes(gnn, st, features, gnc)
  latent = grid_emb.shape[-1]
  pe = gnn["processor_0_edges_grid2mesh"]
  we, ws, wr, b0 = pe.factored_first_layer(latent, latent, dtype)
  embed = gnn["encoder_edges_grid2mesh"]

  def encode_chunk(chunk, grid_proj, mesh_proj, gnc, lead):
    gathered = (chunk.senders(grid_proj)
                + chunk.receivers(mesh_proj[chunk.n0:chunk.n1]))
    if const is not None:
      x = lead[:, None] + gathered
    else:
      x = embed_edges(embed, lead, gnc, dtype) @ we + gathered + b0.to(dtype)
    return chunk_aggregate(chunk, edge_mlp_tail(pe, x, gnc))

  grid_proj, mesh_proj = grid_emb @ ws, mesh_emb @ wr
  lead_all = const if const is not None else st["g2m_edge_features"]
  agg = torch.cat([
      remat.checkpoint(functools.partial(encode_chunk, c), grid_proj,
                       mesh_proj, gnc, lead_all[c.e0:c.e1])
      for c in st["g2m_chunks"]])
  if normalization:
    agg = agg / normalization
  agg = agg.to(dtype)
  mesh_upd = gnn["processor_0_nodes_mesh_nodes"](mesh_emb, agg, cond=gnc)
  grid_upd = gnn["processor_0_nodes_grid_nodes"](grid_emb, cond=gnc)
  return mesh_emb + mesh_upd, grid_emb + grid_upd


def mesh2grid_chunked(gnn: DeepGraphNet, st: dict, latent_mesh: torch.Tensor,
                      latent_grid: torch.Tensor, cond=None, const=None):
  """The mesh2grid decoder in ``len(st["m2g_chunks"])`` chunks of grid
  nodes (graphcast_tpu models/graphcast.py:573-664, denoiser.py:490-552):
  each grid node has exactly 3 receiver-sorted edges, so a chunk of gc
  nodes owns edges 3·gc·i:3·gc·(i+1) and its aggregation is a reshape-sum
  in a fixed order. The mesh projection is computed once; each chunk
  slices the grid latents (no copy) and is a recompute region. [M, B, L],
  [G, B, L] → [G, B, outputs]; ``cond`` and ``const`` as in
  ``grid2mesh_chunked``."""
  gnc = None if cond is None else cond[None]
  dtype = latent_mesh.dtype
  batch, latent = latent_mesh.shape[1:]
  senders = st["m2g_chunks"]
  gc = latent_grid.shape[0] // len(senders)
  pe = gnn["processor_0_edges_mesh2grid"]
  pn = gnn["processor_0_nodes_grid_nodes"]
  pd = gnn["decoder_nodes_grid_nodes"]
  embed = gnn["encoder_edges_mesh2grid"]
  we, ws, wr, b0 = pe.factored_first_layer(latent, latent, dtype)

  def decode_chunk(i, mesh_proj, latent_grid, gnc, lead):
    grid_chunk = latent_grid[i * gc:(i + 1) * gc]
    gathered = senders[i](mesh_proj) + three_per_node(grid_chunk @ wr)
    if const is not None:
      x = lead[:, None] + gathered
    else:
      x = embed_edges(embed, lead, gnc, dtype) @ we + gathered + b0.to(dtype)
    e_upd = edge_mlp_tail(pe, x, gnc)
    agg = e_upd.reshape(gc, 3, batch, latent).sum(1)
    return pd(grid_chunk + pn(grid_chunk, agg, cond=gnc))

  mesh_proj = latent_mesh @ ws
  lead_all = const if const is not None else st["m2g_edge_features"]
  return torch.cat([
      remat.checkpoint(functools.partial(decode_chunk, i), mesh_proj,
                       latent_grid, gnc, lead_all[3 * gc * i:3 * gc * (i + 1)])
      for i in range(len(senders))])


class GraphCast(Predictor):
  """The GraphCast one-step predictor (f32 master parameters)."""

  def __init__(self, model_config: configs.ModelConfig,
               task_config: configs.TaskConfig,
               cache_dir: Optional[str] = None,
               decode_chunks: int = 1,
               encode_chunks: int = 1,
               fused_aggregation: Union[bool, str, None] = None,
               remat_processor: bool = False, *,
               generator: torch.Generator,
               device: torch.device | str = devices.DEFAULT_DEVICE):
    """Parameters are drawn on the CPU from ``generator`` (a CPU generator),
    then moved to ``device`` (the card unless the caller asks for "cpu");
    or loaded later with params.load_params. The keywords between are the
    JAX package's (module doc)."""
    device = devices.resolve(device)
    super().__init__()
    self._mc = model_config
    self._tc = task_config
    self._cache_dir = cache_dir
    self._decode_chunks = decode_chunks
    self._encode_chunks = encode_chunks
    (self._fused_processor, self._fused_encoder,
     self._fused_decoder) = fused_stages(fused_aggregation,
                                         model_config.hidden_layers)
    self._pipelined: Optional[bool] = None
    self._artifact: Optional[artifact_lib.GridMeshArtifact] = None
    self._g2m_plan: Optional[chunking.NodeChunkPlan] = None
    self._graph: dict = {}
    latent = model_config.latent_size
    node_in = num_grid_input_channels(task_config) + NODE_STRUCT_FEATURES
    self.num_outputs = configs.num_output_channels(task_config)
    common = dict(mlp_hidden_size=latent,
                  mlp_num_hidden_layers=model_config.hidden_layers)

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
        num_message_passing_steps=model_config.gnn_msg_steps,
        remat_steps=remat_processor, **common)
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
        multimesh=True,
        cache_dir=self._cache_dir)
    if self._encode_chunks > 1 and not self._fused_encoder:
      self._g2m_plan = chunking.plan_balanced_node_chunks(
          self._artifact.grid2mesh.receivers, self._artifact.num_mesh_nodes,
          self._encode_chunks)

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
        if self._g2m_plan is not None:
          self._graph[key]["g2m_chunks"] = node_chunks(
              self._g2m_plan, art.grid2mesh, g, device)
        if self._decode_chunks > 1:
          self._graph[key]["m2g_chunks"] = decode_chunk_senders(
              art.mesh2grid, m, self._decode_chunk_count(), device)
    return self._graph[key]

  def _decode_chunk_count(self) -> int:
    return choose_chunks(self._artifact.num_grid_nodes, self._decode_chunks)

  # ----- hoisted static edge latents -----

  def precompute_step_statics(self, inputs: FieldSet) -> dict:
    """The static first-layer edge parts, embed(edge features) @ We + b0,
    once per rollout, for the stages that take them (graphcast_tpu
    models/graphcast.py:393-438): the fused encoder and decoder at batch 1,
    the chunked ones at any batch; {} where no stage takes one."""
    self._maybe_init(inputs)
    batch = inputs.sizes.get("batch", 1)
    fused_encode = self._fused_encoder and batch == 1
    fused_decode = self._fused_decoder and batch == 1
    if (self._encode_chunks <= 1 and self._decode_chunks <= 1
        and not fused_decode and not fused_encode):
      return {}
    data = inputs[inputs.var_names[0]].data
    dtype = data.dtype if data.is_floating_point() else torch.float32
    st = self._statics(data.device)
    out = {}
    if fused_encode:
      out["g2m_const"] = self._static_edge_const(
          self.grid2mesh_gnn, "grid2mesh", st["g2m_edge_features"], dtype,
          max(self._encode_chunks, 8))
    elif self._g2m_plan is not None:
      out["g2m_const"] = self._static_edge_const(
          self.grid2mesh_gnn, "grid2mesh", st["g2m_edge_features"], dtype,
          self._g2m_plan.num_chunks)
    if fused_decode or self._decode_chunks > 1:
      out["m2g_const"] = self._static_edge_const(
          self.mesh2grid_gnn, "mesh2grid", st["m2g_edge_features"], dtype,
          max(self._decode_chunks, 8) if fused_decode
          else self._decode_chunk_count())
    return {"static_edge_latents": out} if out else {}

  def _static_edge_const(self, gnn: DeepGraphNet, edge_name: str,
                         edge_features: torch.Tensor, dtype,
                         num_chunks: int) -> torch.Tensor:
    """embed(edge_features) @ We + b0 → [E, latent], in ``num_chunks`` row
    chunks to bound the embed MLP's temporaries (under grad: each chunk a
    recompute region)."""
    latent = self._mc.latent_size
    embed = gnn[f"encoder_edges_{edge_name}"]
    we, _, _, b0 = gnn[f"processor_0_edges_{edge_name}"].factored_first_layer(
        latent, latent, dtype)
    b0 = b0.to(dtype)

    def part(features):
      return embed(features.to(dtype)) @ we + b0

    num_edges = edge_features.shape[0]
    rows = max(1, -(-num_edges // max(1, num_chunks)))
    chunks = [edge_features[s:s + rows] for s in range(0, num_edges, rows)]
    if torch.is_grad_enabled():
      return torch.cat([remat.checkpoint(part, c) for c in chunks])
    out = torch.empty(num_edges, latent, dtype=dtype,
                      device=edge_features.device)
    for i, c in enumerate(chunks):
      out[i * rows:i * rows + c.shape[0]] = part(c)
    return out

  # ----- grid2mesh encoder -----

  def _run_grid2mesh(self, st, grid_features, const):
    """Batch 1, fused: embeds grid/mesh nodes, aggregates the encoder edge
    MLP into the mesh nodes (K1, encoder mode), node updates + residuals.
    [G, C] → ([M, C], [G, C])."""
    gnn = self.grid2mesh_gnn
    latent = self._mc.latent_size
    dtype = grid_features.dtype
    grid_emb, mesh_emb = (t[:, 0] for t in embed_nodes(
        gnn, st, grid_features[:, None]))
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

  def _run_grid2mesh_general(self, st, features):
    g2m = self.grid2mesh_gnn(
        grid2mesh_graph(st, features), edge_aggregators={
            "grid2mesh": functools.partial(sorted_segment_sum, st["g2m"])})
    return (g2m.nodes["mesh_nodes"].features,
            g2m.nodes["grid_nodes"].features)

  # ----- mesh processor -----

  def _run_mesh(self, st, latent_mesh_nodes):
    """Batch 1, fused: [M, C] → [M, C] (K1, processor mode)."""
    gnn = self.mesh_gnn
    dtype = latent_mesh_nodes.dtype
    e = gnn["encoder_edges_mesh"](st["mesh_edge_features"].to(dtype))

    def step(i, x, e):
      return gnn.processor_step(i, "mesh", "mesh_nodes", st["mesh"], x, e,
                                pipelined=self._pipelined)

    x, _ = gnn.run_steps(step, (latent_mesh_nodes, e))
    return x

  def _run_mesh_general(self, st, mesh_nodes):
    batch, dtype = mesh_nodes.shape[1], mesh_nodes.dtype
    mesh = self.mesh_gnn(
        TypedGraph(
            context=Context(features=()), nodes={"mesh_nodes": NodeSet(
                st["mesh"].num_receivers, mesh_nodes)},
            edges={EdgeSetKey("mesh", ("mesh_nodes", "mesh_nodes")): edge_set(
                st, "mesh", add_batch_second_axis(st["mesh_edge_features"],
                                                  batch, dtype))}),
        edge_aggregators={
            "mesh": functools.partial(sorted_segment_sum, st["mesh"])})
    return mesh.nodes["mesh_nodes"].features

  # ----- mesh2grid decoder -----

  def _run_mesh2grid(self, st, latent_mesh_nodes, latent_grid_nodes, const):
    """Batch 1, fused: the whole decoder in one pass (K2)."""
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

  def _run_mesh2grid_general(self, st, latent_mesh_nodes, latent_grid_nodes):
    m2g = self.mesh2grid_gnn(
        mesh2grid_graph(st, latent_mesh_nodes, latent_grid_nodes),
        edge_aggregators={
            "mesh2grid": functools.partial(sorted_segment_sum, st["m2g"])})
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
    batch1 = features.shape[1] == 1
    sel = static_edge_latents or {}
    dtype = features.dtype

    # Encode (grid2mesh).
    if self._fused_encoder and batch1:
      const = sel.get("g2m_const")
      if const is None:
        const = self._static_edge_const(
            self.grid2mesh_gnn, "grid2mesh", st["g2m_edge_features"], dtype,
            max(self._encode_chunks, 8))
      mesh, grid = (t[:, None] for t in self._run_grid2mesh(
          st, features[:, 0], const))
    elif self._g2m_plan is not None:
      # Under grad, one recompute region around the whole encoder: its
      # grid-sized internals are dropped while the processor and decoder
      # run their backward (graphcast_tpu models/graphcast.py:852-860).
      encode = functools.partial(grid2mesh_chunked, self.grid2mesh_gnn, st,
                                 const=sel.get("g2m_const"))
      mesh, grid = (remat.checkpoint(encode, features)
                    if torch.is_grad_enabled() else encode(features))
    else:
      mesh, grid = self._run_grid2mesh_general(st, features)

    # Process (multi-mesh).
    if self._fused_processor and batch1:
      mesh = self._run_mesh(st, mesh[:, 0])[:, None]
    else:
      mesh = self._run_mesh_general(st, mesh)

    # Decode (mesh2grid).
    if self._fused_decoder and batch1:
      const = sel.get("m2g_const")
      if const is None:
        const = self._static_edge_const(
            self.mesh2grid_gnn, "mesh2grid", st["m2g_edge_features"], dtype,
            max(self._decode_chunks, 8))
      out = self._run_mesh2grid(st, mesh[:, 0], grid[:, 0], const)[:, None]
    elif self._decode_chunks > 1:
      out = mesh2grid_chunked(self.mesh2grid_gnn, st, mesh, grid,
                              const=sel.get("m2g_const"))
    else:
      out = self._run_mesh2grid_general(st, mesh, grid)
    return self._grid_node_outputs_to_prediction(out, targets_template)

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
