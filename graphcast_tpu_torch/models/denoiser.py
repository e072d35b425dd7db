"""GenCast's denoiser (port of graphcast_tpu/models/denoiser.py;
reference: graphcast/denoiser.py).

A GraphCast-shaped encode-process-decode network specialised for
denoising diffusion:

- every LayerNorm is parameter-free and followed by a norm conditioning on
  an encoding of the noise level (``FourierFeaturesMLP``);
- the processor is a sparse transformer over the finest mesh, whose nodes
  are in banded patch order (geometry/artifact.py) so the k-hop attention
  mask is block-compact;
- noisy targets enter as extra forcings; the noise-level encoding enters
  as a [batch, channels] input, split out as the conditioning vector.

At batch 1, the JAX package's fused paths (``_nc_vectors``,
``_run_grid2mesh_fused``, ``_run_mesh2grid_fused``): the conditioning is
folded into per-evaluation vectors and matrices, We' = s_e·We and
b0' = o_e·We + b0 in the activation dtype, and the grid2mesh and mesh2grid
stages run through K1 and K2 in embed mode on the raw structural edge
features (ops/fused_edge.py, ops/fused_decoder.py). At batch > 1 (an
ensemble's members), its general path: the DeepGraphNets' ``forward`` with
the per-member conditioning [batch, K], both aggregations through K3
(ops/segment_sum.py; the JAX package sums mesh2grid plainly) and the
gathers through ``RowGather`` pairs (ops/gather.py), all in a fixed order,
as GraphCast's general path; the transformer folds batch and heads for K6.
The TPU's windowed grid2mesh gather and its ``node_order`` layout are
Mosaic-specific; the port keeps the artifact's receiver order.

``fused_aggregation=False`` runs the general path at batch 1 too (the JAX
package's None means "on a TPU"; the port's None and any other value run
the fused stages at batch 1), and so does ``hidden_layers`` other than 1
(the kernels compute one hidden layer; graphcast_tpu models/
denoiser.py:208). ``encode_chunks`` / ``decode_chunks`` > 1
run the encoder / decoder in chunks, as GraphCast's chunked stages do
(models/graphcast.py; JAX denoiser.py:411-552, dispatch :700-745), with the
norm conditioning applied inside each chunk: the encoder where it is not
fused, the decoder where it is not fused or the batch is > 1. The edge
embedding MLP runs once per edge and its conditioning per member.
``cache_dir`` is the geometry artifact's disk cache. ``GC_PIPELINED_EDGE``
(env_flags.py), read once at the first call, as the JAX package builds its
grid2mesh ``FusedEdgeStep`` then, runs the embed-mode grid2mesh step through
K1p instead of K1.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from graphcast_tpu_torch import env_flags
from graphcast_tpu_torch.fields import Field, FieldSet, from_stacked, to_stacked
from graphcast_tpu_torch.geometry import artifact as artifact_lib
from graphcast_tpu_torch.geometry import chunking
from graphcast_tpu_torch.models import configs
from graphcast_tpu_torch.models.graphcast import (
    EDGE_STRUCT_FEATURES, NODE_STRUCT_FEATURES, choose_chunks,
    decode_chunk_senders, fused_stages, grid2mesh_chunked, grid2mesh_graph,
    mesh2grid_chunked, mesh2grid_graph, node_chunks, num_grid_input_channels)
from graphcast_tpu_torch.models.sparse_transformer import (
    SparseTransformerConfig)
from graphcast_tpu_torch.models.transformer import MeshTransformer
from graphcast_tpu_torch.nn import core
from graphcast_tpu_torch.nn.deep_gnn import DeepGraphNet
from graphcast_tpu_torch.ops.fused_decoder import fused_decode
from graphcast_tpu_torch.ops.fused_edge import EdgeIndex, fused_edge
from graphcast_tpu_torch.ops.segment_sum import sorted_segment_sum

# GenCast steps 12 hours: its inputs hold input_duration / 12h frames.
STEP_HOURS = 12
COND_NAME = "noise_level_encodings"


def fourier_features(values: torch.Tensor, base_period: float,
                     num_frequencies: int) -> torch.Tensor:
  """cos/sin features at integer multiples of 1/base_period, in values'
  dtype (reference: model_utils.py:728-757)."""
  freqs = np.arange(1, num_frequencies + 1) / base_period
  angular = torch.as_tensor(2 * np.pi * freqs, device=values.device).to(
      values.dtype)
  phases = values[..., None] * angular
  return torch.cat([torch.cos(phases), torch.sin(phases)], dim=-1)


@dataclasses.dataclass(frozen=True, eq=True)
class NoiseEncoderConfig:
  """Noise-level encoding config (reference: denoiser.py:100-123)."""
  apply_log_first: bool = True
  base_period: float = 16.0
  num_frequencies: int = 32
  output_sizes: tuple[int, ...] = (32, 16)


@dataclasses.dataclass(frozen=True, eq=True)
class DenoiserArchitectureConfig:
  """Reference: denoiser.py:155-196."""
  sparse_transformer_config: SparseTransformerConfig
  mesh_size: int
  latent_size: int = 512
  hidden_layers: int = 1
  radius_query_fraction_edge_length: float = 0.6
  norm_conditioning_features: tuple[str, ...] = (COND_NAME,)
  grid2mesh_aggregate_normalization: Optional[float] = None
  node_output_size: Optional[int] = None


class _UniformLinear(core.Linear):
  """Linear with Haiku's VarianceScaling(2.0, "uniform") init."""

  @torch.no_grad()
  def reset_parameters(self, generator: torch.Generator):
    limit = math.sqrt(3.0 * 2.0 / self.in_size)
    self.w.uniform_(-limit, limit, generator=generator)
    self.b.zero_()


class FourierFeaturesMLP(nn.ModuleDict):
  """GELU MLP over (log-)Fourier features of the noise level (reference:
  denoiser.py:41-97); layers linear_0, linear_1, …"""

  def __init__(self, cfg: NoiseEncoderConfig):
    sizes = [2 * cfg.num_frequencies] + list(cfg.output_sizes)
    super().__init__({f"linear_{i}": _UniformLinear(a, b)
                      for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))})
    self.cfg = cfg

  @property
  def output_size(self) -> int:
    return self.cfg.output_sizes[-1]

  def forward(self, values: torch.Tensor) -> torch.Tensor:
    cfg = self.cfg
    if cfg.apply_log_first:
      values = torch.log(values)
    x = fourier_features(values, cfg.base_period, cfg.num_frequencies)
    layers = list(self.values())
    for i, layer in enumerate(layers):
      x = layer(x)
      if i + 1 < len(layers):
        x = core.gelu(x)
    return x


class DenoiserArchitecture(nn.Module):
  """Encode (GNN) → process (sparse transformer) → decode (GNN)
  (reference: denoiser.py:248-731)."""

  def __init__(self, cfg: DenoiserArchitectureConfig,
               task_config: configs.TaskConfig, cond_size: int,
               cache_dir: Optional[str] = None, decode_chunks: int = 1,
               encode_chunks: int = 1, fused_aggregation=None):
    super().__init__()
    if cfg.node_output_size is None:
      raise ValueError("node_output_size must be set (by GenCast)")
    if cfg.sparse_transformer_config.node_ordering not in ("rcm", "patch"):
      raise ValueError("unknown node_ordering "
                       f"{cfg.sparse_transformer_config.node_ordering!r}")
    self._cfg = cfg
    self._cache_dir = cache_dir
    self._decode_chunks = decode_chunks
    self._encode_chunks = encode_chunks
    self._fused = fused_stages(fused_aggregation, cfg.hidden_layers)[0]
    self._pipelined: Optional[bool] = None
    self._artifact: Optional[artifact_lib.GridMeshArtifact] = None
    self._g2m_plan: Optional[chunking.NodeChunkPlan] = None
    self._graph: dict = {}
    latent = cfg.latent_size
    # Stacked inputs (noise encodings split out) + forcings + noisy targets.
    node_in = (num_grid_input_channels(task_config, STEP_HOURS)
               + cfg.node_output_size + NODE_STRUCT_FEATURES)
    common = dict(mlp_hidden_size=latent,
                  mlp_num_hidden_layers=cfg.hidden_layers,
                  num_message_passing_steps=1,
                  norm_conditioning_size=cond_size)
    self.grid2mesh_gnn = DeepGraphNet(
        node_latent_size={"mesh_nodes": latent, "grid_nodes": latent},
        edge_latent_size={"grid2mesh": latent},
        node_input_size={"mesh_nodes": node_in, "grid_nodes": node_in},
        edge_input_size={"grid2mesh": EDGE_STRUCT_FEATURES},
        edge_sets={"grid2mesh": ("grid_nodes", "mesh_nodes")},
        f32_aggregation=True,
        aggregate_normalization=cfg.grid2mesh_aggregate_normalization,
        **common)
    self.mesh_transformer = MeshTransformer(cfg.sparse_transformer_config,
                                            cond_size)
    self.mesh2grid_gnn = DeepGraphNet(
        node_output_size={"grid_nodes": cfg.node_output_size},
        embed_nodes=False,
        node_latent_size={"mesh_nodes": latent, "grid_nodes": latent},
        edge_latent_size={"mesh2grid": latent},
        node_input_size={"mesh_nodes": latent, "grid_nodes": latent},
        edge_input_size={"mesh2grid": EDGE_STRUCT_FEATURES},
        edge_sets={"mesh2grid": ("mesh_nodes", "grid_nodes")}, **common)

  # ----- static graph -----

  def _maybe_init(self, inputs: FieldSet):
    if self._artifact is not None:
      return
    self._pipelined = env_flags.env_flag("GC_PIPELINED_EDGE")
    coords = inputs.coords
    st_cfg = self._cfg.sparse_transformer_config
    self._artifact = artifact_lib.cached_artifact(
        grid_lat=coords["lat"], grid_lon=coords["lon"],
        mesh_size=self._cfg.mesh_size,
        radius_query_fraction_edge_length=(
            self._cfg.radius_query_fraction_edge_length),
        multimesh=False, permute_banded=True,
        banded_patch_size=(st_cfg.block_q
                           if st_cfg.node_ordering == "patch" else None),
        cache_dir=self._cache_dir)
    art = self._artifact
    if self._encode_chunks > 1 and not self._fused:
      self._g2m_plan = chunking.plan_balanced_node_chunks(
          art.grid2mesh.receivers, art.num_mesh_nodes, self._encode_chunks)
    self.mesh_transformer.prepare(art.mesh.senders, art.mesh.receivers,
                                  art.num_mesh_nodes)

  def _statics(self, device: torch.device) -> dict:
    """Edge lists and raw structural features on ``device`` (built once per
    device, as normal tensors even under inference mode: a model that
    sampled first can still be trained)."""
    key = str(device)
    if key not in self._graph:
      with torch.inference_mode(False):
        art = self._artifact
        g, m = art.num_grid_nodes, art.num_mesh_nodes

        def tensor(a):
          return torch.as_tensor(np.ascontiguousarray(a), device=device)

        self._graph[key] = {
            "g2m": EdgeIndex(art.grid2mesh.senders, art.grid2mesh.receivers,
                             g, m, device=device),
            "m2g": EdgeIndex(art.mesh2grid.senders, art.mesh2grid.receivers,
                             m, g, device=device),
            "grid_node_features": tensor(art.grid_node_features),
            "mesh_node_features": tensor(art.mesh_node_features),
            "g2m_edge_features": tensor(art.grid2mesh.features),
            "m2g_edge_features": tensor(art.mesh2grid.features),
        }
        if self._g2m_plan is not None:
          self._graph[key]["g2m_chunks"] = node_chunks(
              self._g2m_plan, art.grid2mesh, g, device)
        if self._decode_chunks > 1:
          self._graph[key]["m2g_chunks"] = decode_chunk_senders(
              art.mesh2grid, m, choose_chunks(g, self._decode_chunks),
              device)
    return self._graph[key]

  # ----- fused stages (batch 1; conditioning folded into vectors) -----

  def _run_grid2mesh(self, st, x, cond):
    """Conditioned grid2mesh encode: node embeds, K1 in embed mode (the edge
    embed, We' and the step in one pass), node updates + residuals."""
    gnn = self.grid2mesh_gnn
    latent = self._cfg.latent_size
    dtype = x.dtype
    num_mesh = self._artifact.num_mesh_nodes
    grid_in = torch.cat([x, st["grid_node_features"].to(dtype)], dim=-1)
    mesh_in = torch.cat([x.new_zeros(num_mesh, x.shape[-1]),
                         st["mesh_node_features"].to(dtype)], dim=-1)
    grid_emb = gnn["encoder_nodes_grid_nodes"](grid_in, cond=cond)
    mesh_emb = gnn["encoder_nodes_mesh_nodes"](mesh_in, cond=cond)
    pe = gnn["processor_0_edges_grid2mesh"]
    we, ws, wr, b0 = pe.factored_first_layer(latent, latent, dtype)
    embed = gnn["encoder_edges_grid2mesh"]
    s_e, o_e = embed.norm_conditioning.scale_offset(cond, dtype)
    s1, o1 = pe.norm_conditioning.scale_offset(cond, dtype)
    ee = embed.mlp
    agg = fused_edge(
        st["g2m"], st["g2m_edge_features"], grid_emb @ ws, mesh_emb @ wr,
        s_e[:, None] * we, o_e @ we + b0.to(dtype), pe.mlp["linear_1"].full_w,
        pe.mlp["linear_1"].full_b, s1, o1, write_edges=False,
        embed_weights=(ee["linear_0"].full_w, ee["linear_0"].full_b,
                       ee["linear_1"].full_w, ee["linear_1"].full_b),
        pipelined=self._pipelined)
    if self._cfg.grid2mesh_aggregate_normalization:
      agg = agg / self._cfg.grid2mesh_aggregate_normalization
    mesh_upd = gnn["processor_0_nodes_mesh_nodes"](mesh_emb, agg.to(dtype),
                                                   cond=cond)
    grid_upd = gnn["processor_0_nodes_grid_nodes"](grid_emb, cond=cond)
    return mesh_emb + mesh_upd, grid_emb + grid_upd

  def _run_mesh2grid(self, st, latent_mesh, latent_grid, cond):
    """Conditioned mesh2grid decode: the whole decoder in K2's embed mode."""
    gnn = self.mesh2grid_gnn
    latent = self._cfg.latent_size
    dtype = latent_mesh.dtype
    pe = gnn["processor_0_edges_mesh2grid"]
    pn = gnn["processor_0_nodes_grid_nodes"]
    pd = gnn["decoder_nodes_grid_nodes"]
    embed = gnn["encoder_edges_mesh2grid"]
    we, ws, wr, b0 = pe.factored_first_layer(latent, latent, dtype)
    s_e, o_e = embed.norm_conditioning.scale_offset(cond, dtype)
    es, eo = pe.norm_conditioning.scale_offset(cond, dtype)
    ns, no = pn.norm_conditioning.scale_offset(cond, dtype)
    wn0 = pn.mlp["linear_0"].full_w
    ee = embed.mlp
    weights = {
        "ew0": ee["linear_0"].full_w, "eb0": ee["linear_0"].full_b,
        "ew1": ee["linear_1"].full_w, "eb1": ee["linear_1"].full_b,
        "we": s_e[:, None] * we, "b0": o_e @ we + b0.to(dtype),
        "wr": wr,
        "w1": pe.mlp["linear_1"].full_w, "b1": pe.mlp["linear_1"].full_b,
        "escale": es, "eoffset": eo,
        "wng": wn0[:latent], "wna": wn0[latent:],
        "bn0": pn.mlp["linear_0"].full_b,
        "wn1": pn.mlp["linear_1"].full_w, "bn1": pn.mlp["linear_1"].full_b,
        "nscale": ns, "noffset": no,
        "wd0": pd.mlp["linear_0"].full_w, "bd0": pd.mlp["linear_0"].full_b,
        "wd1": pd.mlp["linear_1"].full_w, "bd1": pd.mlp["linear_1"].full_b,
    }
    return fused_decode(st["m2g"], latent_grid, latent_mesh @ ws,
                        st["m2g_edge_features"], weights)

  # ----- features -----

  def _split_features_and_conditioning(self, inputs: FieldSet,
                                       forcings: FieldSet):
    """Reference: denoiser.py:754-791. Returns (grid node features
    [num_grid, batch, C], conditioning [batch, cond])."""
    cond_names = list(self._cfg.norm_conditioning_features)
    cond_fs = inputs.select([n for n in cond_names if n in inputs])
    if not len(cond_fs):
      raise ValueError("the denoiser needs its norm-conditioning inputs "
                       f"{cond_names}")
    for name in cond_fs.var_names:
      if {"lat", "lon"} & set(cond_fs[name].dims):
        raise ValueError("lat/lon conditioning features unsupported")
    cond = to_stacked(cond_fs, preserved_dims=("batch",))
    stacked = torch.cat([to_stacked(inputs.drop(cond_names)),
                         to_stacked(forcings)], dim=-1)
    stacked = stacked.permute(1, 2, 0, 3)  # [lat, lon, batch, C]
    return stacked.reshape((-1,) + tuple(stacked.shape[2:])), cond

  # ----- the general path (any batch; a conditioning row per member) -----

  def _run_grid2mesh_general(self, st, features, cond):
    """graphcast_tpu models/denoiser.py:715-730; K3 aggregates the
    grid2mesh edge set."""
    g2m = self.grid2mesh_gnn(
        grid2mesh_graph(st, features), cond=cond, edge_aggregators={
            "grid2mesh": functools.partial(sorted_segment_sum, st["g2m"])})
    return (g2m.nodes["mesh_nodes"].features,
            g2m.nodes["grid_nodes"].features)

  def _run_mesh2grid_general(self, st, latent_mesh, latent_grid, cond):
    m2g = self.mesh2grid_gnn(
        mesh2grid_graph(st, latent_mesh, latent_grid), cond=cond,
        edge_aggregators={
            "mesh2grid": functools.partial(sorted_segment_sum, st["m2g"])})
    return m2g.nodes["grid_nodes"].features

  def forward(self, inputs: FieldSet, targets_template: FieldSet,
              forcings: FieldSet) -> FieldSet:
    features, cond = self._split_features_and_conditioning(inputs, forcings)
    self._maybe_init(inputs)
    st = self._statics(features.device)
    fused = self._fused and features.shape[1] == 1
    if fused:
      latent_mesh, latent_grid = (t[:, None] for t in self._run_grid2mesh(
          st, features[:, 0], cond))
    elif self._g2m_plan is not None:
      latent_mesh, latent_grid = grid2mesh_chunked(
          self.grid2mesh_gnn, st, features, cond,
          normalization=self._cfg.grid2mesh_aggregate_normalization)
    else:
      latent_mesh, latent_grid = self._run_grid2mesh_general(st, features,
                                                             cond)
    latent_mesh = self.mesh_transformer(latent_mesh, cond)
    if fused:
      out = self._run_mesh2grid(st, latent_mesh[:, 0], latent_grid[:, 0],
                                cond)[:, None]
    elif self._decode_chunks > 1:
      out = mesh2grid_chunked(self.mesh2grid_gnn, st, latent_mesh,
                              latent_grid, cond)
    else:
      out = self._run_mesh2grid_general(st, latent_mesh, latent_grid, cond)
    art = self._artifact
    data = out.reshape(art.grid_lat.shape[0], art.grid_lon.shape[0],
                       *out.shape[1:])
    return from_stacked(data.permute(2, 0, 1, 3), targets_template)


class Denoiser(nn.Module):
  """Noise-level encodings and noisy-target forcings around the
  architecture (reference: denoiser.py:197-246). Parameters ``noise_encoder``
  and ``architecture``, the JAX package's keys."""

  def __init__(self, noise_encoder_config: Optional[NoiseEncoderConfig],
               architecture_config: DenoiserArchitectureConfig,
               task_config: configs.TaskConfig, **forms):
    """``forms``: DenoiserArchitecture's ``cache_dir``, ``decode_chunks``,
    ``encode_chunks`` and ``fused_aggregation``."""
    super().__init__()
    self.noise_encoder = FourierFeaturesMLP(noise_encoder_config
                                            or NoiseEncoderConfig())
    self.architecture = DenoiserArchitecture(
        architecture_config, task_config, self.noise_encoder.output_size,
        **forms)

  def _assemble(self, inputs: FieldSet, noisy_targets: FieldSet,
                noise_levels: torch.Tensor, forcings: Optional[FieldSet]):
    if noise_levels.ndim != 1:
      raise ValueError("noise_levels expected to be shape (batch,)")
    if forcings is None or not len(forcings):
      forcings = noisy_targets
    else:
      forcings = FieldSet.merge([forcings, noisy_targets])
    dtypes = {f.dtype for f in noisy_targets.values()}
    dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32
    encodings = self.noise_encoder(noise_levels.to(dtype))
    inputs = FieldSet.merge([inputs, FieldSet({
        COND_NAME: Field(encodings, ("batch", "noise_level_encoding_channels"))
    })])
    return inputs, forcings

  def denoise(self, inputs: FieldSet, noisy_targets: FieldSet,
              noise_levels: torch.Tensor,
              forcings: Optional[FieldSet] = None) -> FieldSet:
    """One denoiser evaluation (the JAX package's ``Denoiser.apply``)."""
    all_inputs, all_forcings = self._assemble(inputs, noisy_targets,
                                              noise_levels, forcings)
    return self.architecture(all_inputs, noisy_targets, all_forcings)

  forward = denoise
