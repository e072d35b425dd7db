"""Plain float32 GraphCast: the one-step forward of GraphCast (Lam et al.,
Science 2023) and its AR-1 training loss, written from the paper's
equations in plain PyTorch operations, for the benchmark's comparisons.

It imports nothing of the program. It takes the configuration's file
(``portbench/configs/*.json``), a dict of weights keyed by the program's
parameter names (``param_shapes`` lists them), the graph it builds itself
(``geometry.build_graph``) and the inputs as plain tensors, and works out
every derived quantity again: normalisation, stacking, the static edge
embeddings, the residual.

Layout: grid nodes are lat-major, [G, B, C]; each MLP is Linear, swish,
Linear, then LayerNorm (eps 1e-5) except the output MLP. An edge update
takes concat(edge, sender, receiver) through its first layer, written as
the sum of the three row blocks' products (the same function). Sums over
incoming edges are float32 ``index_add``. Encoder: embed grid and mesh
nodes (the mesh nodes' input is zeros beside their 3 structural features)
and the grid2mesh edges, one interaction step into the mesh nodes, the grid
nodes through their own MLP, residuals. Processor: ``gnn_msg_steps``
interaction steps on the multi-mesh with edge and node residuals. Decoder:
one interaction step from the mesh into the grid nodes, residual, then the
output MLP: the normalised residual of each target variable. Departure from
the paper: none in the mathematics; the mesh nodes' update inside the
decoder, which feeds no output, is not computed.

``precision`` "float32" runs every product in float32 with TF32 off (the
caller turns it off; ``no_tf32``); "float8_e4m3" rounds both operands of
every product to float8 e4m3 with a per-tensor scale, the control that a
comparison must fail. Memory is bounded by running the edge sets and the
grid nodes in row blocks; under grad each block is a recompute region.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import numpy as np
import torch
from torch.nn import functional as F
from torch.utils import checkpoint as torch_checkpoint

from portbench.reference import geometry

FP8_MAX = 448.0
LN_EPS = 1e-5
BLOCK_ROWS = 1 << 18   # edge and grid-node rows per block


@contextlib.contextmanager
def no_tf32():
  """float32 products in float32: TF32 off for matmuls and cuDNN."""
  saved = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def quantizer(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
  """The rounding applied to both operands of every product."""
  if precision == "float32":
    return lambda t: t
  if precision != "float8_e4m3":
    raise ValueError(f"unknown reference precision {precision!r}")

  def q(t):
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    r = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (r - t.detach())  # the rounded value, an identity gradient
  return q


# --- configuration helpers


def levels(cfg) -> int:
  return len(cfg["pressure_levels"])


def is_atmospheric(cfg, name: str) -> bool:
  return name in cfg["atmospheric_variables"]


def width(cfg, name: str) -> int:
  return levels(cfg) if is_atmospheric(cfg, name) else 1


def input_frames(cfg) -> int:
  return int(cfg["input_duration"].rstrip("h")) // cfg["step_hours"]


def grid_input_channels(cfg) -> int:
  frames = input_frames(cfg)
  static = set(cfg["static_variables"])
  return (sum(width(cfg, n) * (1 if n in static else frames)
              for n in cfg["input_variables"])
          + sum(width(cfg, n) for n in cfg["forcing_variables"]))


def output_channels(cfg) -> int:
  return sum(width(cfg, n) for n in cfg["target_variables"])


def param_shapes(cfg) -> dict[str, tuple[int, ...]]:
  """Every weight's name (the program's parameter names) and shape."""
  C = cfg["latent_size"]
  node_in = grid_input_channels(cfg) + 3
  out = {}

  def mlp(name, n_in, n_out, norm=True):
    out[f"{name}.mlp.linear_0.w"] = (n_in, C)
    out[f"{name}.mlp.linear_0.b"] = (C,)
    out[f"{name}.mlp.linear_1.w"] = (C, n_out)
    out[f"{name}.mlp.linear_1.b"] = (n_out,)
    if norm:
      out[f"{name}.layer_norm.scale"] = (n_out,)
      out[f"{name}.layer_norm.offset"] = (n_out,)

  g = "grid2mesh_gnn."
  mlp(g + "encoder_edges_grid2mesh", 4, C)
  mlp(g + "encoder_nodes_grid_nodes", node_in, C)
  mlp(g + "encoder_nodes_mesh_nodes", node_in, C)
  mlp(g + "processor_0_edges_grid2mesh", 3 * C, C)
  mlp(g + "processor_0_nodes_grid_nodes", C, C)
  mlp(g + "processor_0_nodes_mesh_nodes", 2 * C, C)
  m = "mesh_gnn."
  mlp(m + "encoder_edges_mesh", 4, C)
  for i in range(cfg["gnn_msg_steps"]):
    mlp(m + f"processor_{i}_edges_mesh", 3 * C, C)
    mlp(m + f"processor_{i}_nodes_mesh_nodes", 2 * C, C)
  d = "mesh2grid_gnn."
  mlp(d + "decoder_nodes_grid_nodes", C, output_channels(cfg), norm=False)
  mlp(d + "encoder_edges_mesh2grid", 4, C)
  mlp(d + "processor_0_edges_mesh2grid", 3 * C, C)
  mlp(d + "processor_0_nodes_grid_nodes", 2 * C, C)
  mlp(d + "processor_0_nodes_mesh_nodes", C, C)
  return dict(sorted(out.items()))


# --- the graph on the device


class DeviceGraph:
  """The reference's graph (geometry.Graph) as float32/int64 tensors."""

  def __init__(self, cfg, device):
    res = cfg["resolution"]
    lat = np.arange(-90.0, 90.0 + res / 2, res).astype(np.float32)
    lon = np.arange(0.0, 360.0, res).astype(np.float32)
    self.num_lat, self.num_lon = lat.shape[0], lon.shape[0]
    g = geometry.build_graph(lat, lon, cfg["mesh_size"],
                             cfg["radius_query_fraction_edge_length"],
                             multimesh=True)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    self.num_grid, self.num_mesh = g.num_grid, g.num_mesh
    self.grid_features = t(g.grid_features)
    self.mesh_features = t(g.mesh_features)
    self.edges = {name: tuple(t(a) for a in getattr(g, name))
                  for name in ("g2m", "mesh", "m2g")}
    self.lat = lat


# --- building blocks


def _run(fn, *args, grad: bool):
  """fn(*args), a recompute region under grad."""
  if grad:
    return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False)
  return fn(*args)


def linear(x, w, b, q):
  y = q(x) @ q(w)
  return y if b is None else y + b


def mlp(p, name, x, q, norm=True):
  h = linear(x, p[f"{name}.mlp.linear_0.w"], p[f"{name}.mlp.linear_0.b"], q)
  y = linear(F.silu(h), p[f"{name}.mlp.linear_1.w"],
             p[f"{name}.mlp.linear_1.b"], q)
  if norm:
    y = F.layer_norm(y, y.shape[-1:], p[f"{name}.layer_norm.scale"],
                     p[f"{name}.layer_norm.offset"], eps=LN_EPS)
  return y


def mlp_tail(p, name, h, q):
  """The edge MLP after its first layer's pre-activation ``h``."""
  y = linear(F.silu(h), p[f"{name}.mlp.linear_1.w"],
             p[f"{name}.mlp.linear_1.b"], q)
  return F.layer_norm(y, y.shape[-1:], p[f"{name}.layer_norm.scale"],
                      p[f"{name}.layer_norm.offset"], eps=LN_EPS)


def _receiver_blocks(receivers: torch.Tensor, num_nodes: int, rows: int):
  """(e0, e1, n0, n1) blocks of a receiver-sorted edge list that tile the
  nodes [0, num_nodes): each block's edges go into its own node range."""
  num_edges = receivers.shape[0]
  blocks = max(1, math.ceil(num_edges / rows))
  nodes = np.linspace(0, num_nodes, blocks + 1).round().astype(np.int64)
  edges = torch.searchsorted(receivers, torch.as_tensor(
      nodes, device=receivers.device)).tolist()
  return [(edges[i], edges[i + 1], int(nodes[i]), int(nodes[i + 1]))
          for i in range(blocks) if nodes[i + 1] > nodes[i]]


def edge_step(p, name, e_of, senders, receivers, sproj, rproj, num_nodes, q,
              grad, want_edges=False):
  """One interaction step's edge update and its float32 sum into the
  receivers. ``e_of(e0, e1)`` gives the edge latents [e, B, C] of a block;
  sproj, rproj: the sender and receiver latents times their first-layer
  blocks. Returns (sum [N, B, C], new edge latents or None)."""
  C = sproj.shape[-1]
  w0 = p[f"{name}.mlp.linear_0.w"]
  b0 = p[f"{name}.mlp.linear_0.b"]

  def block(e0, e1, n0, n1, sproj, rproj):
    e = e_of(e0, e1)
    h = (linear(e, w0[:C], b0, q) + sproj[senders[e0:e1]]
         + rproj[receivers[e0:e1]])
    new = mlp_tail(p, name, h, q)
    agg = torch.zeros((n1 - n0,) + tuple(new.shape[1:]), dtype=new.dtype,
                      device=new.device).index_add(0, receivers[e0:e1] - n0,
                                                   new)
    return agg, new

  aggs, news = [], []
  for e0, e1, n0, n1 in _receiver_blocks(receivers, num_nodes, BLOCK_ROWS):
    agg, new = _run(lambda s, r, e0=e0, e1=e1, n0=n0, n1=n1: block(
        e0, e1, n0, n1, s, r), sproj, rproj, grad=grad)
    aggs.append(agg)
    if want_edges:
      news.append(new)
  return torch.cat(aggs), (torch.cat(news) if want_edges else None)


def node_rows(fn, x, grad, rows=BLOCK_ROWS):
  """fn over row blocks of x."""
  return torch.cat([_run(fn, x[i:i + rows], grad=grad)
                    for i in range(0, x.shape[0], rows)])


# --- the model


def forward(cfg, p, graph: DeviceGraph, grid_in: torch.Tensor, q,
            grad: bool = False) -> torch.Tensor:
  """[G, B, grid input channels] normalised inputs → [G, B, outputs]
  normalised residuals."""
  C = cfg["latent_size"]
  B = grid_in.shape[1]
  struct_g = graph.grid_features[:, None].expand(-1, B, -1)
  struct_m = graph.mesh_features[:, None].expand(-1, B, -1)
  g = "grid2mesh_gnn."

  def embed_grid(x):
    return mlp(p, g + "encoder_nodes_grid_nodes", x, q)

  grid_full = torch.cat([grid_in, struct_g], dim=-1)
  grid_emb = node_rows(embed_grid, grid_full, grad)
  del grid_full
  mesh_in = torch.cat([grid_in.new_zeros(graph.num_mesh, B,
                                         grid_in.shape[-1]), struct_m], -1)
  mesh_emb = mlp(p, g + "encoder_nodes_mesh_nodes", mesh_in, q)

  def edge_embed(prefix, edge_set):
    feats = graph.edges[edge_set][2]
    return lambda e0, e1: mlp(p, prefix, feats[e0:e1], q)[:, None].expand(
        -1, B, -1)

  # Encoder: grid2mesh.
  pe = g + "processor_0_edges_grid2mesh"
  w0 = p[f"{pe}.mlp.linear_0.w"]
  snd, rcv, _ = graph.edges["g2m"]
  sproj = node_rows(lambda x, w=w0[C:2 * C]: linear(x, w, None, q), grid_emb,
                    grad)
  rproj = linear(mesh_emb, w0[2 * C:], None, q)
  agg, _ = edge_step(p, pe, edge_embed(g + "encoder_edges_grid2mesh", "g2m"),
                     snd, rcv, sproj, rproj, graph.num_mesh, q, grad)
  del sproj
  mesh = mesh_emb + mlp(p, g + "processor_0_nodes_mesh_nodes",
                        torch.cat([mesh_emb, agg], -1), q)
  grid = node_rows(lambda x: x + mlp(p, g + "processor_0_nodes_grid_nodes",
                                     x, q), grid_emb, grad)
  del grid_emb

  # Processor: the multi-mesh.
  m = "mesh_gnn."
  snd, rcv, feats = graph.edges["mesh"]
  e = _run(lambda f: mlp(p, m + "encoder_edges_mesh", f, q), feats,
           grad=grad)[:, None].expand(-1, B, -1)
  for i in range(cfg["gnn_msg_steps"]):
    def step(mesh, e, i=i, snd=snd, rcv=rcv):
      pe = m + f"processor_{i}_edges_mesh"
      w0 = p[f"{pe}.mlp.linear_0.w"]
      agg, new_e = edge_step(
          p, pe, lambda e0, e1: e[e0:e1], snd, rcv,
          linear(mesh, w0[C:2 * C], None, q), linear(mesh, w0[2 * C:], None, q),
          graph.num_mesh, q, grad=False, want_edges=True)
      new_mesh = mesh + mlp(p, m + f"processor_{i}_nodes_mesh_nodes",
                            torch.cat([mesh, agg], -1), q)
      return new_mesh, e + new_e
    mesh, e = _run(step, mesh, e, grad=grad)
  del e

  # Decoder: mesh2grid, in blocks of grid nodes (3 edges each).
  d = "mesh2grid_gnn."
  pe = d + "processor_0_edges_mesh2grid"
  w0 = p[f"{pe}.mlp.linear_0.w"]
  snd, rcv, feats = graph.edges["m2g"]
  sproj = linear(mesh, w0[C:2 * C], None, q)
  rows = BLOCK_ROWS // 4

  def decode(n0, grid_rows, sproj):
    n1 = n0 + grid_rows.shape[0]
    e0, e1 = 3 * n0, 3 * n1
    e_emb = mlp(p, d + "encoder_edges_mesh2grid", feats[e0:e1], q)[:, None]
    h = (linear(e_emb, w0[:C], p[f"{pe}.mlp.linear_0.b"], q)
         + sproj[snd[e0:e1]]
         + linear(grid_rows, w0[2 * C:], None, q)[rcv[e0:e1] - n0])
    new = mlp_tail(p, pe, h, q)
    agg = torch.zeros_like(grid_rows).index_add(0, rcv[e0:e1] - n0, new)
    upd = grid_rows + mlp(p, d + "processor_0_nodes_grid_nodes",
                          torch.cat([grid_rows, agg], -1), q)
    return mlp(p, d + "decoder_nodes_grid_nodes", upd, q, norm=False)

  return torch.cat([
      _run(lambda gr, sp, n0=n0: decode(n0, gr, sp), grid[n0:n0 + rows], sproj,
           grad=grad)
      for n0 in range(0, graph.num_grid, rows)])


# --- inputs, outputs and the loss


def normalize(cfg, fields: dict, stats: dict, device) -> dict:
  """(x - mean) / stddev per variable; per level for atmospheric ones.
  fields: name → [B, T, (L,) lat, lon] or [lat, lon] for statics."""
  out = {}
  for name, x in fields.items():
    mean = stats["mean"][name].to(device)
    std = stats["stddev"][name].to(device)
    if is_atmospheric(cfg, name):
      mean, std = mean[:, None, None], std[:, None, None]
    out[name] = (x.float() - mean) / std
  return out


def stack(cfg, fields: dict, names) -> torch.Tensor:
  """Fields → [G, B, channels]: variables in sorted order, each one's
  time and level axes flattened in that order."""
  parts = []
  B = next(x.shape[0] for n, x in fields.items()
           if n not in cfg["static_variables"])
  for name in sorted(names):
    x = fields[name]
    if name in cfg["static_variables"]:
      x = x[None, None].expand(B, 1, *x.shape)
    lat, lon = x.shape[-2:]
    x = x.reshape(B, -1, lat * lon)          # [B, channels, G]
    parts.append(x.permute(2, 0, 1))
  return torch.cat(parts, dim=-1)


def unstack(cfg, out: torch.Tensor, num_lat: int, num_lon: int) -> dict:
  """[G, B, outputs] → name → [B, (L,) lat, lon], target variables in
  sorted order."""
  res, c = {}, 0
  B = out.shape[1]
  for name in sorted(cfg["target_variables"]):
    w = width(cfg, name)
    x = out[..., c:c + w].permute(1, 2, 0).reshape(B, w, num_lat, num_lon)
    res[name] = x if is_atmospheric(cfg, name) else x[:, 0]
    c += w
  return res


def residuals(cfg, p, graph, stats, inputs: dict, forcings: dict, q,
              grad=False) -> dict:
  """The normalised residual the model predicts for each target variable,
  name → [B, (L,) lat, lon], from raw inputs (time = the input frames)
  and one step's forcings."""
  device = graph.grid_features.device
  grid_in = torch.cat([
      stack(cfg, normalize(cfg, inputs, stats, device), inputs),
      stack(cfg, normalize(cfg, forcings, stats, device), forcings)], -1)
  out = forward(cfg, p, graph, grid_in, q, grad=grad)
  return unstack(cfg, out, graph.num_lat, graph.num_lon)


def latitude_weights(lat: np.ndarray) -> np.ndarray:
  """Cell-area weights over the mean, poles included (a grid from -90 to
  90): cos(lat) sin(Δ/2), and sin²(Δ/4) at the poles."""
  lat = np.asarray(lat, np.float64)
  delta = abs(lat[1] - lat[0])
  w = np.cos(np.deg2rad(lat)) * np.sin(np.deg2rad(delta / 2))
  pole = np.isclose(np.abs(lat), 90.0)
  w[pole] = np.sin(np.deg2rad(delta / 4)) ** 2
  return w / w.mean()


def loss(cfg, p, graph, stats, inputs, targets, forcings, q, grad=True):
  """The AR-1 training loss: the latitude-, level- and variable-weighted
  MSE of the normalised residuals against the targets' (mean over the
  batch)."""
  device = graph.grid_features.device
  pred = residuals(cfg, p, graph, stats, inputs, forcings, q, grad=grad)
  lat_w = torch.as_tensor(latitude_weights(graph.lat), dtype=torch.float32,
                          device=device)[:, None]
  lev = np.asarray(cfg["pressure_levels"], np.float64)
  lev_w = torch.as_tensor(lev / lev.mean(), dtype=torch.float32,
                          device=device)[:, None, None]
  total = 0.0
  for name in sorted(cfg["target_variables"]):
    last = inputs[name][:, -1].float()
    diff = stats["diffs_stddev"][name].to(device)
    if is_atmospheric(cfg, name):
      diff = diff[:, None, None]
    target = (targets[name][:, 0].float() - last) / diff
    err2 = (pred[name] - target) ** 2 * lat_w
    if is_atmospheric(cfg, name):
      err2 = err2 * lev_w
    total = total + err2.mean() * cfg["loss_weights"].get(name, 1.0)
  return total
