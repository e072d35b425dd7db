"""Plain float32 GenCast: one 12 h sample of GenCast (Price et al., Nature
2024), its denoiser, its spherical noise and its sampler, written from the
paper's equations in plain PyTorch operations, for the benchmark's
comparisons.

It imports nothing of the program. It takes the configuration's file
(``portbench/configs/*.json``), a dict of weights keyed by the program's
parameter names (``param_shapes`` lists them), the graph it builds itself
(``geometry.build_graph`` on the finest mesh alone, and ``geometry.
k_hop_mask`` for the attention), and the inputs as plain tensors, and works
out every derived quantity again: normalisation, stacking, the noise-level
encoding, the sampler's noise levels and its noise.

Layout: grid nodes lat-major, [G, B, C]; mesh nodes in the mesh's own
order. Every LayerNorm is parameter-free (eps 1e-5) and followed by a norm
conditioning: x·(1 + s) + o with (s, o) a linear map of the noise-level
encoding. Each graph MLP is Linear, swish, Linear, LayerNorm, conditioning
(the output MLP: Linear, swish, Linear). Encoder: embed grid nodes, mesh
nodes (zeros beside their 3 structural features) and grid2mesh edges, one
interaction step into the mesh nodes, the grid nodes through their own
MLP, residuals. Processor: pre-LN transformer blocks over the mesh nodes,
attention restricted to the nodes within ``attention_k_hop`` mesh edges,
logits and softmax in float32, a GELU (tanh form) feed-forward, and a final
conditioned LayerNorm. Decoder: one interaction step from the mesh into the
grid, residual, the output MLP. Sums over incoming edges are float32.

Noise: unit-variance isotropic noise on the sphere, a real spherical
harmonic synthesis of N(0, 1) coefficients with a flat power spectrum over
n_lon / 2 wavenumbers; the coefficients are drawn, as the program draws
them, from one generator per ensemble member (``member_generators``), in
the program's order of draws (``NoiseStream``). Sampler: DPM-Solver++ 2S
on the EDM preconditioned denoiser, with stochastic churn.

``precision`` as in ``graphcast``: "float32" (TF32 off) or "float8_e4m3",
both operands of every product of the model rounded to float8; the
noise's synthesis is float64 in both.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

from portbench.reference import geometry
from portbench.reference.graphcast import (  # noqa: F401  (shared helpers)
    LN_EPS, is_atmospheric, levels, linear, no_tf32, quantizer, width)

ATTENTION_ROWS = 2048   # query rows per block of the dense masked attention


# --- configuration helpers


def input_frames(cfg) -> int:
  return int(cfg["input_duration"].rstrip("h")) // cfg["step_hours"]


def grid_input_channels(cfg) -> int:
  """Stacked inputs (time frames of the dynamic ones, the statics once),
  the step's forcings and the noisy targets."""
  frames = input_frames(cfg)
  static = set(cfg["static_variables"])
  return (sum(width(cfg, n) * (1 if n in static else frames)
              for n in cfg["input_variables"])
          + sum(width(cfg, n) for n in cfg["forcing_variables"])
          + output_channels(cfg))


def output_channels(cfg) -> int:
  return sum(width(cfg, n) for n in cfg["target_variables"])


def param_shapes(cfg) -> dict[str, tuple[int, ...]]:
  """Every weight's name (the program's parameter names) and shape."""
  C = cfg["latent_size"]
  K = cfg["noise_encoder"]["output_sizes"][-1]
  t = cfg["transformer"]
  D, H = t["d_model"], t["ffw_hidden"]
  node_in = grid_input_channels(cfg) + 3
  out = {}

  def lin(name, n_in, n_out, bias=True):
    out[f"{name}.w"] = (n_in, n_out)
    if bias:
      out[f"{name}.b"] = (n_out,)

  def mlp(name, n_in, n_out, cond=True):
    lin(f"{name}.mlp.linear_0", n_in, C)
    lin(f"{name}.mlp.linear_1", C, n_out)
    if cond:
      lin(f"{name}.norm_conditioning", K, 2 * n_out)

  sizes = [2 * cfg["noise_encoder"]["num_frequencies"]] + list(
      cfg["noise_encoder"]["output_sizes"])
  for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
    lin(f"noise_encoder.linear_{i}", a, b)
  g = "architecture.grid2mesh_gnn."
  mlp(g + "encoder_edges_grid2mesh", 4, C)
  mlp(g + "encoder_nodes_grid_nodes", node_in, C)
  mlp(g + "encoder_nodes_mesh_nodes", node_in, C)
  mlp(g + "processor_0_edges_grid2mesh", 3 * C, C)
  mlp(g + "processor_0_nodes_grid_nodes", C, C)
  mlp(g + "processor_0_nodes_mesh_nodes", 2 * C, C)
  m = "architecture.mesh_transformer."
  for i in range(t["num_layers"]):
    b = f"{m}block_{i:02d}."
    for name in ("mha_proj_q", "mha_proj_k", "mha_proj_v"):
      lin(b + name, D, D, bias=False)
    lin(b + "mha_final", D, D)
    lin(b + "ffw_up", D, H)
    lin(b + "ffw_down", H, D)
    lin(b + "norm_conditioning", K, 2 * D)
    lin(b + "norm_conditioning_1", K, 2 * D)
  lin(m + "final_norm_conditioning", K, 2 * D)
  d = "architecture.mesh2grid_gnn."
  mlp(d + "decoder_nodes_grid_nodes", C, output_channels(cfg), cond=False)
  mlp(d + "encoder_edges_mesh2grid", 4, C)
  mlp(d + "processor_0_edges_mesh2grid", 3 * C, C)
  mlp(d + "processor_0_nodes_grid_nodes", 2 * C, C)
  mlp(d + "processor_0_nodes_mesh_nodes", C, C)
  return dict(sorted(out.items()))


# --- the graph on the device


class DeviceGraph:
  """The reference's graph on the finest mesh, its k-hop attention mask
  and its SHT synthesis basis, as tensors on ``device``."""

  def __init__(self, cfg, device):
    res = cfg["resolution"]
    lat = np.arange(-90.0, 90.0 + res / 2, res).astype(np.float32)
    lon = np.arange(0.0, 360.0, res).astype(np.float32)
    self.num_lat, self.num_lon = lat.shape[0], lon.shape[0]
    g = geometry.build_graph(lat, lon, cfg["mesh_size"],
                             cfg["radius_query_fraction_edge_length"],
                             multimesh=False)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    self.num_grid, self.num_mesh = g.num_grid, g.num_mesh
    self.grid_features = t(g.grid_features)
    self.mesh_features = t(g.mesh_features)
    self.edges = {name: tuple(t(a) for a in getattr(g, name))
                  for name in ("g2m", "mesh", "m2g")}
    mask = geometry.k_hop_mask(g.mesh[0], g.mesh[1], g.num_mesh,
                               cfg["transformer"]["attention_k_hop"])
    self.mask_nnz = int(mask.sum())
    self.mask = t(mask)
    self.basis = sht_basis(lat, lon, device)


# --- spherical noise


def normalized_legendre(max_l: int, x: np.ndarray) -> np.ndarray:
  """P̃_l^m(x) [len(x), l, m] for 0 ≤ m ≤ l < max_l, orthonormal over the
  sphere (with the Condon-Shortley phase), float64; zero where m > l."""
  x = np.asarray(x, np.float64)
  p = np.zeros((x.shape[0], max_l, max_l))
  s = np.sqrt(np.maximum(0.0, 1.0 - x * x))
  p[:, 0, 0] = math.sqrt(1.0 / (4.0 * math.pi))
  for m in range(1, max_l):
    p[:, m, m] = -math.sqrt((2 * m + 1) / (2 * m)) * s * p[:, m - 1, m - 1]
  for m in range(max_l - 1):
    p[:, m + 1, m] = math.sqrt(2 * m + 3) * x * p[:, m, m]
  for m in range(max_l):
    for l in range(m + 2, max_l):
      a = math.sqrt((4 * l * l - 1) / (l * l - m * m))
      b = math.sqrt(((l - 1) ** 2 - m * m) / (4 * (l - 1) ** 2 - 1))
      p[:, l, m] = a * (x * p[:, l - 1, m] - b * p[:, l - 2, m])
  return p


def sht_basis(lat: np.ndarray, lon: np.ndarray, device) -> dict:
  """float64 synthesis tensors of the grid: real harmonics up to
  wavenumber n_lon / 2 (exclusive)."""
  max_l = lon.shape[0] // 2
  phi = np.deg2rad(np.asarray(lon, np.float64))
  m = np.arange(max_l)[:, None]
  m_scale = np.where(np.arange(max_l) == 0, 1.0, math.sqrt(2.0))[:, None]
  t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
  return {"legendre": t(normalized_legendre(
              max_l, np.sin(np.deg2rad(np.asarray(lat, np.float64))))),
          "cos": t(np.cos(m * phi[None]) * m_scale),
          "sin": t(np.sin(m * phi[None]) * m_scale * (m > 0)),
          "max_l": max_l}


def synthesize(basis: dict, cos_coeffs, sin_coeffs) -> torch.Tensor:
  """Σ_lm a_lm Y_lm on the grid: [..., l, m] coefficients → [..., lat,
  lon] float32."""
  leg = basis["legendre"]
  g_c = torch.einsum("...lm,plm->...mp", cos_coeffs.double(), leg)
  g_s = torch.einsum("...lm,plm->...mp", sin_coeffs.double(), leg)
  return (torch.einsum("...mp,mq->...pq", g_c, basis["cos"])
          + torch.einsum("...mp,mq->...pq", g_s, basis["sin"])).float()


def member_generators(base: torch.Generator, members) -> list:
  """One generator a member, as the program seeds them: a draw of
  ``base`` below 2**62, and the member's index, through numpy's
  SeedSequence (frozen copy of the port's rollout.member_generators)."""
  seed = int(torch.randint(0, 2**62, (), generator=base, device=base.device))
  out = []
  for m in members:
    state = np.random.SeedSequence([seed, m]).generate_state(2, np.uint32)
    out.append(torch.Generator(device=base.device).manual_seed(
        int(state[0]) << 31 | int(state[1]) >> 1))
  return out


class NoiseStream:
  """One member's noise fields, drawn from its generator in the program's
  order: for each noise draw, each target variable in name order, its
  cosine then its sine coefficients, each of shape [1 (time), (levels,)
  l, m] in float32."""

  def __init__(self, cfg, generator: torch.Generator, basis: dict):
    self.cfg, self.gen, self.basis = cfg, generator, basis
    L = basis["max_l"]
    ls = np.arange(L)
    std = np.sqrt(4.0 * np.pi / L / (2.0 * ls + 1.0))
    tri = (ls[None, :] <= ls[:, None])
    self.scale = torch.as_tensor((std[:, None] * tri).astype(np.float32),
                                 device=generator.device)

  def _shape(self, name):
    lead = (1, levels(self.cfg)) if is_atmospheric(self.cfg, name) else (1,)
    return lead + (self.basis["max_l"],) * 2

  def draw(self) -> dict:
    """name → [1 (batch), 1 (time), (levels,) lat, lon] unit noise."""
    out = {}
    for name in sorted(self.cfg["target_variables"]):
      shape = self._shape(name)
      c = torch.randn(shape, generator=self.gen, device=self.gen.device)
      s = torch.randn(shape, generator=self.gen, device=self.gen.device)
      out[name] = synthesize(self.basis, c * self.scale,
                             s * self.scale)[None]
    return out

  def skip(self):
    """Advances the stream past one draw."""
    for name in sorted(self.cfg["target_variables"]):
      for _ in range(2):
        torch.randn(self._shape(name), generator=self.gen,
                    device=self.gen.device)


def schedule(cfg) -> tuple[np.ndarray, np.ndarray]:
  """(σ levels, descending, with a final 0; churn rate of each step)."""
  s = cfg["sampler"]
  rho = s["rho"]
  cdf = np.linspace(1, 0, s["num_noise_levels"])
  lo, hi = s["min_noise_level"] ** (1 / rho), s["max_noise_level"] ** (1 / rho)
  sigmas = np.append((lo + cdf * (hi - lo)) ** rho, 0.0)
  steps = len(sigmas) - 1
  rate = min(s["stochastic_churn_rate"] / steps, math.sqrt(2) - 1)
  high = s["churn_max_noise_level"]
  high = math.inf if high is None else high
  active = (s["churn_min_noise_level"] <= sigmas[:-1]) & (sigmas[:-1] <= high)
  return sigmas, active * rate


def draws_per_sample(cfg) -> int:
  """Noise draws a member makes in one 12 h sample: the initial noise and
  one for each step with churn."""
  return 1 + int((schedule(cfg)[1] > 0).sum())


# --- the denoiser


def layer_norm(x):
  return F.layer_norm(x, x.shape[-1:], eps=LN_EPS)


def conditioned(p, name, x, cond, q):
  """x·(1 + s) + o, (s, o) = cond·W + b; x [..., B, C], cond [B, K]."""
  s, o = linear(cond, p[f"{name}.w"], p[f"{name}.b"], q).chunk(2, -1)
  return x * (1.0 + s) + o


def mlp(p, name, x, cond, q):
  """Linear, swish, Linear, LayerNorm and its conditioning; ``cond`` None:
  the plain output MLP."""
  h = linear(x, p[f"{name}.mlp.linear_0.w"], p[f"{name}.mlp.linear_0.b"], q)
  y = linear(F.silu(h), p[f"{name}.mlp.linear_1.w"],
             p[f"{name}.mlp.linear_1.b"], q)
  if cond is None:
    return y
  return conditioned(p, f"{name}.norm_conditioning", layer_norm(y), cond, q)


def noise_encoding(cfg, p, sigma: torch.Tensor, q) -> torch.Tensor:
  """[B] σ → [B, K]: log σ, cos and sin at multiples of 1/base_period,
  then a GELU MLP."""
  ne = cfg["noise_encoder"]
  x = torch.log(sigma) if ne["apply_log_first"] else sigma
  freqs = torch.arange(1, ne["num_frequencies"] + 1, dtype=torch.float64,
                       device=sigma.device) / ne["base_period"]
  phases = x[:, None] * (2 * math.pi * freqs).float()
  x = torch.cat([torch.cos(phases), torch.sin(phases)], -1)
  n = len(ne["output_sizes"])
  for i in range(n):
    x = linear(x, p[f"noise_encoder.linear_{i}.w"],
               p[f"noise_encoder.linear_{i}.b"], q)
    if i + 1 < n:
      x = F.gelu(x, approximate="tanh")
  return x


def interaction(p, name, e, senders, receivers, snd_nodes, rcv_nodes,
                num_receivers, cond, q):
  """One edge update on concat(edge, sender, receiver) and the float32 sum
  of the new edges into their receivers, [num_receivers, B, C]."""
  msg = mlp(p, name, torch.cat([e, snd_nodes[senders], rcv_nodes[receivers]],
                               -1), cond, q)
  return torch.zeros((num_receivers,) + tuple(msg.shape[1:]),
                     dtype=msg.dtype, device=msg.device).index_add_(
                         0, receivers, msg)


def attention(cfg, p, name, x, mask, q):
  """Multi-head attention of x [M, B, D] over the mask's pairs (query row,
  key column), per member and in blocks of query rows."""
  t = cfg["transformer"]
  H = t["num_heads"]
  dk = t["d_model"] // H
  M, B, _ = x.shape
  proj = lambda w: linear(x, p[f"{name}.{w}.w"], None, q).reshape(M, B, H, dk)  # noqa: E731
  qs, ks, vs = proj("mha_proj_q"), proj("mha_proj_k"), proj("mha_proj_v")
  out = torch.empty_like(qs)
  for b in range(B):
    kb, vb = q(ks[:, b].transpose(0, 1)), q(vs[:, b].transpose(0, 1))
    for r0 in range(0, M, ATTENTION_ROWS):
      r1 = min(M, r0 + ATTENTION_ROWS)
      qb = q(qs[r0:r1, b].transpose(0, 1))             # [H, rows, dk]
      logits = (qb @ kb.transpose(1, 2)) * dk ** -0.5  # [H, rows, M]
      logits = logits.masked_fill(~mask[r0:r1], float("-inf"))
      w = torch.softmax(logits, -1)
      out[r0:r1, b] = (q(w) @ vb).transpose(0, 1)
  return linear(out.reshape(M, B, H * dk), p[f"{name}.mha_final.w"],
                p[f"{name}.mha_final.b"], q)


def transformer(cfg, p, x, cond, mask, q):
  t = cfg["transformer"]
  m = "architecture.mesh_transformer."
  for i in range(t["num_layers"]):
    b = f"{m}block_{i:02d}"
    h = conditioned(p, f"{b}.norm_conditioning", layer_norm(x), cond, q)
    x = x + attention(cfg, p, b, h, mask, q)
    h = conditioned(p, f"{b}.norm_conditioning_1", layer_norm(x), cond, q)
    up = linear(h, p[f"{b}.ffw_up.w"], p[f"{b}.ffw_up.b"], q)
    x = x + linear(F.gelu(up, approximate="tanh"), p[f"{b}.ffw_down.w"],
                   p[f"{b}.ffw_down.b"], q)
  return conditioned(p, f"{m}final_norm_conditioning", layer_norm(x), cond, q)


def network(cfg, p, graph: DeviceGraph, grid_in, cond, q) -> torch.Tensor:
  """[G, B, grid input channels] → [G, B, outputs]; cond [B, K]."""
  B = grid_in.shape[1]
  struct_g = graph.grid_features[:, None].expand(-1, B, -1)
  struct_m = graph.mesh_features[:, None].expand(-1, B, -1)
  g = "architecture.grid2mesh_gnn."
  grid = mlp(p, g + "encoder_nodes_grid_nodes",
             torch.cat([grid_in, struct_g], -1), cond, q)
  mesh_in = torch.cat([grid_in.new_zeros(graph.num_mesh, B,
                                         grid_in.shape[-1]), struct_m], -1)
  mesh = mlp(p, g + "encoder_nodes_mesh_nodes", mesh_in, cond, q)
  snd, rcv, feats = graph.edges["g2m"]
  e = mlp(p, g + "encoder_edges_grid2mesh",
          feats[:, None].expand(-1, B, -1), cond, q)
  agg = interaction(p, g + "processor_0_edges_grid2mesh", e, snd, rcv, grid,
                    mesh, graph.num_mesh, cond, q)
  mesh = mesh + mlp(p, g + "processor_0_nodes_mesh_nodes",
                    torch.cat([mesh, agg], -1), cond, q)
  grid = grid + mlp(p, g + "processor_0_nodes_grid_nodes", grid, cond, q)

  mesh = transformer(cfg, p, mesh, cond, graph.mask, q)

  d = "architecture.mesh2grid_gnn."
  snd, rcv, feats = graph.edges["m2g"]
  e = mlp(p, d + "encoder_edges_mesh2grid",
          feats[:, None].expand(-1, B, -1), cond, q)
  agg = interaction(p, d + "processor_0_edges_mesh2grid", e, snd, rcv, mesh,
                    grid, graph.num_grid, cond, q)
  grid = grid + mlp(p, d + "processor_0_nodes_grid_nodes",
                    torch.cat([grid, agg], -1), cond, q)
  return mlp(p, d + "decoder_nodes_grid_nodes", grid, None, q)


# --- inputs, outputs, the denoiser and the sampler


def normalize(cfg, fields: dict, stats: dict) -> dict:
  """(x - mean) / stddev per variable (per level for atmospheric ones)."""
  out = {}
  for name, x in fields.items():
    mean, std = stats["mean"][name], stats["stddev"][name]
    if is_atmospheric(cfg, name):
      mean, std = mean[:, None, None], std[:, None, None]
    out[name] = (x.float() - mean) / std
  return out


def stack(fields: dict, static) -> torch.Tensor:
  """name → [B, T, (L,) lat, lon] (or [lat, lon] for statics) →
  [G, B, channels], variables in name order, time then level flattened."""
  B = next(x.shape[0] for n, x in fields.items() if n not in static)
  parts = []
  for name in sorted(fields):
    x = fields[name]
    if name in static:
      x = x[None, None].expand(B, 1, *x.shape)
    parts.append(x.reshape(B, -1, x.shape[-2] * x.shape[-1]).permute(2, 0, 1))
  return torch.cat(parts, -1)


def unstack(cfg, out: torch.Tensor, num_lat: int, num_lon: int) -> dict:
  """[G, B, outputs] → name → [B, 1, (L,) lat, lon], in name order."""
  res, c = {}, 0
  B = out.shape[1]
  for name in sorted(cfg["target_variables"]):
    w = width(cfg, name)
    x = out[..., c:c + w].permute(1, 2, 0).reshape(B, 1, w, num_lat, num_lon)
    res[name] = x if is_atmospheric(cfg, name) else x[:, :, 0]
    c += w
  return res


def denoise(cfg, p, graph, norm_inputs: dict, norm_forcings: dict,
            x: dict, sigma: torch.Tensor, q) -> dict:
  """D(x; σ) = c_skip·x + c_out·F(c_in·x; σ), on normalised fields."""
  c_in = (sigma ** 2 + 1) ** -0.5
  c_out = sigma * c_in
  c_skip = 1 / (sigma ** 2 + 1)
  scaled = {n: v * c_in for n, v in x.items()}
  grid_in = torch.cat([stack(norm_inputs, cfg["static_variables"]),
                       stack({**norm_forcings, **scaled}, ())], -1)
  cond = noise_encoding(cfg, p, sigma.reshape(1).expand(grid_in.shape[1]), q)
  raw = unstack(cfg, network(cfg, p, graph, grid_in, cond, q),
                graph.num_lat, graph.num_lon)
  return {n: c_out * raw[n] + c_skip * x[n] for n in x}


def sample(cfg, p, graph, stats, inputs: dict, forcings: dict,
           noise: NoiseStream, q) -> dict:
  """One member's 12 h sample in normalised residual form, name → [1, 1,
  (L,) lat, lon]: the sampler's state at σ = 0. ``inputs``: raw input
  frames (batch 1) and statics; ``forcings``: the step's raw forcings."""
  sigmas, churn = schedule(cfg)
  s = cfg["sampler"]
  device = graph.grid_features.device
  sig = lambda v: torch.tensor(float(v), dtype=torch.float32, device=device)  # noqa: E731
  norm_inputs = normalize(cfg, inputs, stats)
  norm_forcings = normalize(cfg, forcings, stats)

  def D(x, sigma):
    return denoise(cfg, p, graph, norm_inputs, norm_forcings, x, sigma, q)

  x = {n: v * sig(sigmas[0]) for n, v in noise.draw().items()}
  for i in range(len(sigmas) - 1):
    sigma = sig(sigmas[i])
    if churn[i] > 0:
      new = sigma * (1.0 + float(churn[i]))
      extra = torch.sqrt(torch.clamp(new ** 2 - sigma ** 2, min=0.0)) * s[
          "noise_level_inflation_factor"]
      x = {n: x[n] + v * extra for n, v in noise.draw().items()}
      sigma = new
    nxt = sig(sigmas[i + 1])
    denoised = D(x, sigma)
    if sigmas[i + 1] == 0:
      return denoised
    mid = torch.sqrt(sigma * nxt)
    r = mid / sigma
    x_mid = {n: x[n] * r + denoised[n] * (1 - r) for n in x}
    mid_denoised = D(x_mid, mid)
    r = nxt / sigma
    x = {n: x[n] * r + mid_denoised[n] * (1 - r) for n in x}
  return x


def to_normalized_target(cfg, stats, name: str, prediction, last_input):
  """A raw prediction in the sampler's space: (prediction - last input) /
  diffs stddev for a variable that is an input, (prediction - mean) /
  stddev for one that is not."""
  def per_level(t):
    return t[:, None, None] if is_atmospheric(cfg, name) else t
  if name in cfg["input_variables"]:
    return (prediction.float() - last_input.float()) / per_level(
        stats["diffs_stddev"][name])
  return (prediction.float() - per_level(stats["mean"][name])) / per_level(
      stats["stddev"][name])
