"""Linear / MLP / LayerNorm modules with f32 masters cast at use.

Port of graphcast_tpu/nn/core.py. Parameters are stored the way the JAX
package stores them — ``w`` as [in, out], ``b``, LayerNorm ``scale`` and
``offset`` — so a module's flat parameter names, with "/" for ".", are the
JAX package's flat param keys (tests/goldens/zoo_param_shapes.json) and
weights cross between the packages without transposes.

Parameters always live in float32; ``forward`` casts them to the activation
dtype at use (the precision policy of docs/ARCHITECTURE.md §4). The graph
nets use swish; GenCast's transformer and noise encoder use GELU in its
tanh form (``gelu``), which is jax.nn.gelu's default.

Random init draws what the JAX package draws (nn/core.py:43): a normal
truncated to [-2, 2], scaled by 1/sqrt(fan_in) (or a given stddev) with no
variance correction; biases and offsets 0, scales 1. It takes an explicit
CPU ``torch.Generator``: initialise on the CPU, then move the module.

Under GenCast's norm conditioning (``MLPWithNorm(use_norm_conditioning=
True)``) the LayerNorm has no parameters and a ``NormConditioning`` maps the
conditioning vector to a per-channel (scale - 1, offset) instead
(graphcast_tpu/nn/core.py:149-263).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


def gelu(x):
  """GELU, tanh approximation (jax.nn.gelu's default; F.gelu's default is
  the exact erf form)."""
  return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"swish": F.silu, "gelu": gelu}


class Linear(nn.Module):
  """y = x @ w (+ b), weights [in, out]; init stddev 1/sqrt(in) unless
  ``init_stddev`` is given."""

  def __init__(self, in_size: int, out_size: int, with_bias: bool = True,
               init_stddev: float | None = None):
    super().__init__()
    self.in_size = in_size
    self.out_size = out_size
    self.init_stddev = init_stddev
    self.w = nn.Parameter(torch.empty(in_size, out_size))
    self.b = nn.Parameter(torch.zeros(out_size)) if with_bias else None

  @torch.no_grad()
  def reset_parameters(self, generator: torch.Generator):
    stddev = self.init_stddev
    if stddev is None:
      stddev = 1.0 / math.sqrt(max(self.in_size, 1))
    nn.init.trunc_normal_(self.w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    self.w.mul_(stddev)
    if self.b is not None:
      self.b.zero_()

  def forward(self, x):
    y = x @ self.w.to(x.dtype)
    return y if self.b is None else y + self.b.to(x.dtype)


class MLP(nn.ModuleDict):
  """Swish MLP with layers named like Haiku's hk.nets.MLP: linear_0, ..."""

  def __init__(self, in_size: int, hidden_size: int, num_hidden_layers: int,
               out_size: int):
    sizes = [in_size] + [hidden_size] * num_hidden_layers + [out_size]
    super().__init__({f"linear_{i}": Linear(a, b)
                      for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))})

  def forward(self, x):
    layers = list(self.values())
    for i, layer in enumerate(layers):
      x = layer(x)
      if i + 1 < len(layers):
        x = F.silu(x)
    return x


def layer_norm_no_params(x):
  """The parameter-free LayerNorm: statistics in float32, eps 1e-5, the
  normalised value rounded to x's dtype."""
  x32 = x.float()
  mean = x32.mean(-1, keepdim=True)
  var = (x32 - mean).square().mean(-1, keepdim=True)
  return ((x32 - mean) * torch.rsqrt(var + LayerNorm.eps)).to(x.dtype)


class LayerNorm(nn.Module):
  """LayerNorm over the last axis; statistics in float32, eps 1e-5."""

  eps = 1e-5

  def __init__(self, size: int):
    super().__init__()
    self.scale = nn.Parameter(torch.ones(size))
    self.offset = nn.Parameter(torch.zeros(size))

  @torch.no_grad()
  def reset_parameters(self, generator: torch.Generator):
    del generator
    self.scale.fill_(1.0)
    self.offset.zero_()

  def forward(self, x):
    dtype = x.dtype
    return (layer_norm_no_params(x) * self.scale.to(dtype)
            + self.offset.to(dtype))


class NormConditioning(Linear):
  """Conditioning vector → per-channel (scale - 1, offset), applied after a
  parameter-free LayerNorm; init stddev 1e-8, so training starts at the
  identity (graphcast_tpu/nn/core.py:149-168)."""

  def __init__(self, cond_size: int, feature_size: int):
    super().__init__(cond_size, 2 * feature_size, init_stddev=1e-8)

  def scale_offset(self, cond, dtype):
    """(scale, offset) vectors for one conditioning row cond [1, K], in
    ``dtype``: what the fused kernels take in place of LayerNorm params."""
    co = super().forward(cond.to(dtype))
    c = co.shape[-1] // 2
    return co[0, :c] + 1.0, co[0, c:]

  def forward(self, x, cond):
    """x: [..., feature]; cond: broadcastable [..., cond_size]."""
    scale_minus_one, offset = super().forward(cond.to(x.dtype)).chunk(2, -1)
    return x * (scale_minus_one + 1.0) + offset


class MLPWithNorm(nn.Module):
  """MLP → optional LayerNorm → optional norm conditioning (reference:
  deep_typed_graph_net.py:212-248).

  Inputs passed as several tensors are concatenated on the last axis.
  With ``norm_conditioning_size`` the LayerNorm is parameter-free and a
  ``NormConditioning`` on the conditioning vector ``cond`` follows it.
  """

  def __init__(self, in_size: int, hidden_size: int, num_hidden_layers: int,
               out_size: int, use_layer_norm: bool = True,
               norm_conditioning_size: int | None = None):
    super().__init__()
    if norm_conditioning_size and not use_layer_norm:
      raise ValueError("norm conditioning requires layer norm")
    self.mlp = MLP(in_size, hidden_size, num_hidden_layers, out_size)
    self.layer_norm = (LayerNorm(out_size)
                       if use_layer_norm and not norm_conditioning_size
                       else None)
    self.norm_conditioning = (NormConditioning(norm_conditioning_size,
                                               out_size)
                              if norm_conditioning_size else None)

  def forward(self, *inputs, cond=None):
    x = inputs[0] if len(inputs) == 1 else torch.cat(inputs, dim=-1)
    return self._norm(self.mlp(x), cond)

  def _norm(self, x, cond):
    if (cond is None) != (self.norm_conditioning is None):
      raise ValueError("pass cond exactly when norm conditioning is on")
    if self.norm_conditioning is not None:
      return self.norm_conditioning(layer_norm_no_params(x), cond)
    if self.layer_norm is not None:
      x = self.layer_norm(x)
    return x

  def factored_edge_update(self, edge_feats, sender_full, receiver_full,
                           senders, receivers, cond=None):
    """The edge update with the first layer factored (graphcast_tpu nn/
    core.py:237-263): edge_feats @ We + (sender_full @ Ws)[senders] +
    (receiver_full @ Wr)[receivers] + b0, then the remaining layers and the
    norm, all in edge_feats' dtype. Node arrays are [nodes, ...], indices
    int32 [edges]."""
    dtype = edge_feats.dtype
    we, ws, wr, b0 = self.factored_first_layer(edge_feats.shape[-1],
                                               sender_full.shape[-1], dtype)
    x = (edge_feats @ we
         + (sender_full @ ws).index_select(0, senders)
         + (receiver_full @ wr).index_select(0, receivers)
         + b0.to(dtype))
    for layer in list(self.mlp.values())[1:]:
      x = layer(F.silu(x))
    return self._norm(x, cond)

  def factored_first_layer(self, edge_size: int, sender_size: int, dtype):
    """(We, Ws, Wr, b0) of the first linear layer, cast to ``dtype``.

    The factored edge update (graphcast_tpu nn/core.py:237):
    W·concat(e, n_s, n_r) = We·e + (Ws·N)[senders] + (Wr·N)[receivers], so
    node projections are computed once per node, not once per edge; the
    kernels in ops/ do the gathers."""
    lin = self.mlp["linear_0"]
    w = lin.w.to(dtype)
    return (w[:edge_size], w[edge_size:edge_size + sender_size],
            w[edge_size + sender_size:], lin.b)


def reset_parameters(module: nn.Module, generator: torch.Generator):
  """Re-draws every parameter of ``module`` in a fixed (sorted-name) order."""
  subs = dict(module.named_modules())
  for name in sorted(subs):
    if isinstance(subs[name], (Linear, LayerNorm)):
      subs[name].reset_parameters(generator)
