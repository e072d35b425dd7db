"""Linear / MLP / LayerNorm modules with f32 masters cast at use.

Port of graphcast_tpu/nn/core.py. Parameters are stored the way the JAX
package stores them — ``w`` as [in, out], ``b``, LayerNorm ``scale`` and
``offset`` — so a module's flat parameter names, with "/" for ".", are the
JAX package's flat param keys (tests/goldens/zoo_param_shapes.json) and
weights cross between the packages without transposes.

Parameters always live in float32; ``forward`` casts them to the activation
dtype at use (the precision policy of docs/ARCHITECTURE.md §4). Every MLP
of GraphCast uses swish, so that is the only activation here.

Random init draws what the JAX package draws (nn/core.py:43): a normal
truncated to [-2, 2], scaled by 1/sqrt(fan_in) with no variance
correction; biases and offsets 0, scales 1. It takes an explicit CPU
``torch.Generator``: initialise on the CPU, then move the module.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


class Linear(nn.Module):
  """y = x @ w + b, weights [in, out]."""

  def __init__(self, in_size: int, out_size: int):
    super().__init__()
    self.in_size = in_size
    self.out_size = out_size
    self.w = nn.Parameter(torch.empty(in_size, out_size))
    self.b = nn.Parameter(torch.zeros(out_size))

  @torch.no_grad()
  def reset_parameters(self, generator: torch.Generator):
    stddev = 1.0 / math.sqrt(max(self.in_size, 1))
    nn.init.trunc_normal_(self.w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    self.w.mul_(stddev)
    self.b.zero_()

  def forward(self, x):
    return x @ self.w.to(x.dtype) + self.b.to(x.dtype)


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
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + self.eps)).to(dtype)
    return y * self.scale.to(dtype) + self.offset.to(dtype)


class MLPWithNorm(nn.Module):
  """MLP → optional LayerNorm (reference: deep_typed_graph_net.py:212-248).

  Inputs passed as several tensors are concatenated on the last axis.
  """

  def __init__(self, in_size: int, hidden_size: int, num_hidden_layers: int,
               out_size: int, use_layer_norm: bool = True):
    super().__init__()
    self.mlp = MLP(in_size, hidden_size, num_hidden_layers, out_size)
    self.layer_norm = LayerNorm(out_size) if use_layer_norm else None

  def forward(self, *inputs):
    x = inputs[0] if len(inputs) == 1 else torch.cat(inputs, dim=-1)
    x = self.mlp(x)
    if self.layer_norm is not None:
      x = self.layer_norm(x)
    return x

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
