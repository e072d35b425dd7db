"""Linear / MLP / LayerNorm modules with f32 masters cast at use.

Port of graphcast_tpu/nn/core.py. Parameters are stored the way the JAX
package stores them — ``w`` as [in, out], ``b``, LayerNorm ``scale`` and
``offset`` — so a module's flat parameter names, with "/" for ".", are the
JAX package's flat param keys (tests/goldens/zoo_param_shapes.json) and
weights cross between the packages without transposes.

Parameters always live in float32; ``forward`` casts them to the activation
dtype at use (the precision policy of docs/ARCHITECTURE.md §4). MLPs take
their activation by name, as the JAX package's ``get_activation`` does
(nn/core.py:26-34 there): "identity" or a jax.nn name, with jax.nn's
semantics (``ACTIVATIONS``). The models' graph nets use swish; GenCast's
transformer and noise encoder use GELU in its tanh form (``gelu``), which is
jax.nn.gelu's default.

Random init draws what the JAX package draws (nn/core.py:43): a normal
truncated to [-2, 2], scaled by 1/sqrt(fan_in) (or a given stddev) with no
variance correction; biases and offsets 0, scales 1. It takes an explicit
CPU ``torch.Generator``: initialise on the CPU, then move the module.

A Linear split over ranks (parallel/sharding.py
``shard_params_tensor_parallel``, sequence parallelism) carries a
``parallel`` (parallel/collectives.py ``LinearSharding``): its forward runs
the split product with its collectives, and ``full_w``/``full_b`` give the
whole weight and bias, which the fused kernels' callers read.

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

from graphcast_tpu_torch.ops.gather import gather_rows


def gelu(x):
  """GELU, tanh approximation (jax.nn.gelu's default; F.gelu's default is
  the exact erf form)."""
  return F.gelu(x, approximate="tanh")


def softplus(x):
  """log(1 + exp(x)) as jax.nn.softplus computes it, logaddexp(x, 0)
  (F.softplus returns x itself above a threshold)."""
  return torch.logaddexp(x, torch.zeros_like(x))


# The jax.nn activations a graph net can take, by their jax.nn names, each
# with jax.nn's default constants (elu and celu alpha 1, leaky_relu slope
# 0.01, gelu its tanh form).
ACTIVATIONS = {
    "identity": lambda x: x,
    "relu": F.relu,
    "relu6": F.relu6,
    "swish": F.silu,
    "silu": F.silu,
    "gelu": gelu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": softplus,
    "elu": F.elu,
    "leaky_relu": F.leaky_relu,
    "celu": F.celu,
    "selu": F.selu,
    "soft_sign": F.softsign,
    "log_sigmoid": F.logsigmoid,
    "hard_tanh": F.hardtanh,
    "hard_sigmoid": F.hardsigmoid,
    "hard_swish": F.hardswish,
    "hard_silu": F.hardswish,
    "mish": F.mish,
}


def get_activation(name: str):
  """The activation of a jax.nn name (``ACTIVATIONS``); an unknown name
  raises ValueError, as graphcast_tpu nn/core.py ``get_activation``."""
  if name not in ACTIVATIONS:
    raise ValueError(f"unknown activation {name!r}")
  return ACTIVATIONS[name]


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
    self.parallel = None  # a parallel.collectives.LinearSharding

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
    if self.parallel is not None:
      return self.parallel.forward(self, x)
    y = x @ self.w.to(x.dtype)
    return y if self.b is None else y + self.b.to(x.dtype)

  @property
  def full_w(self):
    """The whole weight [in, out] (gathered where it is split)."""
    return self.w if self.parallel is None else self.parallel.full(self, "w")

  @property
  def full_b(self):
    """The whole bias [out] or None (gathered where it is split)."""
    return self.b if self.parallel is None else self.parallel.full(self, "b")


class MLP(nn.ModuleDict):
  """MLP with ``num_hidden_layers`` hidden layers and layers named like
  Haiku's hk.nets.MLP: linear_0, ...; ``activation`` a jax.nn name,
  applied after every layer but the last."""

  def __init__(self, in_size: int, hidden_size: int, num_hidden_layers: int,
               out_size: int, activation: str = "swish"):
    sizes = [in_size] + [hidden_size] * num_hidden_layers + [out_size]
    super().__init__({f"linear_{i}": Linear(a, b)
                      for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))})
    get_activation(activation)  # an unknown name raises here
    self.activation = activation

  def forward(self, x):
    x = self["linear_0"](x)
    return self.tail(x)

  def tail(self, x):
    """The layers after the first, on the first layer's output (before its
    activation)."""
    act = get_activation(self.activation)
    for layer in list(self.values())[1:]:
      x = layer(act(x))
    return x


def layer_norm_no_params(x):
  """The parameter-free LayerNorm: statistics in float32, eps 1e-5, the
  normalised value rounded to x's dtype. One ``F.layer_norm`` pass, which
  keeps the float32 work in registers: over [1M grid nodes, 8 members,
  512] an f32 copy of x alone would take 17 GB."""
  return F.layer_norm(x, x.shape[-1:], eps=LayerNorm.eps)


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
  deep_typed_graph_net.py:212-248); ``activation`` a jax.nn name.

  Inputs passed as several tensors are concatenated on the last axis.
  With ``norm_conditioning_size`` the LayerNorm is parameter-free and a
  ``NormConditioning`` on the conditioning vector ``cond`` follows it.
  """

  def __init__(self, in_size: int, hidden_size: int, num_hidden_layers: int,
               out_size: int, use_layer_norm: bool = True,
               norm_conditioning_size: int | None = None,
               activation: str = "swish"):
    super().__init__()
    if norm_conditioning_size and not use_layer_norm:
      raise ValueError("norm conditioning requires layer norm")
    self.mlp = MLP(in_size, hidden_size, num_hidden_layers, out_size,
                   activation)
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
    norm, all in edge_feats' dtype. Node arrays are [nodes, ...]; indices
    int32 [edges], or ops.gather.RowGathers of them (fixed-order backward
    sums)."""
    dtype = edge_feats.dtype
    lin = self.mlp["linear_0"]
    w, b0 = lin.w, lin.b
    if lin.parallel is not None:  # a column split: this rank's hidden units
      w, b0 = lin.parallel.params(lin)
      edge_feats, sender_full, receiver_full = (
          lin.parallel.enter(t) for t in (edge_feats, sender_full,
                                          receiver_full))
    we, ws, wr = _split_rows(w.to(dtype), edge_feats.shape[-1],
                             sender_full.shape[-1])
    x = (edge_feats @ we
         + gather_rows(sender_full @ ws, senders)
         + gather_rows(receiver_full @ wr, receivers)
         + b0.to(dtype))
    return self._norm(self.mlp.tail(x), cond)

  def factored_first_layer(self, edge_size: int, sender_size: int, dtype):
    """(We, Ws, Wr, b0) of the whole first linear layer, cast to ``dtype``.

    The factored edge update (graphcast_tpu nn/core.py:237):
    W·concat(e, n_s, n_r) = We·e + (Ws·N)[senders] + (Wr·N)[receivers], so
    node projections are computed once per node, not once per edge; the
    kernels in ops/ do the gathers."""
    lin = self.mlp["linear_0"]
    return (*_split_rows(lin.full_w.to(dtype), edge_size, sender_size),
            lin.full_b)


def _split_rows(w, edge_size: int, sender_size: int):
  """(We, Ws, Wr): the first layer's rows for the edge, sender and
  receiver features."""
  return (w[:edge_size], w[edge_size:edge_size + sender_size],
          w[edge_size + sender_size:])


def reset_parameters(module: nn.Module, generator: torch.Generator):
  """Re-draws every parameter of ``module`` in a fixed (sorted-name) order."""
  subs = dict(module.named_modules())
  for name in sorted(subs):
    if isinstance(subs[name], (Linear, LayerNorm)):
      subs[name].reset_parameters(generator)
