"""Sparse transformer over mesh nodes, norm-conditioned on the noise level.

Port of graphcast_tpu/models/sparse_transformer.py (reference:
sparse_transformer.py): pre-LN blocks whose attention mask is the mesh
adjacency (with self loops) raised to the k-th boolean power. Two attention
backends are ported:

- "splash_mha": block-sparse attention through ops/splash.py (K6 on the
  card, its plain version on the CPU);
- "mha": dense O(N²) masked attention, for small meshes and tests.

"triblockdiag_mha" is not ported yet and raises NotImplementedError.

Logits and softmax are taken in float32 whatever the activation dtype.
Parameters are created at construction; the mask, which needs the mesh,
is built by ``prepare_mask`` (once, on the host) before the first call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from graphcast_tpu_torch.nn import core
from graphcast_tpu_torch.ops import splash

# Stddev of a standard normal truncated to [-2, 2] (graphcast_tpu/nn/
# core.py): VarianceScaling divides by it so the sample stddev hits its
# target.
TRUNCATED_NORMAL_STDDEV_FACTOR = 0.87962566103423978


@dataclasses.dataclass(frozen=True, eq=True)
class SparseTransformerConfig:
  """The fields of graphcast_tpu's SparseTransformerConfig (reference:
  denoiser.py:124-154) that the port reads. The JAX config's other block_*
  fields and mask_type tile the TPU kernel; the port's kernel tiles at
  ops/splash.TILE and has no counterpart for them. ``block_q`` is the patch
  size of the mesh order: ``node_ordering`` "patch" (BFS patches of block_q
  nodes) or "rcm"."""
  attention_k_hop: int
  d_model: int
  num_layers: int = 16
  num_heads: int = 4
  attention_type: str = "splash_mha"
  block_q: int = 512
  ffw_winit_mult: float = 2.0
  ffw_winit_final_mult: float = 0.0
  attn_winit_mult: float = 2.0
  attn_winit_final_mult: float = 0.0
  ffw_hidden: int = 2048
  activation: str = "gelu"
  node_ordering: str = "patch"

  @property
  def key_size(self) -> int:
    if self.d_model % self.num_heads:
      raise ValueError("num_heads must divide d_model")
    return self.d_model // self.num_heads

  @property
  def value_size(self) -> int:
    return self.key_size


def k_hop_adjacency_from_matrix(adjacency: sp.spmatrix,
                                k_hop: int) -> sp.csr_matrix:
  """adjacency (+I) raised to the k-th boolean power."""
  n = adjacency.shape[0]
  adj = (adjacency + sp.identity(n, dtype=bool, format="csr")).astype(bool)
  out = adj.copy()
  for _ in range(k_hop - 1):
    out = ((out @ adj) != 0).astype(bool)
  return out.tocsr()


def _variance_scaling_stddev(scale: float, fan_in: int) -> float:
  """hk.initializers.VarianceScaling(scale) with a truncated normal: the
  sample stddev is sqrt(scale / fan_in)."""
  return (math.sqrt(max(scale, 1e-30) / max(fan_in, 1))
          / TRUNCATED_NORMAL_STDDEV_FACTOR)


def _mh_linear(layer: core.Linear, x, num_heads: int, head_size: int):
  """[..., d] → [..., heads, head_size], no bias."""
  out = layer(x)
  return out.reshape(out.shape[:-1] + (num_heads, head_size))


def dense_mha(block: nn.ModuleDict, cfg: SparseTransformerConfig, x,
              mask: torch.Tensor):
  """O(N²) masked attention; logits and softmax in f32 (reference:
  sparse_transformer.py:209-242). x: [batch, n, d]; mask [n, n] bool."""
  q = _mh_linear(block["mha_proj_q"], x, cfg.num_heads, cfg.key_size)
  k = _mh_linear(block["mha_proj_k"], x, cfg.num_heads, cfg.key_size)
  v = _mh_linear(block["mha_proj_v"], x, cfg.num_heads, cfg.value_size)
  logits = torch.einsum("bthd,bThd->bhtT", q.float(), k.float())
  logits = logits * (cfg.key_size ** -0.5)
  logits = torch.where(mask, logits, torch.full_like(logits, splash.NEG_INF))
  weights = torch.softmax(logits, dim=-1).to(x.dtype)
  out = torch.einsum("bhtT,bThd->bthd", weights.float(), v.float()).to(
      x.dtype)
  return block["mha_final"](out.reshape(out.shape[:-2] + (-1,)))


class Transformer(nn.Module):
  """Pre-LN transformer blocks ``block_00`` … and ``final_norm_conditioning``,
  named as the JAX package's flat param keys.

  Each block holds two unshared norm conditionings (``norm_conditioning``
  before attention, ``norm_conditioning_1`` before the feed-forward), as
  Haiku names them (sparse_transformer.py:459-477).
  """

  def __init__(self, cfg: SparseTransformerConfig, cond_size: int):
    super().__init__()
    if cfg.attention_type not in ("mha", "splash_mha", "triblockdiag_mha"):
      raise ValueError(f"unknown attention_type {cfg.attention_type}")
    self.cfg = cfg
    qk_out = cfg.num_heads * cfg.key_size
    v_out = cfg.num_heads * cfg.value_size
    layers = cfg.num_layers
    attn_std = _variance_scaling_stddev(cfg.attn_winit_mult / layers,
                                        cfg.d_model)
    attn_final_std = _variance_scaling_stddev(
        cfg.attn_winit_final_mult / layers, v_out)
    ffw_std = _variance_scaling_stddev(cfg.ffw_winit_mult / layers,
                                       cfg.d_model)
    ffw_final_std = _variance_scaling_stddev(
        cfg.ffw_winit_final_mult / layers, cfg.ffw_hidden)
    for i in range(layers):
      self.add_module(f"block_{i:02d}", nn.ModuleDict({
          "mha_proj_q": core.Linear(cfg.d_model, qk_out, with_bias=False,
                                    init_stddev=attn_std),
          "mha_proj_k": core.Linear(cfg.d_model, qk_out, with_bias=False,
                                    init_stddev=attn_std),
          "mha_proj_v": core.Linear(cfg.d_model, v_out, with_bias=False,
                                    init_stddev=attn_std),
          "mha_final": core.Linear(v_out, cfg.d_model,
                                   init_stddev=attn_final_std),
          "ffw_up": core.Linear(cfg.d_model, cfg.ffw_hidden,
                                init_stddev=ffw_std),
          "ffw_down": core.Linear(cfg.ffw_hidden, cfg.d_model,
                                  init_stddev=ffw_final_std),
          "norm_conditioning": core.NormConditioning(cond_size, cfg.d_model),
          "norm_conditioning_1": core.NormConditioning(cond_size,
                                                       cfg.d_model),
      }))
    self.final_norm_conditioning = core.NormConditioning(cond_size,
                                                         cfg.d_model)
    self._dense_mask: Optional[np.ndarray] = None
    self._dense_masks: dict = {}
    self._block_map: Optional[splash.BlockMap] = None

  def prepare_mask(self, adjacency: sp.spmatrix):
    """Builds the k-hop attention mask for the chosen backend (host)."""
    cfg = self.cfg
    if cfg.attention_type == "triblockdiag_mha":
      raise NotImplementedError("triblockdiag_mha is not ported")
    mask = k_hop_adjacency_from_matrix(adjacency, cfg.attention_k_hop)
    if cfg.attention_type == "mha":
      self._dense_mask = mask.toarray()
    else:
      self._block_map = splash.build_block_map(mask)

  def _attend(self, block, x):
    cfg = self.cfg
    if cfg.attention_type == "mha":
      key = str(x.device)
      if key not in self._dense_masks:
        self._dense_masks[key] = torch.as_tensor(self._dense_mask,
                                                 device=x.device)
      return dense_mha(block, cfg, x, self._dense_masks[key])
    q = _mh_linear(block["mha_proj_q"], x, cfg.num_heads, cfg.key_size)
    k = _mh_linear(block["mha_proj_k"], x, cfg.num_heads, cfg.key_size)
    v = _mh_linear(block["mha_proj_v"], x, cfg.num_heads, cfg.value_size)
    out, _ = splash.block_sparse_attention(q, k, v, self._block_map,
                                           cfg.key_size ** -0.5)
    return block["mha_final"](out.reshape(out.shape[:-2] + (-1,)))

  def _ffw(self, block, x):
    act = core.ACTIVATIONS[self.cfg.activation]
    return block["ffw_down"](act(block["ffw_up"](x)))

  def forward(self, x, global_norm_conditioning):
    """x: [batch, nodes, d_model]; conditioning: [batch, cond]."""
    if self._dense_mask is None and self._block_map is None:
      raise RuntimeError("call prepare_mask before the first forward")
    cond = global_norm_conditioning[:, None]  # [batch, 1, cond]
    ln = core.layer_norm_no_params
    for i in range(self.cfg.num_layers):
      block = getattr(self, f"block_{i:02d}")
      h = block["norm_conditioning"](ln(x), cond)
      x = x + self._attend(block, h)
      h = block["norm_conditioning_1"](ln(x), cond)
      x = x + self._ffw(block, h)
    return self.final_norm_conditioning(ln(x), cond)
