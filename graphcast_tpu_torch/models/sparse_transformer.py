"""Sparse transformer over mesh nodes, norm-conditioned on the noise level.

Port of graphcast_tpu/models/sparse_transformer.py (reference:
sparse_transformer.py): pre-LN blocks whose attention mask is the mesh
adjacency (with self loops) raised to the k-th boolean power. Three
attention backends, as in the JAX package:

- "splash_mha": block-sparse attention through ops/splash.py (K6 on the
  card, its plain version on the CPU);
- "triblockdiag_mha": banded dense attention over the diagonal, upper and
  lower blocks of the banded (RCM- or patch-permuted) mesh, one streaming
  softmax across the three. Plain torch with autograd, as it is plain XLA
  in the JAX package;
- "mha": dense O(N²) masked attention, for small meshes and tests.

Logits and softmax are taken in float32 whatever the activation dtype.
Parameters are created at construction; the mask, which needs the mesh,
is built by ``prepare_mask`` (once, on the host) before the first call,
and shared by every transformer of the process with the same adjacency,
k-hop and backend (``prepared_mask``; at mesh-6 the k-hop-16 mask and its
block map take tens of seconds to build).

``enable_sequence_parallel(mesh, axis)`` (the JAX package's, :341-350;
splash only) splits the node axis over a mesh axis: each rank runs the
per-node LayerNorms, conditioning and feed-forward on its own rows, and
the attention on its q rows against k and v gathered from every rank
(ops/splash.py ``SequenceParallelAttention``); the output is gathered
whole. Each rank's parameter and conditioning gradients are then its
rows' part, summed over the axis in the backward
(parallel/collectives.py).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import math
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from graphcast_tpu_torch.nn import core
from graphcast_tpu_torch.ops import splash
from graphcast_tpu_torch.parallel import collectives

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


def mask_bandwidth(mask: sp.spmatrix) -> int:
  """Max |i−j| over nonzeros (assumes a banded, permuted mask)."""
  coo = mask.tocoo()
  if coo.nnz == 0:
    return 0
  return int(np.abs(coo.row.astype(np.int64) - coo.col).max())


def get_mask_block_size(mask: sp.spmatrix) -> int:
  """Block size such that all mask entries fall within the tri-block
  diagonals (reference: sparse_transformer.py:92-103)."""
  return mask_bandwidth(mask) + 1


def build_triblock_masks(mask: sp.spmatrix, block_size: int
                         ) -> tuple[np.ndarray, int]:
  """Returns ([3, num_blocks, block, block] bool (diag, upper, lower),
  num_padding_nodes), scattered straight from the nonzeros in O(nnz) host
  memory (graphcast_tpu/models/sparse_transformer.py:124)."""
  n = mask.shape[0]
  padded = int(np.ceil(n / block_size) * block_size)
  num_padding = padded - n
  num_blocks = padded // block_size
  coo = mask.tocoo()
  keep = coo.data.astype(bool)
  rows = coo.row[keep].astype(np.int64)
  cols = coo.col[keep].astype(np.int64)
  qb = rows // block_size
  kb = cols // block_size
  diff = kb - qb
  if diff.size and int(np.abs(diff).max()) > 1:
    raise ValueError("mask has entries outside the tri-block band; "
                     "increase block_size")
  out = np.zeros((3, num_blocks, block_size, block_size), dtype=bool)
  # Band index: 0 = diag (kb == qb), 1 = upper (kb == qb+1), 2 = lower.
  band = np.where(diff == 0, 0, np.where(diff == 1, 1, 2))
  out[band, qb, rows % block_size, cols % block_size] = True
  return out, num_padding


MASK_CACHE_SIZE = 4
_MASKS: collections.OrderedDict = collections.OrderedDict()


def prepared_mask(adjacency: sp.spmatrix, k_hop: int,
                  attention_type: str) -> dict:
  """The k-hop attention mask of ``adjacency`` in the form the backend
  reads, built once per process for each adjacency (by content), k-hop
  and backend (the last ``MASK_CACHE_SIZE`` kept): {"num_nodes", and
  "dense" [n, n] bool (mha); "triblock" [3, blocks, block, block] bool,
  "block_size", "num_padding" (triblockdiag_mha); "block_map"
  (splash_mha)}. Shared read-only."""
  adj = sp.csr_matrix(adjacency, dtype=bool, copy=True)
  adj.sum_duplicates()
  adj.sort_indices()
  digest = hashlib.sha256(adj.indptr.tobytes() + adj.indices.tobytes())
  key = (adj.shape, digest.hexdigest(), k_hop, attention_type)
  if key in _MASKS:
    _MASKS.move_to_end(key)
    return _MASKS[key]
  mask = k_hop_adjacency_from_matrix(adjacency, k_hop)
  out = {"num_nodes": mask.shape[0]}
  if attention_type == "mha":
    out["dense"] = mask.toarray()
  elif attention_type == "triblockdiag_mha":
    out["block_size"] = get_mask_block_size(mask)
    out["triblock"], out["num_padding"] = build_triblock_masks(
        mask, out["block_size"])
  else:
    out["block_map"] = splash.build_block_map(mask)
  _MASKS[key] = out
  while len(_MASKS) > MASK_CACHE_SIZE:
    _MASKS.popitem(last=False)
  return out


def _variance_scaling_stddev(scale: float, fan_in: int) -> float:
  """hk.initializers.VarianceScaling(scale) with a truncated normal: the
  sample stddev is sqrt(scale / fan_in)."""
  return (math.sqrt(max(scale, 1e-30) / max(fan_in, 1))
          / TRUNCATED_NORMAL_STDDEV_FACTOR)


def _mh_linear(layer: core.Linear, x, num_heads: int, head_size: int):
  """[..., d] → [..., heads, head_size], no bias. A column-split layer
  (tensor parallelism) yields its rank's share of the ``num_heads``."""
  out = layer(x)
  if out.shape[-1] % head_size:
    raise ValueError(f"{out.shape[-1]} projection columns on this rank do "
                     f"not hold whole heads of {head_size} ({num_heads} "
                     "heads in all): split the heads evenly over the model "
                     "axis")
  return out.reshape(out.shape[:-1] + (out.shape[-1] // head_size, head_size))


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
  return block["mha_final"](out.flatten(-2))


def triblockdiag_mha(block: nn.ModuleDict, cfg: SparseTransformerConfig, x,
                     masks: torch.Tensor, num_nodes: int, num_padding: int,
                     block_size: int):
  """Banded attention over the (diag, upper, lower) blocks with one
  streaming softmax across the three, logits and softmax in f32
  (graphcast_tpu/models/sparse_transformer.py:184-240; reference:
  sparse_transformer.py:116-189). x: [batch, num_nodes, d]; masks: [3,
  num_blocks, block, block] bool. The running maximum is held constant
  under autograd, as the JAX package's stop_gradient does."""
  b = x.shape[0]
  x = torch.nn.functional.pad(x, (0, 0, 0, num_padding))
  num_blocks = x.shape[1] // block_size
  xb = x.reshape(b, num_blocks, block_size, x.shape[-1])

  q = _mh_linear(block["mha_proj_q"], xb, cfg.num_heads, cfg.key_size)
  k = _mh_linear(block["mha_proj_k"], xb, cfg.num_heads, cfg.key_size)
  v = _mh_linear(block["mha_proj_v"], xb, cfg.num_heads, cfg.value_size)

  # One zero block before the first and after the last.
  k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, 0, 1, 1))
  v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 0, 1, 1))

  scale = cfg.key_size ** -0.5
  qf = q.float()

  def logits(keys, band_mask):
    out = torch.einsum("bnqhd,bnkhd->bnhqk", qf, keys.float()) * scale
    return out.masked_fill(~band_mask[None, :, None], splash.NEG_INF)

  logits_d = logits(k[:, 1:-1], masks[0])
  logits_u = logits(k[:, 2:], masks[1])
  logits_l = logits(k[:, :-2], masks[2])

  m = torch.maximum(torch.maximum(
      logits_d.detach().amax(-1, keepdim=True),
      logits_u.detach().amax(-1, keepdim=True)),
      logits_l.detach().amax(-1, keepdim=True))
  e_d = torch.exp(logits_d - m)
  e_u = torch.exp(logits_u - m)
  e_l = torch.exp(logits_l - m)
  denom = (e_d.sum(-1, keepdim=True) + e_u.sum(-1, keepdim=True)
           + e_l.sum(-1, keepdim=True))

  def av(e, values):
    weights = (e / denom).to(x.dtype)
    return torch.einsum("bnhqk,bnkhd->bnqhd", weights.float(),
                        values.float()).to(x.dtype)

  out = av(e_d, v[:, 1:-1]) + av(e_u, v[:, 2:]) + av(e_l, v[:, :-2])
  out = out.reshape(b, num_blocks * block_size, -1)
  return block["mha_final"](out)[:, :num_nodes]


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
    self._num_nodes = 0
    self._host_mask: Optional[np.ndarray] = None  # mha, triblockdiag_mha
    self._device_masks: dict = {}
    self._block_map: Optional[splash.BlockMap] = None
    self._sp_group = None
    self._sp: Optional[splash.SequenceParallelAttention] = None

  def enable_sequence_parallel(self, mesh, axis: str):
    """Splits the node axis over ``mesh``'s ``axis`` (module doc; splash
    backend only, as in the JAX package)."""
    if self.cfg.attention_type != "splash_mha":
      raise ValueError(
          "sequence-parallel attention requires attention_type='splash_mha', "
          f"got {self.cfg.attention_type!r}")
    self._sp_group = mesh.get_group(axis)
    self._sp = None
    for m in self.modules():
      if isinstance(m, core.Linear):
        m.parallel = m.parallel or collectives.LinearSharding()
        m.parallel.grad_group = self._sp_group

  def prepare_mask(self, adjacency: sp.spmatrix):
    """Takes the k-hop attention mask for the chosen backend (host; built
    at the first call for this adjacency, ``prepared_mask``)."""
    cfg = self.cfg
    prepared = prepared_mask(adjacency, cfg.attention_k_hop,
                             cfg.attention_type)
    self._num_nodes = prepared["num_nodes"]
    if cfg.attention_type == "mha":
      self._host_mask = prepared["dense"]
    elif cfg.attention_type == "triblockdiag_mha":
      self._block_size = prepared["block_size"]
      self._num_padding = prepared["num_padding"]
      self._host_mask = prepared["triblock"]
    else:
      self._block_map = prepared["block_map"]

  def _mask_on(self, device: torch.device) -> torch.Tensor:
    """The dense or tri-block mask on ``device`` (copied once per device,
    as a normal tensor even under inference mode)."""
    key = str(device)
    if key not in self._device_masks:
      with torch.inference_mode(False):  # usable under autograd later
        self._device_masks[key] = torch.as_tensor(self._host_mask,
                                                  device=device)
    return self._device_masks[key]

  def _attend(self, block, x):
    cfg = self.cfg
    if cfg.attention_type == "mha":
      return dense_mha(block, cfg, x, self._mask_on(x.device))
    if cfg.attention_type == "triblockdiag_mha":
      return triblockdiag_mha(block, cfg, x, self._mask_on(x.device),
                              num_nodes=self._num_nodes,
                              num_padding=self._num_padding,
                              block_size=self._block_size)
    q = _mh_linear(block["mha_proj_q"], x, cfg.num_heads, cfg.key_size)
    k = _mh_linear(block["mha_proj_k"], x, cfg.num_heads, cfg.key_size)
    v = _mh_linear(block["mha_proj_v"], x, cfg.num_heads, cfg.value_size)
    if self._sp is not None:
      out, _ = self._sp(q, k, v, cfg.key_size ** -0.5)
    else:
      out, _ = splash.block_sparse_attention(q, k, v, self._block_map,
                                             cfg.key_size ** -0.5)
    return block["mha_final"](out.flatten(-2))

  def _ffw(self, block, x):
    act = core.get_activation(self.cfg.activation)
    return block["ffw_down"](act(block["ffw_up"](x)))

  def forward(self, x, global_norm_conditioning):
    """x: [batch, nodes, d_model]; conditioning: [batch, cond]."""
    if self._host_mask is None and self._block_map is None:
      raise RuntimeError("call prepare_mask before the first forward")
    cond = global_norm_conditioning[:, None]  # [batch, 1, cond]
    if self._sp_group is not None:
      if self._sp is None or self._sp.n != self._block_map.n:
        self._sp = splash.SequenceParallelAttention(self._block_map,
                                                    self._sp_group)
      x = self._sp.split(x)
      cond = collectives.grad_all_reduce(cond, self._sp_group)
    ln = core.layer_norm_no_params
    for i in range(self.cfg.num_layers):
      block = getattr(self, f"block_{i:02d}")
      h = block["norm_conditioning"](ln(x), cond)
      x = x + self._attend(block, h)
      h = block["norm_conditioning_1"](ln(x), cond)
      x = x + self._ffw(block, h)
    out = self.final_norm_conditioning(ln(x), cond)
    return out if self._sp is None else self._sp.gather(out, False)
