"""K6: block-sparse flash attention forward over a static mask, and its
plain-PyTorch version.

Replaces graphcast_tpu/ops/splash.py::_fwd_kernel (ground truth:
``splash.reference_masked_attention``). For every head and query row,

    s    = q · kᵀ · scale                 (f32; masked entries at -1e30)
    o    = softmax(s) · v                 (weights rounded to v's dtype)
    lse  = logsumexp(s)                   (f32, kept for the backward)

over the entries of a static boolean mask, GenCast's k-hop mesh mask.

The host compiles the mask into a ``BlockMap`` at the port's own tile size
(``TILE`` = 64, a tile of q rows by a tile of kv columns): for every q tile
the list of kv tiles that hold any mask entry, and one 64-bit word per q
row of each such (q tile, kv tile) pair, bit c set where column c of the kv
tile is in the mask. Tiles whose 64 words are all ones are flagged full and
skip the mask test. The TPU version's 512×512 tiles and its sublane-strided
bit packing (splash.py:72-107) are Mosaic layouts and are not ported; at
64×64 the k-hop-16 mask of the 1.0° mesh-5 covers 35 % fewer entries.

``block_sparse_attention`` runs the CUDA kernel (csrc/splash_fwd.cu) for
CUDA tensors and the plain version for CPU tensors; it raises on CUDA inputs
the kernel does not take (head dim other than 128, dtypes other than bf16).
No backward here: K7/K8 (dq, dk/dv) wait for GenCast training.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from graphcast_tpu_torch.native import build

NEG_INF = -1e30
TILE = 64
HEAD_DIM = 128  # the kernel's head dim (GenCast: d_model 512 / 4 heads)


@dataclasses.dataclass(eq=False)
class BlockMap:
  """A static mask compiled to active (q tile, kv tile) pairs.

  Attributes:
    n: mask size (nodes); n_pad = nq * TILE.
    kv_offsets: [nq + 1] int32, CSR offsets of each q tile's active pairs.
    kv_index: [n_active] int32, kv tile of each pair, ascending per q tile.
    words: [n_active, TILE] uint64; bit c of words[a, r] is mask[q tile row
      r, kv tile column c] of pair a. Rows and columns past n are 0.
    full: [n_active] bool, pairs whose TILE × TILE entries are all set.
    nnz: number of mask entries.
  """
  n: int
  kv_offsets: np.ndarray
  kv_index: np.ndarray
  words: np.ndarray
  full: np.ndarray
  nnz: int
  _on_device: dict = dataclasses.field(default_factory=dict, repr=False)

  def on_device(self, device) -> "_DeviceMap":
    """The map's arrays on ``device``, as the kernel reads them (copied
    once per device)."""
    key = str(device)
    if key not in self._on_device:
      self._on_device[key] = _DeviceMap(self, device)
    return self._on_device[key]

  @property
  def nq(self) -> int:
    return self.kv_offsets.shape[0] - 1

  @property
  def n_pad(self) -> int:
    return self.nq * TILE

  @property
  def n_active(self) -> int:
    return int(self.kv_index.shape[0])


def build_block_map(mask: sp.spmatrix) -> BlockMap:
  """Compiles a square boolean sparse mask into a ``BlockMap``, from its
  nonzero coordinates (never densified)."""
  n = mask.shape[0]
  if mask.shape != (n, n):
    raise ValueError(f"mask must be square, got {mask.shape}")
  coo = mask.tocoo()
  keep = coo.data.astype(bool)
  rows = coo.row[keep].astype(np.int64)
  cols = coo.col[keep].astype(np.int64)
  nq = -(-n // TILE)
  pair = (rows // TILE) * nq + cols // TILE
  uniq, inv = np.unique(pair, return_inverse=True)
  # One word per (pair, row): distinct bits, so their sum is their OR.
  key = inv.astype(np.int64) * TILE + rows % TILE
  order = np.argsort(key, kind="stable")
  key = key[order]
  bits = np.left_shift(np.uint64(1), (cols[order] % TILE).astype(np.uint64))
  starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
  words = np.zeros(len(uniq) * TILE, np.uint64)
  words[key[starts]] = np.add.reduceat(bits, starts) if len(starts) else 0
  words = words.reshape(len(uniq), TILE)
  qb = uniq // nq
  kv_offsets = np.zeros(nq + 1, np.int32)
  kv_offsets[1:] = np.cumsum(np.bincount(qb, minlength=nq))
  return BlockMap(
      n=n, kv_offsets=kv_offsets, kv_index=(uniq % nq).astype(np.int32),
      words=words, full=(words == np.uint64(2**64 - 1)).all(axis=1),
      nnz=int(rows.size))


def block_sparse_attention_reference(q, k, v, block_map: BlockMap,
                                     scale: float):
  """Plain-PyTorch version of K6 over the same block map.

  q, k, v: [batch, n, heads, d]. Per q tile, the logits over its active kv
  tiles are masked, the softmax is taken in f32, and the weights are cast to
  v's dtype before the product (splash.py:1059). Returns (o [batch, n,
  heads, d] in v's dtype, lse [batch, heads, n] f32).
  """
  batch, n, heads, d = q.shape
  bm = block_map
  if n != bm.n:
    raise ValueError(f"block map built for {bm.n} nodes, got {n}")
  pad = bm.n_pad - n
  qf, kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
                for t in (q, k, v))
  words = torch.from_numpy(bm.words.view(np.int64)).to(q.device)
  shifts = torch.arange(TILE, device=q.device)
  o = torch.zeros(batch, bm.n_pad, heads, d, dtype=v.dtype, device=q.device)
  lse = torch.zeros(batch, heads, bm.n_pad, device=q.device)
  for i in range(bm.nq):
    a0, a1 = int(bm.kv_offsets[i]), int(bm.kv_offsets[i + 1])
    if a0 == a1:
      continue
    cols = (torch.from_numpy(bm.kv_index[a0:a1]).to(q.device)[:, None] * TILE
            + shifts).reshape(-1)
    # [TILE rows, slots * TILE cols] bool from the rows' 64-bit words.
    allowed = ((words[a0:a1, :, None] >> shifts) & 1).bool()
    allowed = allowed.permute(1, 0, 2).reshape(TILE, -1)
    rows = slice(i * TILE, (i + 1) * TILE)
    s = torch.einsum("bqhd,bkhd->bhqk", qf[:, rows], kf[:, cols]) * scale
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    w = (p / l).to(v.dtype).float()
    o[:, rows] = torch.einsum("bhqk,bkhd->bqhd", w, vf[:, cols]).to(v.dtype)
    lse[:, :, rows] = (m + torch.log(l))[..., 0]
  return o[:, :n], lse[:, :, :n]


class _DeviceMap:
  """A BlockMap's arrays on one device, as the kernel reads them."""

  def __init__(self, bm: BlockMap, device):
    def tensor(a):
      return torch.as_tensor(np.ascontiguousarray(a), device=device)
    self.kv_offsets = tensor(bm.kv_offsets)
    self.kv_index = tensor(bm.kv_index)
    self.words = tensor(bm.words.view(np.int64))
    self.full = tensor(bm.full.astype(np.int32))


def _to_heads(x, n_pad):
  """[batch, n, heads, d] → contiguous [batch·heads, n_pad, d], zero rows
  past n."""
  b, n, h, d = x.shape
  x = x.permute(0, 2, 1, 3).reshape(b * h, n, d)
  return torch.nn.functional.pad(x, (0, 0, 0, n_pad - n)).contiguous()


def _launch_splash(q, k, v, bm: BlockMap, scale: float):
  """K6 on CUDA tensors (checks, then one launch)."""
  batch, n, heads, d = q.shape
  if n != bm.n:
    raise ValueError(f"block map built for {bm.n} nodes, got {n}")
  if d != HEAD_DIM:
    raise ValueError(f"the kernel takes head dim {HEAD_DIM}, got {d}")
  for name, t in (("q", q), ("k", k), ("v", v)):
    if t.shape != q.shape:
      raise ValueError(f"{name} has shape {tuple(t.shape)}, q {q.shape}")
    if t.dtype != torch.bfloat16:
      raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes bf16")
    if t.device != q.device:
      raise ValueError(f"{name} is on {t.device}, q on {q.device}")
  dm = bm.on_device(q.device)
  qh, kh, vh = (_to_heads(t, bm.n_pad) for t in (q, k, v))
  o = torch.empty_like(qh)
  lse = torch.empty(batch * heads, bm.n_pad, dtype=torch.float32,
                    device=q.device)
  lib = build.load_library()
  code = lib.gc_splash_fwd(
      qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), dm.kv_offsets.data_ptr(),
      dm.kv_index.data_ptr(), dm.words.data_ptr(), dm.full.data_ptr(),
      o.data_ptr(), lse.data_ptr(), float(scale), batch * heads, bm.nq,
      bm.n_pad, torch.cuda.current_stream(q.device).cuda_stream)
  build.check(lib, code, "splash_fwd kernel launch")
  block_sparse_attention.launches += 1
  o = o[:, :n].reshape(batch, heads, n, d).permute(0, 2, 1, 3)
  return o, lse[:, :n].reshape(batch, heads, n)


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           block_map: BlockMap, scale: float):
  """Masked attention over ``block_map`` (module doc).

  q, k, v: [batch, n, heads, d] (the JAX package's layout). Returns (o
  [batch, n, heads, d], lse [batch, heads, n] f32). CPU tensors run the
  plain version; CUDA tensors launch K6 (bf16, d = 128) or raise.
  """
  if q.device.type == "cpu":
    return block_sparse_attention_reference(q, k, v, block_map, scale)
  if q.device.type != "cuda":
    raise ValueError(f"unsupported device {q.device}")
  if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
    raise NotImplementedError(
        "the attention backward (K7, K8) is not ported: run under no_grad")
  return _launch_splash(q, k, v, block_map, scale)


block_sparse_attention.launches = 0
