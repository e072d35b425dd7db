"""K6, K7, K8: block-sparse flash attention over a static mask, forward and
backward, and their plain-PyTorch versions.

Replaces graphcast_tpu/ops/splash.py::_fwd_kernel (K6), ::_dq_kernel (K7)
and ::_dkv_kernel (K8) (ground truth: ``splash.reference_masked_attention``
and its autodiff). For every head and query row i, over the entries j of a
static boolean mask, GenCast's k-hop mesh mask:

    s    = q · kᵀ · scale                 (f32; masked entries at -1e30)
    o    = softmax(s) · v                 (weights rounded to v's dtype)
    lse  = logsumexp(s)                   (f32, kept for the backward)

and the backward from the output cotangent do (splash.py:382-641):

    δ    = Σ_d o·do                       (f32, per row)
    p    = exp(s − lse)        dp = do · vᵀ             (f32)
    ds   = p · (dp − δ) · scale
    dq   = bf16(ds) · k        (K7)
    dv   = bf16(p)ᵀ · do       dk = bf16(ds)ᵀ · q       (K8)

with f32 sums and outputs in the inputs' dtype (the casts are those of the
TPU kernels: p to do's dtype, ds to q's and k's).

The host compiles the mask into a ``BlockMap`` at the port's own tile size
(``TILE`` = 64, a tile of q rows by a tile of kv columns): for every q tile
the list of kv tiles that hold any mask entry, and one 64-bit word per q
row of each such (q tile, kv tile) pair, bit c set where column c of the kv
tile is in the mask. Tiles whose 64 words are all ones are flagged full and
skip the mask test. The map also holds the same structure for the
transposed mask (``transposed``): for every kv tile the q tiles that attend
it, one word per kv row with bit r set where q row r of the q tile attends
it; K8 walks it. The TPU version's 512×512 tiles and its sublane-strided
bit packing (splash.py:72-107) are Mosaic layouts and are not ported; at
64×64 the k-hop-16 mask of the 1.0° mesh-5 covers 35 % fewer entries.

A map may be rectangular: q rows against kv rows of another count. A
sequence-parallel shard's map (``shard_block_maps``) covers the shard's q
tiles against every kv tile; its transpose lists, for every kv tile, the
shard's q tiles that attend it, as the JAX package's
``_build_shard_transposed_maps`` does (splash.py:1025).
``SequenceParallelAttention`` runs K6, K7 and K8 on those maps with the q
rows split over a process group and k, v gathered whole (the twin of the
JAX ``SequenceParallelAttention``, splash.py:760).

``block_sparse_attention`` runs the CUDA kernels (csrc/splash_fwd.cu and
csrc/splash_bwd.cu, K6 and K7 on the map's ``paired_lists``, K8 on its
transpose's) for CUDA tensors and
the plain versions for CPU tensors, both inside one
``torch.autograd.Function`` (forward K6, backward K7 then K8); it raises
on CUDA inputs the kernels do not take (head dim other than 128, dtypes
other than bf16). The logsumexp output carries no gradient, as the JAX
``_attend`` returns o alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from graphcast_tpu_torch.native import build
from graphcast_tpu_torch.parallel import collectives

NEG_INF = -1e30
TILE = 64
HEAD_DIM = 128  # the kernels' head dim (GenCast: d_model 512 / 4 heads)


@dataclasses.dataclass(eq=False)
class BlockMap:
  """A static mask compiled to active (q tile, kv tile) pairs.

  Attributes:
    n: q rows of the mask (nodes); n_pad = nq * TILE.
    n_kv: kv columns of the mask; n_pad_kv = nkv * TILE.
    nkv: kv tiles.
    kv_offsets: [nq + 1] int32, CSR offsets of each q tile's active pairs.
    kv_index: [n_active] int32, kv tile of each pair, ascending per q tile.
    words: [n_active, TILE] uint64; bit c of words[a, r] is mask[q tile row
      r, kv tile column c] of pair a. Rows and columns past n are 0.
    full: [n_active] bool, pairs whose TILE × TILE entries are all set.
    nnz: number of mask entries.
    transposed: the map of the transposed mask (its q tiles are the kv
      tiles here, its words one per kv row), or None in a map that is
      itself a transpose.
  """
  n: int
  n_kv: int
  nkv: int
  kv_offsets: np.ndarray
  kv_index: np.ndarray
  words: np.ndarray
  full: np.ndarray
  nnz: int
  transposed: Optional["BlockMap"] = None
  _on_device: dict = dataclasses.field(default_factory=dict, repr=False)

  def on_device(self, device) -> "_DeviceMap":
    """The map's arrays on ``device``, as the kernels read them (copied
    once per device)."""
    key = str(device)
    if key not in self._on_device:
      with torch.inference_mode(False):  # usable under autograd later
        self._on_device[key] = _DeviceMap(self, device)
    return self._on_device[key]

  @property
  def nq(self) -> int:
    return self.kv_offsets.shape[0] - 1

  @property
  def n_pad(self) -> int:
    return self.nq * TILE

  @property
  def n_pad_kv(self) -> int:
    return self.nkv * TILE

  @property
  def n_active(self) -> int:
    return int(self.kv_index.shape[0])


def _compile(rows: np.ndarray, cols: np.ndarray, n: int, n_kv: int,
             transposed: Optional[BlockMap]) -> BlockMap:
  """The BlockMap of the mask entries (rows[i], cols[i]) of an [n, n_kv]
  mask."""
  nq, nkv = -(-n // TILE), -(-n_kv // TILE)
  pair = (rows // TILE) * nkv + cols // TILE
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
  qb = uniq // nkv
  kv_offsets = np.zeros(nq + 1, np.int32)
  kv_offsets[1:] = np.cumsum(np.bincount(qb, minlength=nq))
  return BlockMap(
      n=n, n_kv=n_kv, nkv=nkv, kv_offsets=kv_offsets,
      kv_index=(uniq % nkv).astype(np.int32), words=words,
      full=(words == np.uint64(2**64 - 1)).all(axis=1),
      nnz=int(rows.size), transposed=transposed)


def build_block_map(mask: sp.spmatrix) -> BlockMap:
  """Compiles a boolean sparse mask [q rows, kv columns] into a
  ``BlockMap`` and its transpose, from its nonzero coordinates (never
  densified; the mask need not be square or symmetric)."""
  n, n_kv = mask.shape
  coo = mask.tocoo()
  keep = coo.data.astype(bool)
  rows = coo.row[keep].astype(np.int64)
  cols = coo.col[keep].astype(np.int64)
  return _compile(rows, cols, n, n_kv, _compile(cols, rows, n_kv, n, None))


def _popcount(words: np.ndarray) -> int:
  return int(np.unpackbits(np.ascontiguousarray(words).view(np.uint8)).sum())


def _take_rows(bm: BlockMap, lo: int, count: int, n: int) -> BlockMap:
  """The q tiles lo .. lo + count - 1 of ``bm`` (tiles past bm.nq empty)
  as a map of ``n`` q rows, without a transpose."""
  hi = min(lo + count, bm.nq)
  offsets = bm.kv_offsets[min(lo, bm.nq):hi + 1] if lo < bm.nq else (
      bm.kv_offsets[-1:])
  a0, a1 = int(offsets[0]), int(offsets[-1])
  kv_offsets = np.full(count + 1, a1 - a0, np.int32)
  kv_offsets[:len(offsets)] = offsets - a0
  words = bm.words[a0:a1]
  return BlockMap(n=n, n_kv=bm.n_kv, nkv=bm.nkv, kv_offsets=kv_offsets,
                  kv_index=bm.kv_index[a0:a1], words=words,
                  full=bm.full[a0:a1], nnz=_popcount(words))


def _take_columns(bt: BlockMap, lo: int, count: int, n_kv: int) -> BlockMap:
  """The entries of the transposed map ``bt`` whose q tile (its kv_index)
  lies in lo .. lo + count - 1, renumbered from 0: for every kv tile the
  shard's q tiles that attend it, ascending (the JAX package's
  _build_shard_transposed_maps, splash.py:1025)."""
  keep = (bt.kv_index >= lo) & (bt.kv_index < lo + count)
  row = np.repeat(np.arange(bt.nq), np.diff(bt.kv_offsets))
  kv_offsets = np.zeros(bt.nq + 1, np.int32)
  kv_offsets[1:] = np.cumsum(np.bincount(row[keep], minlength=bt.nq))
  words = bt.words[keep]
  return BlockMap(n=bt.n, n_kv=n_kv, nkv=count, kv_offsets=kv_offsets,
                  kv_index=(bt.kv_index[keep] - lo).astype(np.int32),
                  words=words, full=bt.full[keep], nnz=_popcount(words))


def shard_rows(n: int, num_shards: int) -> list[tuple[int, int]]:
  """The q rows [start, stop) of each of ``num_shards`` sequence-parallel
  shards of n rows: ceil(ceil(n / TILE) / num_shards) tiles each, the
  last shards padded with empty tiles (the JAX package raises where the
  shard count does not divide the q tiles, splash.py:782; the port's TILE
  is fixed, so it pads)."""
  rows = shard_tiles(n, num_shards) * TILE
  return [(min(s * rows, n), min((s + 1) * rows, n))
          for s in range(num_shards)]


def shard_tiles(n: int, num_shards: int) -> int:
  """q tiles of each shard (``shard_rows``)."""
  return -(-(-(-n // TILE)) // num_shards)


def shard_block_maps(bm: BlockMap, num_shards: int) -> list[BlockMap]:
  """The sequence-parallel shard maps of a map (module doc): shard s covers
  q tiles s·t .. s·t + t − 1 (t = ``shard_tiles``; tiles past bm.nq are
  empty) against every kv tile, with its transpose over the same q tiles
  renumbered from 0. Each shard's q rows are ``shard_rows``'s."""
  if bm.transposed is None:
    raise ValueError("shard a forward map (one with its transpose)")
  tiles = shard_tiles(bm.n, num_shards)
  maps = []
  for s, (start, stop) in enumerate(shard_rows(bm.n, num_shards)):
    shard = _take_rows(bm, s * tiles, tiles, stop - start)
    shard.transposed = _take_columns(bm.transposed, s * tiles, tiles,
                                     stop - start)
    maps.append(shard)
  return maps


def _allowed(words: torch.Tensor) -> torch.Tensor:
  """[slots, TILE] 64-bit words → [TILE rows, slots * TILE cols] bool."""
  shifts = torch.arange(TILE, device=words.device)
  allowed = ((words[:, :, None] >> shifts) & 1).bool()
  return allowed.permute(1, 0, 2).reshape(TILE, -1)


def _tile_columns(index: np.ndarray, device) -> torch.Tensor:
  """Node indices of the tiles ``index``, tile after tile."""
  return (torch.from_numpy(index).to(device)[:, None] * TILE
          + torch.arange(TILE, device=device)).reshape(-1)


def _padded(x, n_pad, dtype=torch.float32):
  """x [batch, n, ...] in ``dtype``, zero rows past n up to n_pad."""
  pad = [0, 0] * (x.ndim - 2) + [0, n_pad - x.shape[1]]
  return torch.nn.functional.pad(x.to(dtype), pad)


def block_sparse_attention_reference(q, k, v, block_map: BlockMap,
                                     scale: float):
  """Plain-PyTorch version of K6 over the same block map.

  q: [batch, n, heads, d]; k, v: [batch, n_kv, heads, d]. Per q tile, the
  logits over its active kv tiles are masked, the softmax is taken in f32,
  and the weights are cast to v's dtype before the product
  (splash.py:1059). Returns (o [batch, n, heads, d] in v's dtype, lse
  [batch, heads, n] f32).
  """
  batch, n, heads, d = q.shape
  bm = block_map
  _check_rows(bm, q, k)
  qf = _padded(q, bm.n_pad)
  kf, vf = (_padded(t, bm.n_pad_kv) for t in (k, v))
  words = torch.from_numpy(bm.words.view(np.int64)).to(q.device)
  o = torch.zeros(batch, bm.n_pad, heads, d, dtype=v.dtype, device=q.device)
  lse = torch.zeros(batch, heads, bm.n_pad, device=q.device)
  for i in range(bm.nq):
    a0, a1 = int(bm.kv_offsets[i]), int(bm.kv_offsets[i + 1])
    if a0 == a1:
      continue
    cols = _tile_columns(bm.kv_index[a0:a1], q.device)
    allowed = _allowed(words[a0:a1])
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


def _check_rows(bm: BlockMap, q, k):
  if q.shape[1] != bm.n or k.shape[1] != bm.n_kv:
    raise ValueError(f"block map built for {bm.n} q and {bm.n_kv} kv "
                     f"nodes, got {q.shape[1]} and {k.shape[1]}")


def _backward_operands(q, k, v, o, lse, do, bm: BlockMap):
  """f32 copies padded to n_pad (q, do) and n_pad_kv (k, v), δ = Σ o·do
  [batch, heads, n_pad], and lse padded with 0 (the padded rows' mask
  words are 0, so their p is 0)."""
  _check_rows(bm, q, k)
  qf, dof = (_padded(t, bm.n_pad) for t in (q, do))
  kf, vf = (_padded(t, bm.n_pad_kv) for t in (k, v))
  delta = (_padded(o, bm.n_pad) * dof).sum(-1).permute(0, 2, 1)
  lse = torch.nn.functional.pad(lse.float(), (0, bm.n_pad - bm.n))
  return qf, kf, vf, dof, delta, lse


def _dq_reference(q, k, v, o, lse, do, bm: BlockMap, scale: float):
  """Plain version of K7: dq over the forward map."""
  qf, kf, vf, dof, delta, lse = _backward_operands(q, k, v, o, lse, do, bm)
  words = torch.from_numpy(bm.words.view(np.int64)).to(q.device)
  dq = torch.zeros_like(qf)
  for i in range(bm.nq):
    a0, a1 = int(bm.kv_offsets[i]), int(bm.kv_offsets[i + 1])
    if a0 == a1:
      continue
    cols = _tile_columns(bm.kv_index[a0:a1], q.device)
    rows = slice(i * TILE, (i + 1) * TILE)
    s = torch.einsum("bqhd,bkhd->bhqk", qf[:, rows], kf[:, cols]) * scale
    p = torch.where(_allowed(words[a0:a1]),
                    torch.exp(s - lse[:, :, rows, None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, rows], vf[:, cols])
    ds = p * (dp - delta[:, :, rows, None]) * scale
    dq[:, rows] = torch.einsum("bhqk,bkhd->bqhd",
                               ds.to(k.dtype).float(), kf[:, cols])
  return dq[:, :bm.n].to(q.dtype)


def _dkv_reference(q, k, v, o, lse, do, bm: BlockMap, scale: float):
  """Plain version of K8: dk and dv over the transposed map."""
  qf, kf, vf, dof, delta, lse = _backward_operands(q, k, v, o, lse, do, bm)
  bt = bm.transposed
  words = torch.from_numpy(bt.words.view(np.int64)).to(q.device)
  dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
  for j in range(bt.nq):
    a0, a1 = int(bt.kv_offsets[j]), int(bt.kv_offsets[j + 1])
    if a0 == a1:
      continue
    rows = _tile_columns(bt.kv_index[a0:a1], q.device)  # attending q rows
    kv = slice(j * TILE, (j + 1) * TILE)
    # Transposed tiles: [batch, heads, kv row, q row].
    st = torch.einsum("bkhd,bqhd->bhkq", kf[:, kv], qf[:, rows]) * scale
    pt = torch.where(_allowed(words[a0:a1]),
                     torch.exp(st - lse[:, :, None, rows]),
                     torch.zeros_like(st))
    dpt = torch.einsum("bkhd,bqhd->bhkq", vf[:, kv], dof[:, rows])
    dst = pt * (dpt - delta[:, :, None, rows]) * scale
    dv[:, kv] = torch.einsum("bhkq,bqhd->bkhd", pt.to(do.dtype).float(),
                             dof[:, rows])
    dk[:, kv] = torch.einsum("bhkq,bqhd->bkhd", dst.to(q.dtype).float(),
                             qf[:, rows])
  return dk[:, :bm.n_kv].to(k.dtype), dv[:, :bm.n_kv].to(v.dtype)


def block_sparse_attention_backward_reference(q, k, v, o, lse, do,
                                              block_map: BlockMap,
                                              scale: float):
  """Plain-PyTorch version of K7 and K8 (module doc): the gradients of
  ``block_sparse_attention``'s o for the cotangent ``do``.

  q, o, do: [batch, n, heads, d]; k, v: [batch, n_kv, heads, d]; lse
  [batch, heads, n] f32, both from the forward. Returns (dq, dk, dv) in
  q's, k's and v's dtypes.
  """
  args = (q, k, v, o, lse, do, block_map, scale)
  return (_dq_reference(*args), *_dkv_reference(*args))


def heaviest_first(offsets: np.ndarray) -> np.ndarray:
  """Launch order of the rows of a CSR list (K6's q tile pairs): by entry
  count, largest first (ties in row order), so that the longest lists
  start first."""
  counts = np.diff(offsets)
  return np.argsort(-counts, kind="stable").astype(np.int32)


@dataclasses.dataclass(frozen=True)
class PairedLists:
  """The work lists of K6 and K7 (of K8 over the transposed map): q tiles
  2g and 2g + 1 form group g, which walks the union of the two tiles' kv
  lists, so each K and V tile it loads serves both (neighbouring q tiles of
  the k-hop mask share about half their kv tiles: 4,230 union entries for
  8,161 pairs at mesh-5). Over the transposed map the roles swap: kv tiles
  pair up and walk the union of their q lists.

  Attributes:
    offsets: [groups + 1] int32, CSR offsets of each group's union list.
    kv: [entries] int32, the kv tile of each entry, ascending per group.
    pairs: [entries, 2] int32, the BlockMap pair of q tile 2g (column 0)
      and 2g + 1 (column 1) with that kv tile, -1 where the tile has none.
    order: [groups] int32, the groups heaviest first (``heaviest_first``).
  """
  offsets: np.ndarray
  kv: np.ndarray
  pairs: np.ndarray
  order: np.ndarray


def paired_lists(bm: BlockMap) -> PairedLists:
  """The union kv lists of q tile pairs (``PairedLists``) of a BlockMap."""
  nq, nkv = bm.nq, max(bm.nkv, 1)
  groups = -(-nq // 2)
  qt = np.repeat(np.arange(nq), np.diff(bm.kv_offsets))
  key = (qt // 2).astype(np.int64) * nkv + bm.kv_index
  uniq, inverse = np.unique(key, return_inverse=True)
  pairs = np.full((len(uniq), 2), -1, np.int32)
  pairs[inverse, qt % 2] = np.arange(bm.n_active, dtype=np.int32)
  offsets = np.zeros(groups + 1, np.int32)
  offsets[1:] = np.cumsum(np.bincount(uniq // nkv, minlength=groups))
  return PairedLists(offsets=offsets, kv=(uniq % nkv).astype(np.int32),
                     pairs=pairs, order=heaviest_first(offsets))


class _DeviceMap:
  """A BlockMap's mask words and paired work lists on one device, as the
  kernels read them: K6 and K7 read the forward map's, K8 its transpose's
  (``group_kv`` then holds q tiles)."""

  def __init__(self, bm: BlockMap, device):
    def tensor(a):
      return torch.as_tensor(np.ascontiguousarray(a), device=device)
    self.words = tensor(bm.words.view(np.int64))
    self.full = tensor(bm.full.astype(np.int32))
    lists = paired_lists(bm)
    self.groups = len(lists.order)
    self.group_offsets = tensor(lists.offsets)
    self.group_kv = tensor(lists.kv)
    self.group_pairs = tensor(lists.pairs)
    self.group_order = tensor(lists.order)


def _to_heads(x, n_pad):
  """[batch, n, heads, d] → contiguous [batch·heads, n_pad, d], zero rows
  past n."""
  b, n, h, d = x.shape
  x = x.permute(0, 2, 1, 3).reshape(b * h, n, d)
  return torch.nn.functional.pad(x, (0, 0, 0, n_pad - n)).contiguous()


def _from_heads(x, batch, n):
  """[batch·heads, n_pad, d] → [batch, n, heads, d] (a view)."""
  bh, _, d = x.shape
  return x[:, :n].reshape(batch, bh // batch, n, d).permute(0, 2, 1, 3)


def _launch_splash(q, k, v, bm: BlockMap, scale: float):
  """K6 on CUDA tensors (checks, then one launch). Returns ((qh, kh, vh),
  o, lse) in the padded head-major layout: [batch·heads, n_pad, d] bf16
  (k, v: n_pad_kv rows) and [batch·heads, n_pad] f32, lse 0 past n."""
  batch, n, heads, d = q.shape
  _check_rows(bm, q, k)
  if d != HEAD_DIM:
    raise ValueError(f"the kernel takes head dim {HEAD_DIM}, got {d}")
  for name, t in (("k", k), ("v", v)):
    if t.shape != (batch, bm.n_kv, heads, d):
      raise ValueError(f"{name} has shape {tuple(t.shape)}, q {q.shape}")
  for name, t in (("q", q), ("k", k), ("v", v)):
    if t.dtype != torch.bfloat16:
      raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes bf16")
    if t.device != q.device:
      raise ValueError(f"{name} is on {t.device}, q on {q.device}")
  dm = bm.on_device(q.device)
  qh = _to_heads(q, bm.n_pad)
  kh, vh = (_to_heads(t, bm.n_pad_kv) for t in (k, v))
  o = torch.empty_like(qh)
  lse = torch.empty(batch * heads, bm.n_pad, dtype=torch.float32,
                    device=q.device)
  lib = build.load_library()
  code = lib.gc_splash_fwd(
      qh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
      dm.group_offsets.data_ptr(), dm.group_kv.data_ptr(),
      dm.group_pairs.data_ptr(), dm.group_order.data_ptr(),
      dm.words.data_ptr(), dm.full.data_ptr(), o.data_ptr(), lse.data_ptr(),
      float(scale), batch * heads, bm.nq, dm.groups, bm.n_pad, bm.n_pad_kv,
      torch.cuda.current_stream(q.device).cuda_stream)
  build.check(lib, code, "splash_fwd kernel launch")
  block_sparse_attention.launches += 1
  # The padded rows attend nothing; the backward reads their lse as 0.
  lse[:, n:] = 0.0
  return (qh, kh, vh), o, lse


def _outputs(o, lse, batch, n):
  """Head-major (o, lse) → (o [batch, n, heads, d], lse [batch, heads, n])."""
  return _from_heads(o, batch, n), lse[:, :n].reshape(batch, -1, n)


def attention_delta(o, do):
  """δ = Σ_d o·do in f32 over the last dim, computed outside the backward
  kernels as in the JAX package (splash.py:530)."""
  return (o.float() * do.float()).sum(-1)


def _check_heads(bm: BlockMap, qh, kh, vh, do, lse, delta):
  """Checks the backward kernels' head-major operands before a launch."""
  if qh.device.type != "cuda":
    raise ValueError(f"K7/K8 take CUDA tensors, got {qh.device} (on the "
                     "CPU, block_sparse_attention runs the plain backward)")
  bh = qh.shape[0]
  for name, t, rows in (("q", qh, bm.n_pad), ("k", kh, bm.n_pad_kv),
                        ("v", vh, bm.n_pad_kv), ("do", do, bm.n_pad)):
    if t.shape != (bh, rows, HEAD_DIM) or t.dtype != torch.bfloat16 or not (
        t.is_contiguous()) or t.device != qh.device:
      raise ValueError(f"{name} must be contiguous bf16 of shape "
                       f"{(bh, rows, HEAD_DIM)} on {qh.device}, got "
                       f"{tuple(t.shape)}")
  for name, t in (("lse", lse), ("delta", delta)):
    if t.shape != qh.shape[:2] or t.dtype != torch.float32 or not (
        t.is_contiguous()) or t.device != qh.device:
      raise ValueError(f"{name} must be contiguous f32 of shape "
                       f"{tuple(qh.shape[:2])} on {qh.device}")
  for name, t in (("q", qh), ("k", kh), ("v", vh), ("do", do), ("lse", lse),
                  ("delta", delta)):
    if t.data_ptr() % 16:  # TMA and bulk copies read 16-byte aligned rows
      raise ValueError(f"{name} must start at a 16-byte aligned address")


def splash_dq(qh, kh, vh, do, lse, delta, bm: BlockMap, scale: float):
  """K7 on CUDA tensors in the padded head-major layout: q, do
  [batch·heads, n_pad, 128] bf16, k, v [batch·heads, n_pad_kv, 128];
  lse (0 past n) and delta
  (``attention_delta``) [batch·heads, n_pad] f32. Returns dq in that
  layout (bf16)."""
  _check_heads(bm, qh, kh, vh, do, lse, delta)
  dm = bm.on_device(qh.device)
  dq = torch.empty_like(qh)
  lib = build.load_library()
  code = lib.gc_splash_dq(
      qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), do.data_ptr(),
      lse.data_ptr(), delta.data_ptr(), dm.group_offsets.data_ptr(),
      dm.group_kv.data_ptr(), dm.group_pairs.data_ptr(),
      dm.group_order.data_ptr(), dm.words.data_ptr(), dm.full.data_ptr(),
      dq.data_ptr(), float(scale), qh.shape[0], bm.nq, dm.groups, bm.n_pad,
      bm.n_pad_kv, torch.cuda.current_stream(qh.device).cuda_stream)
  build.check(lib, code, "splash_dq kernel launch")
  splash_dq.launches += 1
  return dq


def splash_dkv(qh, kh, vh, do, lse, delta, bm: BlockMap, scale: float):
  """K8 on CUDA tensors, operands as ``splash_dq``, over the transposed
  map's paired lists. Returns (dk, dv) [batch·heads, n_pad_kv, 128]: over
  a shard map, the shard's partial sums (zero for kv tiles no q row of the
  shard attends)."""
  _check_heads(bm, qh, kh, vh, do, lse, delta)
  dt = bm.transposed.on_device(qh.device)
  dk, dv = torch.empty_like(kh), torch.empty_like(vh)
  lib = build.load_library()
  code = lib.gc_splash_dkv(
      qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), do.data_ptr(),
      lse.data_ptr(), delta.data_ptr(), dt.group_offsets.data_ptr(),
      dt.group_kv.data_ptr(), dt.group_pairs.data_ptr(),
      dt.group_order.data_ptr(), dt.words.data_ptr(), dt.full.data_ptr(),
      dk.data_ptr(), dv.data_ptr(), float(scale), qh.shape[0],
      bm.transposed.nq, dt.groups, bm.n_pad, bm.n_pad_kv,
      torch.cuda.current_stream(qh.device).cuda_stream)
  build.check(lib, code, "splash_dkv kernel launch")
  splash_dkv.launches += 1
  return dk, dv


splash_dq.launches = 0
splash_dkv.launches = 0


class _BlockSparseAttentionFunction(torch.autograd.Function):
  """Forward K6, backward K7 then K8 on CUDA tensors; the plain versions of
  both on CPU tensors. Saves q, k, v, o and lse (on the card in the padded
  head-major layout the kernels read)."""

  @staticmethod
  def forward(ctx, q, k, v, block_map, scale):
    ctx.block_map, ctx.scale, ctx.batch = block_map, scale, q.shape[0]
    if q.device.type == "cpu":
      o, lse = block_sparse_attention_reference(q, k, v, block_map, scale)
      ctx.save_for_backward(q, k, v, o, lse)
    else:
      (qh, kh, vh), oh, lseh = _launch_splash(q, k, v, block_map, scale)
      ctx.save_for_backward(qh, kh, vh, oh, lseh)
      o, lse = _outputs(oh, lseh, q.shape[0], block_map.n)
    ctx.mark_non_differentiable(lse)
    return o, lse

  @staticmethod
  def backward(ctx, do, _):
    bm, scale = ctx.block_map, ctx.scale
    saved = ctx.saved_tensors
    if do.device.type == "cpu":
      grads = block_sparse_attention_backward_reference(*saved, do, bm,
                                                        scale)
      return (*grads, None, None)
    qh, kh, vh, oh, lseh = saved
    doh = _to_heads(do.to(torch.bfloat16), bm.n_pad)
    delta = attention_delta(oh, doh)
    dq = splash_dq(qh, kh, vh, doh, lseh, delta, bm, scale)
    dk, dv = splash_dkv(qh, kh, vh, doh, lseh, delta, bm, scale)
    return (_from_heads(dq, ctx.batch, bm.n),
            *(_from_heads(g, ctx.batch, bm.n_kv) for g in (dk, dv)), None,
            None)


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           block_map: BlockMap, scale: float):
  """Masked attention over ``block_map`` (module doc).

  q: [batch, n, heads, d], k, v: [batch, n_kv, heads, d] (the JAX
  package's layout; n and n_kv the map's). Returns (o [batch, n, heads,
  d], lse [batch, heads, n] f32). CPU tensors run the
  plain versions; CUDA tensors launch K6 (bf16, d = 128), and K7 and K8 in
  the backward, or raise. Differentiable in q, k and v.
  """
  if q.device.type not in ("cpu", "cuda"):
    raise ValueError(f"unsupported device {q.device}")
  if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
    return _BlockSparseAttentionFunction.apply(q, k, v, block_map, scale)
  if q.device.type == "cpu":
    return block_sparse_attention_reference(q, k, v, block_map, scale)
  _, o, lse = _launch_splash(q, k, v, block_map, scale)
  return _outputs(o, lse, q.shape[0], block_map.n)


block_sparse_attention.launches = 0


class SequenceParallelAttention:
  """Block-sparse attention with the q (node) rows split over a process
  group: the twin of the JAX ``SequenceParallelAttention``
  (splash.py:760-856).

  Rank s holds q rows ``shard_rows(n, S)[s]`` and runs K6 and K7 on its
  shard map (``shard_block_maps``): its q rows against the whole k and v,
  which ``gather`` puts together from every rank's rows. K8 runs on the
  shard's transposed map and gives the shard's dk and dv partials for
  every kv row; the gather's backward sums them over the group (in f32)
  and hands each rank its rows, as shard_map's transpose of replicated k
  and v does in JAX. The forward and dq need no communication beyond the
  gather.
  """

  def __init__(self, block_map: BlockMap, group):
    size = collectives.group_size(group)
    rank = collectives.group_rank(group)
    self.group = group
    self.n = block_map.n
    self.shard = shard_block_maps(block_map, size)[rank]
    self.rows = shard_rows(block_map.n, size)[rank]
    self.rows_per_shard = shard_tiles(block_map.n, size) * TILE

  def split(self, x):
    """x [batch, n, ...], the same on every rank → this rank's rows; the
    backward gathers every rank's row gradients."""
    pad = [0, 0] * (x.ndim - 2) + [0, self.rows_per_shard
                                   * collectives.group_size(self.group)
                                   - x.shape[1]]
    part = collectives.split(torch.nn.functional.pad(x, pad), 1, self.group)
    return part[:, :self.rows[1] - self.rows[0]]

  def gather(self, x, reduce_grad: bool):
    """This rank's rows [batch, rows, ...] → every rank's, [batch, n, ...]
    (collectives.all_gather: ``reduce_grad`` where each rank's consumers
    of the whole differ, as the attention's of k and v)."""
    pad = [0, 0] * (x.ndim - 2) + [0, self.rows_per_shard - x.shape[1]]
    whole = collectives.all_gather(torch.nn.functional.pad(x, pad), 1,
                                   self.group, reduce_grad)
    return whole[:, :self.n]

  def __call__(self, q, k, v, scale: float):
    """q, k, v: this rank's rows [batch, rows, heads, d]. Returns (o, lse)
    for its rows, as ``block_sparse_attention``."""
    return block_sparse_attention(q, self.gather(k, True),
                                  self.gather(v, True), self.shard, scale)
