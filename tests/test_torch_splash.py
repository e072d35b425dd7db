"""K6's host block map and plain version (ops/splash.py) against the JAX
package's block-sparse attention.

The port compiles the mask at its own 64 × 64 tiles; the JAX kernel at its
own block sizes (Pallas interpret mode, as its tests run it). Both must
compute the masked attention of ``splash.reference_masked_attention``.

Tolerances: f32 2e-5 (only f32 summation order differs); bf16: relative RMS
<= 1e-2 and max-abs <= 0.05 — the port's plain version normalises the
weights before rounding them to bf16, the TPU kernel rounds the
unnormalised exp (splash.py:253) and divides at the end, so an output moves
by up to a few bf16 ulps. lse against a float64 numpy logsumexp: 1e-5.

Backward: the plain version of K7/K8 against ``jax.vjp`` of the JAX
``BlockSparseAttention`` (its Pallas ``_dq_kernel`` and ``_dkv_kernel`` in
interpret mode) with the same q, k, v and cotangent, each side's own o and
lse. f32: 1e-4 of each gradient's largest element (summation order only);
bf16: relative RMS <= 2e-2 per gradient (the two forwards' o differ by a
few bf16 ulps, which moves δ, and the casts of p and ds to bf16 flip with
it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphcast_tpu.ops import splash as jax_splash
from graphcast_tpu_torch.ops import splash

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _banded_mask(n, bandwidth, seed=0, dense_block=None):
  """Random banded mask with self edges (like a banded k-hop mask); with
  ``dense_block`` = (r0, c0, size), that square is all ones."""
  rng = np.random.RandomState(seed)
  i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
  dense = (np.abs(i - j) <= bandwidth) & (rng.rand(n, n) < 0.6)
  dense |= i == j
  if dense_block is not None:
    r0, c0, size = dense_block
    dense[r0:r0 + size, c0:c0 + size] = True
  return sp.csr_matrix(dense)


def _qkv(seed, n, heads=2, d=16, batch=1):
  rng = np.random.RandomState(seed)
  return [rng.randn(batch, n, heads, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n", [150, 192])
def test_block_map_covers_exactly_the_mask(n):
  """Unpacking the words gives the mask back; rows and columns past n
  (the padded tail of the last tile) are empty; full flags are exact."""
  mask = _banded_mask(n, 40, seed=n, dense_block=(64, 64, 64))
  bm = splash.build_block_map(mask)
  assert bm.n == n and bm.n_pad == -(-n // 64) * 64 and bm.nnz == mask.nnz
  dense = np.zeros((bm.n_pad, bm.n_pad), bool)
  bits = (bm.words[:, :, None] >> np.arange(64, dtype=np.uint64)) & 1
  for qt in range(bm.nq):
    for a in range(bm.kv_offsets[qt], bm.kv_offsets[qt + 1]):
      kt = bm.kv_index[a]
      dense[qt * 64:(qt + 1) * 64, kt * 64:(kt + 1) * 64] = bits[a] == 1
      assert bm.full[a] == bits[a].all()
      assert bits[a].any()
    kvs = bm.kv_index[bm.kv_offsets[qt]:bm.kv_offsets[qt + 1]]
    assert (np.diff(kvs) > 0).all()
  np.testing.assert_array_equal(dense[:n, :n], mask.toarray())
  assert not dense[n:].any() and not dense[:, n:].any()
  assert bm.full.any()  # the dense square fills the (1, 1) tile


@pytest.mark.parametrize("dtype_name", sorted(_DTYPES))
@pytest.mark.parametrize("n", [150, 256])
def test_plain_version_matches_jax_attention(n, dtype_name):
  jdtype, tdtype = _DTYPES[dtype_name]
  mask = _banded_mask(n, 48, seed=3 * n)
  q, k, v = _qkv(n, n)
  scale = 0.3
  want = {
      "reference": jax_splash.reference_masked_attention(
          *(jnp.asarray(x, jdtype) for x in (q, k, v)),
          jnp.asarray(mask.toarray()), scale=scale),
      "kernel": jax_splash.BlockSparseAttention.from_mask(
          mask, block_q=128, block_kv=128, interpret=True)(
              *(jnp.asarray(x, jdtype) for x in (q, k, v)), scale=scale),
  }
  got, lse = splash.block_sparse_attention(
      *(torch.from_numpy(x).to(tdtype) for x in (q, k, v)),
      splash.build_block_map(mask), scale)
  assert got.dtype == tdtype and got.shape == q.shape
  assert lse.dtype == torch.float32 and lse.shape == (1, 2, n)
  got = got.float().numpy()
  for name, w in want.items():
    w = np.asarray(w, np.float32)
    if dtype_name == "f32":
      np.testing.assert_allclose(got, w, rtol=2e-5, atol=2e-5, err_msg=name)
    else:
      d = got - w
      assert np.sqrt(np.mean(d * d) / np.mean(w * w)) <= 1e-2, name
      assert np.abs(d).max() <= 0.05, name


def test_lse_is_the_masked_logsumexp():
  n = 150
  mask = _banded_mask(n, 30, seed=5)
  q, k, v = _qkv(7, n, heads=3)
  scale = 0.25
  _, lse = splash.block_sparse_attention(
      *(torch.from_numpy(x) for x in (q, k, v)),
      splash.build_block_map(mask), scale)
  s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                k.astype(np.float64)) * scale
  s = np.where(mask.toarray()[None, None], s, -np.inf)
  m = s.max(-1, keepdims=True)
  want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
  np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cuda_only_inputs_are_checked_before_any_launch():
  """Non-CPU tensors never take the plain version: other devices are
  refused outright."""
  mask = _banded_mask(64, 8)
  q = torch.empty(1, 64, 4, 128, device="meta")
  with pytest.raises(ValueError, match="unsupported device"):
    splash.block_sparse_attention(q, q, q, splash.build_block_map(mask), 1.0)


def _asymmetric_mask(n, seed):
  """A random mask that is not symmetric (every row keeps its diagonal, so
  no row is empty), with a dense 64 x 64 square so one tile is full."""
  rng = np.random.RandomState(seed)
  dense = (rng.rand(n, n) < 0.08) | np.eye(n, dtype=bool)
  dense[64:128, 0:64] = True
  assert (dense != dense.T).any()
  return sp.csr_matrix(dense)


@pytest.mark.parametrize("n", [150, 192])
def test_transposed_map_covers_exactly_the_transposed_mask(n):
  """The transposed map unpacks to maskᵀ: for every kv tile, its active q
  tiles and one word per kv row (bit r: q row r attends it)."""
  mask = _asymmetric_mask(n, seed=n)
  bt = splash.build_block_map(mask).transposed
  assert bt.n == n and bt.nnz == mask.nnz and bt.transposed is None
  dense = np.zeros((bt.n_pad, bt.n_pad), bool)
  bits = (bt.words[:, :, None] >> np.arange(64, dtype=np.uint64)) & 1
  for kt in range(bt.nq):
    qts = bt.kv_index[bt.kv_offsets[kt]:bt.kv_offsets[kt + 1]]
    assert (np.diff(qts) > 0).all()
    for a in range(bt.kv_offsets[kt], bt.kv_offsets[kt + 1]):
      qt = bt.kv_index[a]
      dense[kt * 64:(kt + 1) * 64, qt * 64:(qt + 1) * 64] = bits[a] == 1
      assert bt.full[a] == bits[a].all() and bits[a].any()
  np.testing.assert_array_equal(dense[:n, :n], mask.toarray().T)
  assert not dense[n:].any() and not dense[:, n:].any()
  assert bt.full.any()  # the dense square, transposed: kv tile 0, q tile 1


def _jax_attention_grads(mask, q, k, v, do, scale, jdtype):
  attn = jax_splash.BlockSparseAttention.from_mask(
      mask, block_q=128, block_kv=128, interpret=True)
  _, vjp = jax.vjp(lambda q, k, v: attn(q, k, v, scale=scale),
                   *(jnp.asarray(x, jdtype) for x in (q, k, v)))
  return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do, jdtype))]


@pytest.mark.parametrize("dtype_name", sorted(_DTYPES))
@pytest.mark.parametrize("mask_kind", ["banded", "asymmetric"])
def test_plain_backward_matches_jax_vjp(mask_kind, dtype_name):
  """(dq, dk, dv) of the plain K7/K8 against jax.vjp of the JAX attention
  (Pallas backward kernels, interpret mode)."""
  jdtype, tdtype = _DTYPES[dtype_name]
  n = 200
  mask = (_banded_mask(n, 40, seed=8) if mask_kind == "banded"
          else _asymmetric_mask(n, seed=9))
  q, k, v = _qkv(10, n)
  do = np.random.RandomState(11).randn(*q.shape).astype(np.float32)
  scale = 0.3
  want = _jax_attention_grads(mask, q, k, v, do, scale, jdtype)
  bm = splash.build_block_map(mask)
  t = [torch.from_numpy(x).to(tdtype) for x in (q, k, v)]
  o, lse = splash.block_sparse_attention(*t, bm, scale)
  got = splash.block_sparse_attention_backward_reference(
      *t, o, lse, torch.from_numpy(do).to(tdtype), bm, scale)
  for name, g, w in zip(("dq", "dk", "dv"), got, want):
    assert g.dtype == tdtype and g.shape == q.shape, name
    g = g.float().numpy()
    if dtype_name == "f32":
      np.testing.assert_allclose(g, w, rtol=1e-4,
                                 atol=1e-4 * np.abs(w).max(), err_msg=name)
    else:
      rel = np.sqrt(np.mean((g - w) ** 2) / np.mean(w * w))
      assert rel <= 2e-2, (name, rel)


def test_attention_is_differentiable_on_the_cpu_through_its_function():
  """On CPU tensors that require grad, the autograd Function runs the plain
  forward and the plain backward: torch.autograd.grad gives what
  block_sparse_attention_backward_reference gives, and lse carries no
  gradient."""
  n = 150
  mask = _asymmetric_mask(n, seed=12)
  bm = splash.build_block_map(mask)
  q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(13, n))
  o, lse = splash.block_sparse_attention(q, k, v, bm, 0.25)
  assert not lse.requires_grad
  do = torch.from_numpy(
      np.random.RandomState(14).randn(*o.shape).astype(np.float32))
  got = torch.autograd.grad(o, (q, k, v), do)
  with torch.no_grad():
    want = splash.block_sparse_attention_backward_reference(
        q, k, v, o, lse, do, bm, 0.25)
  for g, w in zip(got, want):
    assert torch.equal(g, w)


def _skewed_band_mask(n, seed):
  """An asymmetric banded mask: row i attends 60 % of columns i - 40 ..
  i + 160 and itself, plus a dense 64 x 64 square below the diagonal, so
  list lengths vary at the edges and the transposed map differs."""
  rng = np.random.RandomState(seed)
  i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
  dense = ((j - i >= -40) & (j - i <= 160) & (rng.rand(n, n) < 0.6))
  dense |= i == j
  dense[64:128, 0:64] = True
  assert (dense != dense.T).any()
  return sp.csr_matrix(dense)


def _work_map(n, mask_kind, which):
  """The BlockMap whose paired lists a kernel walks: K6 and K7 the forward
  map's, K8 the transposed map's."""
  mask = (_banded_mask(n, 100, seed=n, dense_block=(0, 0, 64))
          if mask_kind == "banded" else _skewed_band_mask(n, seed=n))
  bm = splash.build_block_map(mask)
  return bm if which == "forward" else bm.transposed


_MAPS = pytest.mark.parametrize("which", ["forward", "transposed"])
_MASKS = pytest.mark.parametrize("mask_kind", ["banded", "asymmetric"])


@_MAPS
@_MASKS
@pytest.mark.parametrize("n", [640, 700, 1000])
def test_paired_lists_hold_every_pair_once(n, mask_kind, which):
  """The work lists of K6 and K7 (forward map) and of K8 (transposed map):
  group g walks the union of tiles 2g and 2g + 1's lists in ascending
  order; each active pair of the map sits exactly once in its group, in
  its tile's column, beside its own partner tile; every entry holds a pair
  of at least one tile; an odd last tile (n 700: 11 tiles) has no
  partner."""
  bm = _work_map(n, mask_kind, which)
  lists = splash.paired_lists(bm)
  groups = -(-bm.nq // 2)
  assert lists.offsets.shape == (groups + 1,) and lists.offsets[0] == 0
  assert lists.pairs.shape == (lists.offsets[-1], 2)
  seen = np.zeros(bm.n_active, int)
  for g in range(groups):
    e0, e1 = lists.offsets[g], lists.offsets[g + 1]
    assert (np.diff(lists.kv[e0:e1]) > 0).all()
    for e in range(e0, e1):
      assert (lists.pairs[e] >= 0).any()
      for w in range(2):
        a = lists.pairs[e, w]
        if a < 0:
          continue
        seen[a] += 1
        assert bm.kv_offsets[2 * g + w] <= a < bm.kv_offsets[2 * g + w + 1]
        assert bm.kv_index[a] == lists.kv[e]
  assert (seen == 1).all()
  assert lists.offsets[-1] < bm.n_active  # neighbouring tiles share kv tiles
  if bm.nq % 2:
    assert (lists.pairs[lists.offsets[-2]:, 1] == -1).all()


@_MAPS
@_MASKS
@pytest.mark.parametrize("n", [640, 700, 1000])
def test_heaviest_first_orders_groups_by_list_length(n, mask_kind, which):
  """The launch order of K6, K7 (forward map) and K8 (transposed map) is a
  permutation of the tile pairs, non-increasing in union list length, ties
  in order."""
  lists = splash.paired_lists(_work_map(n, mask_kind, which))
  order = lists.order
  assert order.dtype == np.int32
  np.testing.assert_array_equal(np.sort(order), np.arange(len(order)))
  counts = np.diff(lists.offsets)[order]
  assert (np.diff(counts) <= 0).all()
  for c in np.unique(counts):
    assert (np.diff(order[counts == c]) > 0).all()
  assert len(np.unique(counts)) > 1  # the order is not moot


def test_device_maps_hold_the_paired_lists_of_both_maps():
  """K7 reads the forward map's words and paired lists on the device, K8
  the transposed map's: each map builds its own, once per device."""
  bm = splash.build_block_map(_skewed_band_mask(700, seed=3))
  for m in (bm, bm.transposed):
    dm = m.on_device("cpu")
    assert m.on_device("cpu") is dm
    lists = splash.paired_lists(m)
    assert dm.groups == len(lists.order) == -(-m.nq // 2)
    for name in ("offsets", "kv", "pairs", "order"):
      np.testing.assert_array_equal(getattr(dm, "group_" + name).numpy(),
                                    getattr(lists, name))
    np.testing.assert_array_equal(dm.words.numpy().view(np.uint64), m.words)
    np.testing.assert_array_equal(dm.full.numpy(), m.full)


def _paired_walk(m):
  """The entries of K7's (forward map) or K8's (transposed map) blocks as
  their consumer warpgroups take them: per group, heaviest first, per union
  entry, each of the group's tiles with the entry's tile and its pair's
  mask ([TILE, TILE] bool), all False where the tile has no pair there."""
  lists = splash.paired_lists(m)
  words = torch.from_numpy(m.words.view(np.int64))
  for g in lists.order:
    for e in range(lists.offsets[g], lists.offsets[g + 1]):
      for w in range(2):
        own, a = 2 * g + w, lists.pairs[e, w]
        if own >= m.nq:
          continue
        allowed = (splash._allowed(words[a:a + 1]) if a >= 0 else
                   torch.zeros(splash.TILE, splash.TILE, dtype=torch.bool))
        yield own, lists.kv[e], allowed


@_MASKS
@pytest.mark.parametrize("n", [640, 700])
def test_paired_walk_gives_the_plain_backward(n, mask_kind):
  """K7's and K8's plan, emulated in f32: summing every entry of every
  group's union list, with all-zero words where a tile has no pair, gives
  the plain backward's dq (over the forward map) and dk, dv (over the
  transposed map): the absent pairs add exactly nothing and no pair is
  missed. Tolerance 1e-5 of each gradient's largest element (f32
  summation order only)."""
  mask = (_banded_mask(n, 100, seed=n, dense_block=(0, 0, 64))
          if mask_kind == "banded" else _skewed_band_mask(n, seed=n))
  bm = splash.build_block_map(mask)
  q, k, v = (torch.from_numpy(x) for x in _qkv(n + 5, n))
  do = torch.from_numpy(
      np.random.RandomState(n + 6).randn(*q.shape).astype(np.float32))
  scale = 0.3
  o, lse = splash.block_sparse_attention_reference(q, k, v, bm, scale)
  qf, kf, vf, dof, delta, lsep = splash._backward_operands(
      q, k, v, o, lse, do, bm)

  def rows(t):
    return slice(t * splash.TILE, (t + 1) * splash.TILE)

  dq = torch.zeros_like(qf)
  for qt, kt, allowed in _paired_walk(bm):
    s = torch.einsum("bqhd,bkhd->bhqk", qf[:, rows(qt)], kf[:, rows(kt)])
    p = torch.where(allowed, torch.exp(s * scale - lsep[..., rows(qt), None]),
                    torch.zeros(()))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, rows(qt)], vf[:, rows(kt)])
    ds = p * (dp - delta[..., rows(qt), None]) * scale
    dq[:, rows(qt)] += torch.einsum("bhqk,bkhd->bqhd", ds, kf[:, rows(kt)])
  dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
  for kt, qt, allowed in _paired_walk(bm.transposed):  # [kv row, q row]
    st = torch.einsum("bkhd,bqhd->bhkq", kf[:, rows(kt)], qf[:, rows(qt)])
    pt = torch.where(allowed,
                     torch.exp(st * scale - lsep[..., None, rows(qt)]),
                     torch.zeros(()))
    dpt = torch.einsum("bkhd,bqhd->bhkq", vf[:, rows(kt)], dof[:, rows(qt)])
    dst = pt * (dpt - delta[..., None, rows(qt)]) * scale
    dv[:, rows(kt)] += torch.einsum("bhkq,bqhd->bkhd", pt, dof[:, rows(qt)])
    dk[:, rows(kt)] += torch.einsum("bhkq,bqhd->bkhd", dst, qf[:, rows(qt)])
  want = splash.block_sparse_attention_backward_reference(
      q, k, v, o, lse, do, bm, scale)
  for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
    assert not g[:, n:].any(), name  # the padded rows get exactly 0
    np.testing.assert_allclose(g[:, :n].numpy(), w.numpy(), rtol=0,
                               atol=1e-5 * w.abs().max().item(),
                               err_msg=name)


def test_heaviest_first_keeps_empty_rows_last():
  """A row with no entries (q tiles that attend nothing) is launched too,
  after every row with entries."""
  np.testing.assert_array_equal(
      splash.heaviest_first(np.array([0, 4, 4, 6, 6])), [0, 2, 1, 3])


def _jax_tile(mask_blocks, row, block=64):
  """The [q row, kv column] bool tile of a JAX bitmap-table row (0: the
  full block; rows packed as splash._build_block_map packs them)."""
  if row == 0:
    return np.ones((block, block), bool)
  gw = block // 32
  r = np.arange(block)
  return ((mask_blocks[row][r % gw] >> (r // gw)[:, None].astype(np.uint32))
          & 1).astype(bool)


def _port_tile(words_row):
  """[row, column] bool tile of a port pair's 64 words."""
  return ((words_row[:, None] >> np.arange(64, dtype=np.uint64)) & 1
          ).astype(bool)


@pytest.mark.parametrize("num_shards", [1, 2, 4])
@pytest.mark.parametrize("n", [512, 300])
def test_shard_maps_match_jax_shard_transposed_maps(n, num_shards):
  """Each shard's map (its q tiles against every kv tile) and transposed
  map (every kv tile against its q tiles, renumbered from 0) hold the
  entries of the JAX package's per-shard maps (BlockSparseAttention's
  kv_index/mask_rows split by shard, _build_shard_transposed_maps) at
  64 x 64 blocks, pair for pair and bit for bit. At n = 300 the 5 q tiles
  do not divide over 2 or 4 shards: the port pads them with empty tiles,
  where JAX raises, so its maps are built on the mask padded to the
  shards' rows (the padding nodes attend nothing)."""
  mask = sp.csr_matrix(_banded_mask(n, 48, seed=n).toarray())
  tiles = splash.shard_tiles(n, num_shards)
  n_jax = tiles * num_shards * 64
  padded = sp.csr_matrix((mask.data, mask.indices, np.r_[
      mask.indptr, np.full(n_jax - n, mask.indptr[-1])]), shape=(n_jax,
                                                                 n_jax))
  m = jax_splash.BlockSparseAttention.from_mask(
      padded, block_q=64, block_kv=64, interpret=True)._map
  q_index, q_count, rows_t, _ = jax_splash._build_shard_transposed_maps(
      m, num_shards)
  bm = splash.build_block_map(mask)
  shards = splash.shard_block_maps(bm, num_shards)
  assert [s.n for s in shards] == [b - a for a, b in
                                   splash.shard_rows(n, num_shards)]
  assert sum(s.nnz for s in shards) == bm.nnz == sum(
      s.transposed.nnz for s in shards)
  for s, shard in enumerate(shards):
    assert shard.nq == tiles and shard.nkv == bm.nkv
    for t in range(tiles):  # the forward map: q tile t of the shard
      i = s * tiles + t
      lo, hi = shard.kv_offsets[t], shard.kv_offsets[t + 1]
      count = m["kv_count"][i]
      np.testing.assert_array_equal(shard.kv_index[lo:hi],
                                    m["kv_index"][i, :count])
      for a, slot in zip(range(lo, hi), range(count)):
        np.testing.assert_array_equal(
            _port_tile(shard.words[a]),
            _jax_tile(m["mask_blocks"], m["mask_rows"][i, slot]))
    bt = shard.transposed
    assert bt.nq == bm.nkv and bt.nkv == tiles
    for j in range(m["nkv"]):  # the transposed map: kv tile j
      count = q_count[s, j]
      if j >= bt.nq:  # JAX's padding tiles attend and are attended by none
        assert count == 0
        continue
      lo, hi = bt.kv_offsets[j], bt.kv_offsets[j + 1]
      np.testing.assert_array_equal(bt.kv_index[lo:hi],
                                    q_index[s, j, :count])
      for a, slot in zip(range(lo, hi), range(count)):
        np.testing.assert_array_equal(
            _port_tile(bt.words[a]).T,
            _jax_tile(m["mask_blocks"], rows_t[s, j, slot]))


@pytest.mark.parametrize("n", [256, 300])
def test_sequence_parallel_attention_matches_unsharded_and_jax(n, tmp_path):
  """SequenceParallelAttention over 2 gloo processes (q, k and v split by
  rows, k and v gathered, dk and dv partials summed over the group): its
  gathered output equals the unsharded plain version bit for bit (each q
  row meets the same kv tiles in the same order) and its q, k and v
  gradients equal the unsharded plain backward's (1e-6); both within the
  JAX test's 2e-4 / 2e-3 (tests/test_splash.py:329) of the JAX
  package's SequenceParallelAttention over 2 devices (n = 256: 4 q tiles)
  or, where the q tiles do not divide over the shards (n = 300), of its
  unsharded attention."""
  import torch_parallel_workers as workers
  from graphcast_tpu_torch.parallel import launch
  mask = _banded_mask(n, 48, seed=4)
  rng = np.random.RandomState(0)
  q, k, v, target = (rng.randn(1, n, 1, 128).astype(np.float32)
                     for _ in range(4))
  scale = 128 ** -0.5
  workers.save(tmp_path, "attention", mask=mask.toarray(), q=q, k=k, v=v,
               target=target, scale=np.array(scale))
  launch.spawn(workers.sp_attention, 2, args=(str(tmp_path),), device="cpu",
               init_method=f"file://{tmp_path}/rendezvous", timeout_s=60)
  ranks = [workers.load(tmp_path, f"attn{r}") for r in range(2)]

  # The port's unsharded plain version.
  tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
  o, _ = splash.block_sparse_attention(tq, tk, tv,
                                       splash.build_block_map(mask), scale)
  ((o - torch.from_numpy(target)) ** 2).sum().backward()
  for got in ranks:
    np.testing.assert_array_equal(got["o"], o.detach().numpy())
    for name, t in (("dq", tq), ("dk", tk), ("dv", tv)):
      np.testing.assert_allclose(got[name], t.grad.numpy(), rtol=1e-6,
                                 atol=1e-6, err_msg=name)

  # The JAX package's.
  attn = jax_splash.BlockSparseAttention.from_mask(mask, block_q=64,
                                                   block_kv=64,
                                                   interpret=True)
  if n == 256:
    from graphcast_tpu.parallel import sharding as jax_sharding
    fn = attn.sequence_parallel(
        jax_sharding.make_mesh({"sp": 2}, devices=jax.devices()[:2]), "sp")
  else:
    fn = attn

  def loss(q, k, v):
    return jnp.sum((fn(q, k, v, scale=scale) - target) ** 2)

  want_o = fn(*(jnp.asarray(x) for x in (q, k, v)), scale=scale)
  grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                              for x in (q, k, v)))
  np.testing.assert_allclose(ranks[0]["o"], np.asarray(want_o), rtol=2e-4,
                             atol=2e-4)
  for name, g in zip(("dq", "dk", "dv"), grads):
    np.testing.assert_allclose(ranks[0][name], np.asarray(g), rtol=2e-3,
                               atol=2e-3, err_msg=name)
