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


@pytest.mark.parametrize("n", [640, 700, 1000])
def test_paired_lists_hold_every_pair_once(n):
  """K6's work lists: group g walks the union of q tiles 2g and 2g + 1's
  kv lists in ascending order; each active pair of the map sits exactly
  once in its group, in its tile's column, beside its own kv tile; every
  entry holds a pair of at least one tile; an odd last tile has no
  partner."""
  bm = splash.build_block_map(_banded_mask(n, 100, seed=n,
                                           dense_block=(0, 0, 64)))
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


@pytest.mark.parametrize("n", [640, 1000])
def test_heaviest_first_orders_groups_by_list_length(n):
  """K6's launch order is a permutation of the q tile pairs,
  non-increasing in union list length, ties in order."""
  bm = splash.build_block_map(_banded_mask(n, 100, seed=n,
                                           dense_block=(0, 0, 64)))
  lists = splash.paired_lists(bm)
  order = lists.order
  assert order.dtype == np.int32
  np.testing.assert_array_equal(np.sort(order), np.arange(len(order)))
  counts = np.diff(lists.offsets)[order]
  assert (np.diff(counts) <= 0).all()
  for c in np.unique(counts):
    assert (np.diff(order[counts == c]) > 0).all()
  assert len(np.unique(counts)) > 1  # the order is not moot


def test_heaviest_first_keeps_empty_rows_last():
  """A row with no entries (q tiles that attend nothing) is launched too,
  after every row with entries."""
  np.testing.assert_array_equal(
      splash.heaviest_first(np.array([0, 4, 4, 6, 6])), [0, 2, 1, 3])
