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
