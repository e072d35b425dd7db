"""graphcast_tpu_torch.ops.weight_grad (the reduction K4 and K5 share) on
the CPU, against the product the Pallas backward kernels accumulate
(pallas_edge.py:425-427: ``dot_general`` of bf16 row operands contracting
the rows, f32 result).

Inputs are made from a numpy seed and rounded to bf16 once, so both sides
multiply the same values; bf16 products are exact in f32 and only the order
of the f32 sums differs: rtol 1e-5, atol 1e-5 of the sums' scale.

Also the kernel's host-side work plan (``plan``): its row ranges cover each
row once per dW tile, and run with the plain product (``run_plan_reference``)
it gives the plain version's sums, to the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_tpu_torch.ops import weight_grad as wg
from graphcast_tpu_torch.ops.weight_grad import weight_grad


@pytest.mark.parametrize("rows,k,n", [(300, 128, 256), (1, 256, 128)])
def test_weight_grad_matches_pallas_product(rows, k, n):
  rng = np.random.RandomState(rows)
  a = torch.tensor(rng.randn(rows, k), dtype=torch.bfloat16)
  b = torch.tensor(rng.randn(rows, n), dtype=torch.bfloat16)
  init = rng.randn(k, n).astype(np.float32)
  out = torch.tensor(init)
  weight_grad(a, b, out)
  want = init + np.asarray(jax.lax.dot_general(
      jnp.asarray(a.float().numpy(), jnp.bfloat16),
      jnp.asarray(b.float().numpy(), jnp.bfloat16),
      (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32))
  scale = np.sqrt(np.mean(want ** 2))
  np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5 * scale)


def test_weight_grad_rejects_bad_shapes():
  a = torch.zeros(8, 128, dtype=torch.bfloat16)
  with pytest.raises(ValueError):
    weight_grad(a, torch.zeros(7, 128, dtype=torch.bfloat16),
                torch.zeros(128, 128))
  with pytest.raises(ValueError):  # N not a multiple of 128
    weight_grad(a, torch.zeros(8, 100, dtype=torch.bfloat16),
                torch.zeros(128, 100))


_PLAN_CASES = [(1, 128, 128), (63, 128, 128), (64, 384, 256),
               (5000, 512, 512), (262_161, 512, 512), (131_072, 512, 256),
               (300, 128, 384)]


@pytest.mark.parametrize("num_sms", [1, 16, 132])
@pytest.mark.parametrize("rows,k,n", _PLAN_CASES)
def test_plan_covers_every_row_once_per_tile(rows, k, n, num_sms):
  """Each dW tile's row ranges start on a slab and tile [0, R) exactly, in
  row order; items are ordered range-major with every tile in each range
  (the layout the kernel's fixed-order reduction reads)."""
  work = wg.plan(rows, k, n, num_sms)
  items = work.items
  assert items.dtype == np.int32 and items.shape[1] == 4
  assert work.tile_n == (256 if n % 256 == 0 else 128)
  tiles = (k // wg.TILE_M) * (n // work.tile_n)
  assert len(items) == work.splits * tiles
  if num_sms >= tiles:
    assert len(items) <= max(num_sms, tiles)
  grid = items.reshape(work.splits, tiles, 4)
  # Every range holds the same tiles, in the same order, all of them.
  np.testing.assert_array_equal(grid[:, :, :2], grid[:1, :, :2].repeat(
      work.splits, 0))
  corners = {tuple(t) for t in grid[0, :, :2].tolist()}
  assert corners == {(k0, n0) for k0 in range(0, k, wg.TILE_M)
                     for n0 in range(0, n, work.tile_n)}
  for t in range(tiles):
    r0, r1 = grid[:, t, 2], grid[:, t, 3]
    assert r0[0] == 0 and r1[-1] == rows
    np.testing.assert_array_equal(r0[1:], r1[:-1])
    assert (r0 % wg.SLAB == 0).all() and (r1 > r0).all()
    covered = np.zeros(rows, int)
    for a, b in zip(r0, r1):
      covered[a:b] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("rows,k,n", [(1, 128, 128), (63, 384, 256),
                                      (5000, 128, 256), (777, 256, 384)])
def test_plan_run_with_the_plain_product_equals_the_reference(rows, k, n):
  """The plan's items as the kernel runs them (partial tiles, then the
  ranges summed in order), each with the plain product, give the plain
  version's out += a^T b on a nonzero out, to f32 reassociation."""
  rng = np.random.RandomState(rows + k + n)
  a = torch.tensor(rng.randn(rows, 2 * k), dtype=torch.bfloat16)[:, :k]
  b = torch.tensor(rng.randn(rows, n), dtype=torch.bfloat16)
  init = torch.tensor(rng.randn(k, n).astype(np.float32))
  got, want = init.clone(), init.clone()
  wg.run_plan_reference(a, b, got, wg.plan(rows, k, n, 16))
  wg.weight_grad_reference(a, b, want)
  scale = want.square().mean().sqrt().item()
  np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                             atol=1e-5 * scale)
