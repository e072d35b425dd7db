"""graphcast_tpu_torch.ops.weight_grad (the reduction K4 and K5 share) on
the CPU, against the product the Pallas backward kernels accumulate
(pallas_edge.py:425-427: ``dot_general`` of bf16 row operands contracting
the rows, f32 result).

Inputs are made from a numpy seed and rounded to bf16 once, so both sides
multiply the same values; bf16 products are exact in f32 and only the order
of the f32 sums differs: rtol 1e-5, atol 1e-5 of the sums' scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
