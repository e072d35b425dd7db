"""Each kernel's and the model's counts against a count worked by hand at
a tiny size."""

import pytest

from portbench import peaks
from portbench.counts import gencast, graphcast, k1, k2, k4, k5, k6


def test_k1_processor_mode():
  # 10 edges, 3 senders = receivers, width 4: two 4x4 products a row.
  flops, nbytes = k1.count(10, 3, 3, 4)
  assert flops == 2 * 2 * 10 * 16                     # 640
  assert nbytes == (2 * 10 * 4 * 2 + 8 * 10 + 6 * 4 * 2 + 3 * 4 * 4
                    + 2 * 16 * 2)                     # 160+80+48+48+64


def test_k2_plain_mode():
  flops, nbytes = k2.count(5, 2, 4, 3)
  assert flops == 5 * (8 * 2 * 16 + 2 * 4 * 3)        # 8 4x4, one 4x3
  assert nbytes == (5 * 4 * 2 + 2 * 4 * 2 + 15 * 4 * 2 + 60 + 5 * 3 * 2
                    + (6 * 16 + 12) * 2)


def test_k4_counts_no_recomputed_forward():
  flops, nbytes = k4.count(10, 3, 3, 4)
  assert flops == 2 * 2 * 10 * 16   # dy·W1ᵀ and dx·Weᵀ only, not the forward
  assert nbytes == (160 + 80 + 48 + 48 + 160 + 48 + 160 + 64)


def test_k5_counts_no_recomputed_forward():
  flops, nbytes = k5.count(5, 2, 4, 3)
  assert flops == k2.count(5, 2, 4, 3)[0]   # one dX a forward product
  assert nbytes == (40 + 16 + 120 + 60 + 60 + 40 + 120 + 120 + 216)


def test_graphcast_defined_products():
  sizes = {"num_grid": 6, "num_mesh": 2, "g2m": 7, "mesh": 4, "m2g": 18}
  cfg = {"latent_size": 2, "gnn_msg_steps": 3, "node_in": 5, "outputs": 3}
  C = 2
  mlp = lambda rows, n_in, n_out=C: rows * (n_in * C + C * n_out)
  macs = (mlp(6, 5) + mlp(2, 5) + mlp(7, 4) + mlp(7, 6) + mlp(2, 4)
          + mlp(6, 2) + mlp(4, 4) + 3 * (mlp(4, 6) + mlp(2, 4))
          + mlp(18, 4) + mlp(18, 6) + mlp(6, 4) + mlp(6, 2, 3))
  assert graphcast.forward_flops(sizes, cfg) == 2 * macs
  assert graphcast.forward_flops(sizes, cfg, batch=4) == 8 * macs
  assert graphcast.train_flops(sizes, cfg) == 6 * macs


def test_bound_is_the_larger_of_operations_and_bytes():
  assert peaks.bound_s(989e12, 1.0) == pytest.approx(1.0)
  assert peaks.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_k6_forward():
  # 2 members, 3 heads, 5 nodes of head size 4, 9 mask pairs.
  flops, nbytes = k6.count(2, 3, 5, 4, 9)
  assert flops == 2 * 3 * 9 * 4 * 4        # q·kᵀ and p·v, 2 flops a MAC
  assert nbytes == 2 * (4 * 5 * 12 * 2 + 5 * 3 * 4)


def test_gencast_defined_products():
  sizes = {"num_grid": 6, "num_mesh": 2, "g2m": 7, "m2g": 18, "mask_nnz": 3}
  cfg = {"latent_size": 2, "node_in": 5, "outputs": 3, "d_model": 2,
         "num_layers": 3, "ffw_hidden": 4}
  C = 2
  mlp = lambda rows, n_in, n_out=C: rows * (n_in * C + C * n_out)
  layer = 4 * 2 * 2 * 2 + 2 * 3 * 2 + 2 * 2 * 2 * 4
  macs = (mlp(6, 5) + mlp(2, 5) + mlp(7, 4) + mlp(7, 6) + mlp(2, 4)
          + mlp(6, 2) + 3 * layer
          + mlp(18, 4) + mlp(18, 6) + mlp(6, 4) + mlp(6, 2, 3))
  assert gencast.forward_flops(sizes, cfg) == 2 * macs
  assert gencast.evaluations({"num_noise_levels": 20}) == 39
