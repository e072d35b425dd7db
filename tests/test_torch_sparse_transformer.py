"""The port's sparse transformer (models/sparse_transformer.py) and
MeshTransformer (models/transformer.py) against the JAX package's, on the
same numpy weights and inputs, with the "mha", "triblockdiag_mha" and
"splash_mha" backends (the JAX splash kernel in Pallas interpret mode);
the tri-block backend also in its gradients, against JAX and against the
port's own "mha" on the same mask.

The released init makes ``mha_final``, ``ffw_down`` and every norm
conditioning about zero (final init multipliers 0, conditioning stddev
1e-8), which would let attention and conditioning vanish from the output;
these tests overwrite them with seeded draws of stddev 1/sqrt(fan_in), in
both packages through ``params_from_jax``.

Tolerance: f32 5e-4 (relative to the output's largest element), the port's
standing f32 bound; the two differ in summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_tpu.models import sparse_transformer as jax_st
from graphcast_tpu.models import transformer as jax_transformer
from graphcast_tpu_torch import params
from graphcast_tpu_torch.geometry import artifact, icosahedron
from graphcast_tpu_torch.models import sparse_transformer, transformer

_DEGENERATE = ("norm_conditioning", "mha_final", "ffw_down")


def nondegenerate(flat: dict, seed: int) -> dict:
  """Replaces the near-zero-initialised weights of a flat param dict with
  seeded draws of stddev 1/sqrt(fan_in)."""
  rng = np.random.RandomState(seed)
  out = dict(flat)
  for key in sorted(flat):
    if any(part in key for part in _DEGENERATE):
      w = flat[key.rsplit("/", 1)[0] + "/w"]
      out[key] = (rng.randn(*flat[key].shape)
                  / np.sqrt(w.shape[0])).astype(np.float32)
  return out


def nest(flat: dict) -> dict:
  tree: dict = {}
  for key, v in flat.items():
    node = tree
    *path, leaf = key.split("/")
    for part in path:
      node = node.setdefault(part, {})
    node[leaf] = jnp.asarray(v)
  return tree


def _mesh(mesh_size, patch):
  mesh = artifact.permute_mesh_to_banded(
      icosahedron.get_mesh_hierarchy(mesh_size)[-1],
      patch_size=64 if patch else None)
  senders, receivers = icosahedron.faces_to_edges(mesh.faces)
  return senders, receivers, mesh.vertices.shape[0]


def _cfg(attention_type):
  return dict(attention_k_hop=2, d_model=32, num_layers=2, num_heads=2,
              attention_type=attention_type, ffw_hidden=64, block_q=64)


def _jax_cfg(attention_type):
  """The JAX config also tiles its Pallas kernel (block_kv)."""
  return jax_st.SparseTransformerConfig(**_cfg(attention_type), block_kv=64)


def _weights(jax_tree, seed):
  return nondegenerate(params.params_from_jax(
      jax.tree_util.tree_map(np.asarray, jax_tree)), seed)


@pytest.mark.parametrize("attention_type",
                         ["mha", "triblockdiag_mha", "splash_mha"])
def test_transformer_matches_jax(attention_type):
  senders, receivers, n = _mesh(2, patch=True)
  adj = transformer.adjacency_from_edges(senders, receivers, n)
  cond_size = 5
  jt = jax_st.Transformer(adj, _jax_cfg(attention_type), interpret=True)
  flat = _weights(jt.init(jax.random.PRNGKey(0), cond_size), seed=1)
  rng = np.random.RandomState(2)
  x = rng.randn(1, n, 32).astype(np.float32)
  cond = rng.randn(1, cond_size).astype(np.float32)
  want = np.asarray(jt.apply(nest(flat), jnp.asarray(x), jnp.asarray(cond)))

  port = sparse_transformer.Transformer(
      sparse_transformer.SparseTransformerConfig(**_cfg(attention_type)),
      cond_size)
  params.load_params(port, flat)
  port.prepare_mask(adj)
  with torch.inference_mode():
    got = port(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
  assert np.abs(want - np.asarray(x)).max() > 0.1  # the blocks act
  np.testing.assert_allclose(got, want, rtol=5e-4,
                             atol=5e-4 * np.abs(want).max())


@pytest.mark.parametrize("patch", [False, True])
def test_mesh_transformer_matches_jax(patch):
  """[nodes, batch, d] in and out, over the banded (RCM) or patch-ordered
  mesh, splash backend."""
  senders, receivers, n = _mesh(1, patch)
  cond_size = 4
  cfg = _cfg("splash_mha")
  jt = jax_transformer.MeshTransformer(
      senders, receivers, n, _jax_cfg("splash_mha"), interpret=True)
  flat = _weights(jt.init(jax.random.PRNGKey(3), cond_size), seed=4)
  rng = np.random.RandomState(5)
  x = rng.randn(n, 1, 32).astype(np.float32)
  cond = rng.randn(1, cond_size).astype(np.float32)
  want = np.asarray(jt.apply(nest(flat), jnp.asarray(x), jnp.asarray(cond)))

  port = transformer.MeshTransformer(
      sparse_transformer.SparseTransformerConfig(**cfg), cond_size)
  params.load_params(port, flat)
  port.prepare(senders, receivers, n)
  with torch.inference_mode():
    got = port(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
  assert got.shape == (n, 1, 32)
  np.testing.assert_allclose(got, want, rtol=5e-4,
                             atol=5e-4 * np.abs(want).max())


def test_k_hop_adjacency_equals_jax():
  senders, receivers, n = _mesh(2, patch=False)
  adj = transformer.adjacency_from_edges(senders, receivers, n)
  for k in (1, 2, 4):
    got = sparse_transformer.k_hop_adjacency_from_matrix(adj, k)
    want = jax_st.k_hop_adjacency_from_matrix(adj, k)
    assert (got != want).nnz == 0


def _port_transformer(attention_type, flat, adj, cond_size):
  port = sparse_transformer.Transformer(
      sparse_transformer.SparseTransformerConfig(**_cfg(attention_type)),
      cond_size)
  params.load_params(port, flat)
  port.prepare_mask(adj)
  return port


def _port_value_and_grads(port, x, cond, cot):
  """The output and the gradients of sum(out * cot) in x and every
  parameter, {flat key or "x": array}."""
  x = torch.from_numpy(x).requires_grad_(True)
  out = port(x, torch.from_numpy(cond))
  leaves = {"x": x, **params.flat_params(port)}
  grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                              list(leaves.values()))
  return out.detach().numpy(), {k: g.numpy() for k, g in zip(leaves, grads)}


def _assert_grads_close(got, want):
  assert set(got) == set(want)
  for key in want:
    w = np.asarray(want[key])
    np.testing.assert_allclose(got[key], w, rtol=5e-4,
                               atol=5e-4 * np.abs(w).max(), err_msg=key)


def _triblock_case():
  senders, receivers, n = _mesh(2, patch=True)
  adj = transformer.adjacency_from_edges(senders, receivers, n)
  cond_size = 5
  jt = jax_st.Transformer(adj, _jax_cfg("triblockdiag_mha"))
  flat = _weights(jt.init(jax.random.PRNGKey(6), cond_size), seed=7)
  rng = np.random.RandomState(8)
  x = rng.randn(2, n, 32).astype(np.float32)
  cond = rng.randn(2, cond_size).astype(np.float32)
  cot = rng.randn(2, n, 32).astype(np.float32)
  return jt, flat, adj, cond_size, x, cond, cot


def test_triblockdiag_gradients_match_jax():
  jt, flat, adj, cond_size, x, cond, cot = _triblock_case()

  def loss(tree, xs):
    return jnp.sum(jt.apply(tree, xs, jnp.asarray(cond)) * cot)

  tree_grads, x_grad = jax.grad(loss, argnums=(0, 1))(nest(flat),
                                                      jnp.asarray(x))
  want = {**params.params_from_jax(
      jax.tree_util.tree_map(np.asarray, tree_grads)), "x": x_grad}
  port = _port_transformer("triblockdiag_mha", flat, adj, cond_size)
  _, got = _port_value_and_grads(port, x, cond, cot)
  assert np.abs(got["x"]).max() > 0
  _assert_grads_close(got, want)


def test_triblockdiag_matches_port_mha_on_the_same_mask():
  _, flat, adj, cond_size, x, cond, cot = _triblock_case()
  tri = _port_transformer("triblockdiag_mha", flat, adj, cond_size)
  assert tri._num_padding > 0  # the last block is padded
  out_t, grads_t = _port_value_and_grads(tri, x, cond, cot)
  out_m, grads_m = _port_value_and_grads(
      _port_transformer("mha", flat, adj, cond_size), x, cond, cot)
  np.testing.assert_allclose(out_t, out_m, rtol=5e-4,
                             atol=5e-4 * np.abs(out_m).max())
  _assert_grads_close(grads_t, grads_m)


@pytest.mark.parametrize("k_hop", [1, 2, 4])
def test_triblock_masks_equal_jax(k_hop):
  senders, receivers, n = _mesh(2, patch=False)
  mask = sparse_transformer.k_hop_adjacency_from_matrix(
      transformer.adjacency_from_edges(senders, receivers, n), k_hop)
  size = sparse_transformer.get_mask_block_size(mask)
  assert size == jax_st.get_mask_block_size(mask)
  got, pad = sparse_transformer.build_triblock_masks(mask, size)
  want, want_pad = jax_st.build_triblock_masks(mask, size)
  assert pad == want_pad
  np.testing.assert_array_equal(got, want)
  assert got.sum() == mask.nnz
  with pytest.raises(ValueError, match="tri-block band"):
    sparse_transformer.build_triblock_masks(mask, max(1, size // 3))


def test_prepared_mask_is_shared_by_content(monkeypatch):
  """Transformers of one adjacency, k-hop and backend share the mask
  built for the first; the adjacency is keyed by content (edge order and
  duplicates aside)."""
  monkeypatch.setattr(sparse_transformer, "_MASKS",
                      type(sparse_transformer._MASKS)())
  senders, receivers, n = _mesh(2, patch=True)
  adj = transformer.adjacency_from_edges(senders, receivers, n)
  order = np.random.RandomState(0).permutation(senders.size)
  shuffled = transformer.adjacency_from_edges(
      np.concatenate([senders[order], senders[:5]]),
      np.concatenate([receivers[order], receivers[:5]]), n)
  cfg = sparse_transformer.SparseTransformerConfig(**_cfg("splash_mha"))
  one, two = (sparse_transformer.Transformer(cfg, 3) for _ in range(2))
  one.prepare_mask(adj)
  two.prepare_mask(shuffled)
  assert one._block_map is two._block_map
  other = sparse_transformer.prepared_mask(adj, 1, "splash_mha")
  assert other["block_map"] is not one._block_map
  tri = sparse_transformer.prepared_mask(adj, 2, "triblockdiag_mha")
  want = sparse_transformer.build_triblock_masks(
      sparse_transformer.k_hop_adjacency_from_matrix(adj, 2),
      tri["block_size"])[0]
  np.testing.assert_array_equal(tri["triblock"], want)
