"""GenCast's defined products (``mfu.ensemble``): those of one denoiser
evaluation of one member, as the paper defines the network: each graph MLP
on its concatenated inputs, once per edge or node of its set; in each
transformer layer the four d_model x d_model projections and the two
feed-forward layers once per mesh node, and the attention's two products
(q·kᵀ and the weights times v) once per pair of the k-hop mask. The noise
encoder, the norm conditionings' maps of the noise-level encoding, the
spherical-harmonic noise, elementwise work, norms and sums are not
counted. The decoder's mesh-node update, which feeds no output, is left
out. A 12 h sample makes ``evaluations`` evaluations."""


def evaluations(sampler: dict) -> int:
  """Denoiser evaluations of one sample: two a noise level, one at the
  last, where the next level is 0."""
  return 2 * sampler["num_noise_levels"] - 1


def forward_flops(sizes: dict, cfg: dict) -> float:
  """Operations of one evaluation of one member; ``sizes``: num_grid,
  num_mesh, the edge counts g2m and m2g and ``mask_nnz``; ``cfg``:
  latent_size, node_in (structural features included), outputs, and the
  transformer's d_model, num_layers and ffw_hidden."""
  C = cfg["latent_size"]
  G, M = sizes["num_grid"], sizes["num_mesh"]
  E1, E2, P = sizes["g2m"], sizes["m2g"], sizes["mask_nnz"]
  n_in, NO = cfg["node_in"], cfg["outputs"]
  D, L, H = cfg["d_model"], cfg["num_layers"], cfg["ffw_hidden"]

  def mlp(rows, n_in, n_out=C):
    return rows * (n_in * C + C * n_out)

  macs = (mlp(G, n_in) + mlp(M, n_in)                 # node embeddings
          + mlp(E1, 4) + mlp(E1, 3 * C)               # grid2mesh edges
          + mlp(M, 2 * C) + mlp(G, C)                 # node updates
          + L * (4 * M * D * D + 2 * P * D + 2 * M * D * H)   # transformer
          + mlp(E2, 4) + mlp(E2, 3 * C) + mlp(G, 2 * C)       # mesh2grid
          + mlp(G, C, NO))                            # output MLP
  return 2.0 * macs
