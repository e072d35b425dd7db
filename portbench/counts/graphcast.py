"""GraphCast's defined products a step (``mfu.forecast``, ``mfu.train``):
each MLP on its concatenated inputs, once per edge or node of its set,
as the paper defines the model; the static edge embeddings are counted in
every step, as the definition computes them. Elementwise work, norms and
sums are not counted. The decoder's mesh-node update, which feeds no
output, is left out."""


def forward_flops(sizes: dict, cfg: dict, batch: int = 1) -> float:
  """Operations of one forward step; ``sizes``: num_grid, num_mesh and the
  edge counts g2m, mesh, m2g; ``cfg``: latent_size, gnn_msg_steps, the
  grid input channels (``node_in``, structural features included) and
  ``outputs``."""
  C = cfg["latent_size"]
  G, M = sizes["num_grid"], sizes["num_mesh"]
  E1, Em, E2 = sizes["g2m"], sizes["mesh"], sizes["m2g"]
  n_in, NO = cfg["node_in"], cfg["outputs"]

  def mlp(rows, n_in, n_out=C):
    return rows * (n_in * C + C * n_out)

  macs = (mlp(G, n_in) + mlp(M, n_in)                 # node embeddings
          + mlp(E1, 4) + mlp(E1, 3 * C)               # grid2mesh edges
          + mlp(M, 2 * C) + mlp(G, C)                 # node updates
          + mlp(Em, 4)                                # mesh edge embedding
          + cfg["gnn_msg_steps"] * (mlp(Em, 3 * C) + mlp(M, 2 * C))
          + mlp(E2, 4) + mlp(E2, 3 * C) + mlp(G, 2 * C)   # mesh2grid
          + mlp(G, C, NO))                            # output MLP
  return 2.0 * macs * batch


def train_flops(sizes: dict, cfg: dict, batch: int = 1) -> float:
  """A training step: the forward and its backward, three forwards."""
  return 3.0 * forward_flops(sizes, cfg, batch)
