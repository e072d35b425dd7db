"""MeshTransformer: the sparse transformer on mesh-node latents.

Port of graphcast_tpu/models/transformer.py (reference:
graphcast/transformer.py:34-124). ``prepare`` builds the boolean mesh
adjacency (plus self edges) from the static edge lists; ``forward``
transposes between the GNN layout [nodes, batch, latent] and the
transformer's batch-first [batch, nodes, latent]. Its parameters are the
Transformer's own, so the flat keys carry no extra level.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from graphcast_tpu_torch.models.sparse_transformer import Transformer


def adjacency_from_edges(senders: np.ndarray, receivers: np.ndarray,
                         num_nodes: int) -> sp.csr_matrix:
  """Boolean adjacency with self edges (reference: transformer.py:34-57)."""
  ones = np.ones(senders.shape[0], dtype=bool)
  adj = sp.csr_matrix((ones, (senders, receivers)),
                      shape=(num_nodes, num_nodes))
  adj = (adj + sp.identity(num_nodes, dtype=bool, format="csr")).astype(bool)
  return adj.tocsr()


class MeshTransformer(Transformer):
  """Transformer over the mesh nodes (reference: transformer.py:60-124)."""

  def prepare(self, senders: np.ndarray, receivers: np.ndarray,
              num_nodes: int):
    """Builds the attention mask from the mesh's edge lists (host)."""
    self.prepare_mask(adjacency_from_edges(senders, receivers, num_nodes))

  def forward(self, node_features: torch.Tensor,
              global_norm_conditioning: torch.Tensor) -> torch.Tensor:
    """node_features: [nodes, batch, d_model]; conditioning: [batch, cond].
    Returns the same layout as the input."""
    if node_features.ndim != 3:
      raise ValueError(
          f"expected [nodes, batch, d], got {tuple(node_features.shape)}")
    y = super().forward(node_features.transpose(0, 1),
                        global_norm_conditioning)
    return y.transpose(0, 1)
