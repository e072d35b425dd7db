"""Row gathers whose backward sums in a fixed order.

``table.index_select(0, index)`` copies node rows onto edges; its backward
is ``index_add_``, whose atomics take no fixed order on the card, so two
runs of one backward differ in the last bits. ``RowGather`` gathers the
same rows and sums their gradients with K3 (ops/segment_sum.py) over the
index's sorted order, then writes each touched row once: reruns of a
backward are bit-equal, as those of the fused kernels' are. The chunked
encoders and decoders (models/graphcast.py, models/denoiser.py) gather
through it.

The plan is built once on the host per index: a receiver-sorted
``EdgeIndex`` on which K3 keeps its work plan. A sorted index (receivers)
is that edge list itself, over all ``num_rows`` rows, and serves a sum of
edge messages into their receivers as well (``edges``). An unsorted one
(senders) is sorted stably into its distinct rows, and the gradient rows
are read in that order.
"""

from __future__ import annotations

import numpy as np
import torch

from graphcast_tpu_torch.ops.fused_edge import EdgeIndex
from graphcast_tpu_torch.ops.segment_sum import sorted_segment_sum


class RowGather:
  """Gathers rows ``index`` of a [num_rows, ...] table (module doc)."""

  def __init__(self, index: np.ndarray, num_rows: int,
               device: torch.device | str = "cpu"):
    index = np.asarray(index, np.int64)
    self.num_rows = int(num_rows)
    self.num_edges = int(index.size)
    self.index = torch.as_tensor(index.astype(np.int32), device=device)
    edge_ids = np.arange(index.size)
    if not (np.diff(index) < 0).any():
      self.rows = self.perm = None
      self.edges = EdgeIndex(edge_ids, index, max(index.size, 1), num_rows,
                             device=device)
      return
    rows, inverse = np.unique(index, return_inverse=True)
    inverse = inverse.reshape(-1)
    order = np.argsort(inverse, kind="stable")
    self.rows = torch.as_tensor(rows, device=device)
    self.perm = torch.as_tensor(order, device=device)
    # Edge j of the sorted order into distinct row inverse[order[j]] (the
    # senders are unused by K3).
    self.edges = EdgeIndex(order, inverse[order], max(index.size, 1),
                           rows.size, device=device)

  @classmethod
  def receivers_of(cls, edges: EdgeIndex) -> "RowGather":
    """The gather of ``edges``' receiver rows: the receiver-sorted list is
    its own plan (and K3's plan is shared with the list's receiver sums)."""
    self = cls.__new__(cls)
    self.num_rows, self.num_edges = edges.num_receivers, edges.num_edges
    self.index, self.rows, self.perm, self.edges = (edges.receivers, None,
                                                    None, edges)
    return self

  def __call__(self, table: torch.Tensor) -> torch.Tensor:
    """table[index], [E, ...]."""
    return _GatherFunction.apply(self, table)

  def sum_into_rows(self, grad: torch.Tensor) -> torch.Tensor:
    """The gather's transpose: [E, ...] → [num_rows, ...], each row the sum
    of its edges' rows in the index's sorted order."""
    shape = (self.num_rows,) + tuple(grad.shape[1:])
    if self.num_edges == 0:
      return grad.new_zeros(shape)
    flat = grad.reshape(self.num_edges, -1)
    if self.perm is None:
      return sorted_segment_sum(self.edges, flat.contiguous()).view(shape)
    sums = sorted_segment_sum(
        self.edges, flat.index_select(0, self.perm).contiguous())
    out = grad.new_zeros(shape)
    out.view(self.num_rows, -1).index_copy_(0, self.rows, sums)
    return out


class _GatherFunction(torch.autograd.Function):

  @staticmethod
  def forward(ctx, gather, table):
    ctx.gather = gather
    return table.index_select(0, gather.index)

  @staticmethod
  def backward(ctx, grad):
    return None, ctx.gather.sum_into_rows(grad)


def edge_gathers(edges: EdgeIndex) -> tuple[RowGather, RowGather]:
  """(senders, receivers): the gathers of a receiver-sorted edge list's
  node rows, on its device (module doc)."""
  with torch.inference_mode(False):
    return (RowGather(edges.senders.cpu().numpy(), edges.num_senders,
                      edges.device), RowGather.receivers_of(edges))


def gather_rows(table: torch.Tensor, index) -> torch.Tensor:
  """table[index] along the first axis: through ``index`` where it is a
  ``RowGather`` (a fixed-order backward), else ``index_select``."""
  if isinstance(index, RowGather):
    return index(table)
  return table.index_select(0, index)
