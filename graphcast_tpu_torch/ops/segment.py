"""Segment aggregations of edge messages onto nodes, plain PyTorch.

Port of graphcast_tpu/ops/segment.py (the JAX package's plain-XLA
``jax.ops.segment_*``): ``index_add_`` for sums and ``scatter_reduce`` for
maxima and minima. Segments with no element get the reduction's identity,
as in JAX: 0 for sums and means, -inf for maxima, +inf for minima.

``indices_are_sorted`` is accepted for the JAX signature; PyTorch's
scatters take no such hint, so it changes nothing here. The sorted
receiver sums of the message-passing hot loop go through K3 instead
(ops/segment_sum.py).
"""

from __future__ import annotations

from typing import Optional

import torch


def _out(data: torch.Tensor, num_segments: int, fill: float):
  return torch.full((num_segments,) + tuple(data.shape[1:]), fill,
                    dtype=data.dtype, device=data.device)


def segment_sum(data, segment_ids, num_segments: int,
                indices_are_sorted: bool = False):
  del indices_are_sorted
  return _out(data, num_segments, 0.0).index_add_(0, segment_ids.long(), data)


def segment_mean(data, segment_ids, num_segments: int,
                 indices_are_sorted: bool = False):
  del indices_are_sorted
  totals = segment_sum(data, segment_ids, num_segments)
  ones = torch.ones(data.shape[0], dtype=totals.dtype, device=data.device)
  counts = torch.clamp(segment_sum(ones, segment_ids, num_segments), min=1)
  return totals / counts.reshape((num_segments,) + (1,) * (data.ndim - 1))


def _segment_extreme(data, segment_ids, num_segments: int, reduce: str,
                     fill: float):
  index = segment_ids.long().reshape((-1,) + (1,) * (data.ndim - 1))
  return _out(data, num_segments, fill).scatter_reduce_(
      0, index.expand_as(data), data, reduce=reduce, include_self=True)


def segment_max(data, segment_ids, num_segments: int,
                indices_are_sorted: bool = False):
  del indices_are_sorted
  return _segment_extreme(data, segment_ids, num_segments, "amax",
                          float("-inf"))


def segment_min(data, segment_ids, num_segments: int,
                indices_are_sorted: bool = False):
  del indices_are_sorted
  return _segment_extreme(data, segment_ids, num_segments, "amin",
                          float("inf"))


REDUCERS = {
    "segment_sum": segment_sum,
    "segment_mean": segment_mean,
    "segment_max": segment_max,
    "segment_min": segment_min,
}


def aggregate_edges_for_nodes(data, receivers, num_nodes: int, *,
                              method: str = "segment_sum",
                              f32_aggregation: bool = False,
                              normalization: Optional[float] = None,
                              indices_are_sorted: bool = True):
  """Aggregates per-edge messages [E, ...] into per-node values [N, ...].

  ``f32_aggregation`` accumulates in float32 and returns the input dtype;
  ``normalization`` divides the aggregate by a constant (sums only), before
  the cast back (graphcast_tpu/ops/segment.py:60-92).
  """
  fn = REDUCERS[method]
  if normalization is not None and method != "segment_sum":
    raise ValueError("aggregate normalization only makes sense with sum")
  dtype = data.dtype
  if f32_aggregation:
    data = data.float()
  out = fn(data, receivers, num_nodes, indices_are_sorted=indices_are_sorted)
  if normalization is not None:
    out = out / normalization
  return out.to(dtype) if f32_aggregation else out
