"""K3: the sorted segment sum of edge messages into receivers, and its plain
version.

Replaces graphcast_tpu/ops/pallas_mp.py::_agg_kernel (``BlockedSegmentSum``):
over a receiver-sorted edge list,

    out[n] = sum over the edges into n of messages[e]

summed in f32 and returned in the messages' dtype (bf16 or f32); receivers
with no edges get zeros. Messages [E, C] or [E, B, C]; a batch is folded
into the channels ([E, B·C]), as the JAX package does (pallas_mp.py:253-258).

``sorted_segment_sum`` runs the CUDA kernel (csrc/segment_sum.cu) for CUDA
tensors and the plain version (``segment_sum_reference``: ``index_add_``
into f32, then a cast) for CPU tensors; nothing else selects between them.
Its gradient is a ``torch.autograd.Function`` whose backward is the gather
d_messages = g[receivers] in plain PyTorch, as the JAX package's VJP is
plain XLA (pallas_mp.py:343-358): no backward kernel.

The kernel's work plan (``plan_segments``): each receiver's CSR row range
is cut into chunks of at most ``CHUNK_EDGES`` edges, so that no thread walks
more than that many rows however skewed the in-degree; receivers of several
chunks are finished by a second pass that adds the chunks' f32 sums in
order. It is built on the host once per edge list and kept on the
``EdgeIndex`` (``EdgeIndex.segment_plan``). The TPU's chunk-aligned padded
layout and one-hot masks are Mosaic layouts and are not ported: the same
node values come out without them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphcast_tpu_torch.native import build

CHUNK_EDGES = 64  # edge rows per work item (csrc/segment_sum.cu)


class SegmentPlan(NamedTuple):
  """K3's work plan on the edge list's device (csrc/segment_sum.cu)."""
  items: torch.Tensor   # [num_items, 4] int32: receiver, e0, e1, scratch row
  splits: torch.Tensor  # [num_splits, 4] int32: receiver, row0, row1, 0
  num_scratch_rows: int


def plan_segments(row_offsets: np.ndarray, device) -> SegmentPlan:
  """The work items and splits of K3 for CSR ``row_offsets`` [N + 1]."""
  chunk = CHUNK_EDGES
  offsets = np.asarray(row_offsets, np.int64)
  num_rows = offsets.shape[0] - 1
  chunks = np.maximum(1, -(-np.diff(offsets) // chunk))
  row = np.repeat(np.arange(num_rows), chunks)
  first_item = np.cumsum(chunks) - chunks
  k = np.arange(row.shape[0]) - first_item[row]
  e0 = offsets[row] + k * chunk
  e1 = np.minimum(e0 + chunk, offsets[row + 1])
  split = chunks[row] > 1
  slot = np.full(row.shape[0], -1, np.int64)
  slot[split] = np.arange(int(split.sum()))
  split_rows = np.nonzero(chunks > 1)[0]
  row0 = slot[first_item[split_rows]]
  items = np.stack([row, e0, e1, slot], 1)
  splits = np.stack([split_rows, row0, row0 + chunks[split_rows],
                     np.zeros_like(split_rows)], 1)

  def tensor(a):
    return torch.as_tensor(a.astype(np.int32).reshape(-1, 4), device=device)

  return SegmentPlan(tensor(items), tensor(splits), int(split.sum()))


def segment_sum_reference(edges, messages: torch.Tensor) -> torch.Tensor:
  """Plain version: ``index_add_`` of [E, C] messages into f32, then a
  cast to the messages' dtype."""
  out = torch.zeros((edges.num_receivers,) + tuple(messages.shape[1:]),
                    dtype=torch.float32, device=messages.device)
  out.index_add_(0, edges.receivers.long(), messages.float())
  return out.to(messages.dtype)


def _launch_segment_sum(edges, messages: torch.Tensor) -> torch.Tensor:
  """K3 on a CUDA [E, C] tensor (checks, then one launch)."""
  E, C = messages.shape
  dev = messages.device
  if messages.dtype not in (torch.bfloat16, torch.float32):
    raise TypeError(f"messages must be bf16 or f32, got {messages.dtype}")
  if E != edges.num_edges:
    raise ValueError(f"messages have {E} rows, edge list has "
                     f"{edges.num_edges}")
  if C % 8:
    raise ValueError(f"channels {C} must be a multiple of 8")
  if edges.device != dev:
    raise ValueError(f"edge list is on {edges.device}, messages on {dev}")
  if not messages.is_contiguous() or messages.data_ptr() % 16:
    raise ValueError("messages must be contiguous and 16-byte aligned")
  plan = edges.segment_plan()
  lib = build.load_library()
  out = torch.empty(edges.num_receivers, C, dtype=messages.dtype, device=dev)
  scratch = (torch.empty(plan.num_scratch_rows, C, dtype=torch.float32,
                         device=dev) if plan.num_scratch_rows else None)
  code = lib.gc_segment_sum(
      messages.data_ptr(), plan.items.data_ptr(), plan.items.shape[0],
      plan.splits.data_ptr() if plan.splits.shape[0] else None,
      plan.splits.shape[0], None if scratch is None else scratch.data_ptr(),
      out.data_ptr(), C, int(messages.dtype == torch.bfloat16),
      torch.cuda.current_stream(dev).cuda_stream)
  build.check(lib, code, "segment_sum kernel launch")
  sorted_segment_sum.launches += 1
  return out


class _SegmentSumFunction(torch.autograd.Function):
  """K3 (or, on the CPU, its plain version) forward; the gather backward."""

  @staticmethod
  def forward(ctx, edges, messages):
    ctx.edges = edges
    if messages.device.type == "cpu":
      return segment_sum_reference(edges, messages)
    if messages.device.type != "cuda":
      raise ValueError(f"unsupported device {messages.device}")
    return _launch_segment_sum(edges, messages)

  @staticmethod
  def backward(ctx, g):
    return None, g.index_select(0, ctx.edges.receivers)


def sorted_segment_sum(edges, messages: torch.Tensor) -> torch.Tensor:
  """Sums receiver-sorted messages into their receivers (module doc).

  Args:
    edges: the receiver-sorted ``EdgeIndex`` the messages belong to, on
      their device.
    messages: [E, C] or [E, B, C], bf16 or f32, in the edge list's order.

  Returns [N, C] or [N, B, C] in the messages' dtype.
  """
  if messages.ndim == 3:
    e, b, c = messages.shape
    out = _SegmentSumFunction.apply(edges, messages.reshape(e, b * c))
    return out.reshape(out.shape[0], b, c)
  if messages.ndim != 2:
    raise ValueError(f"messages must be [E, C] or [E, B, C], got "
                     f"{tuple(messages.shape)}")
  return _SegmentSumFunction.apply(edges, messages)


sorted_segment_sum.launches = 0  # every K3 launch
