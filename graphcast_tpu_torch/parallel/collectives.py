"""Collectives with their gradients, and the parallel forms of a Linear.

The JAX package annotates shardings and lets XLA's SPMD partitioner insert
the collectives (graphcast_tpu/parallel/sharding.py). PyTorch has no such
partitioner, so the port inserts them where the partitioner would, each
an autograd function whose backward is the collective's transpose:

- ``all_reduce_sum``: forward sum over a group, backward identity (after a
  row-parallel product, whose output every rank then holds whole);
- ``grad_all_reduce``: forward identity, backward sum (a replicated input
  entering a column-parallel product, or a parameter whose gradient each
  rank of a sequence-parallel group holds a part of);
- ``all_gather``: forward concatenation of every rank's part, backward the
  rank's part of the gradient, summed over the group first where the
  consumers of the whole differ between ranks (``reduce_grad``), taken as
  it is where they compute the same thing on every rank;
- ``split``: forward the rank's part, backward an all-gather of the parts.

``LinearSharding`` is what ``sharding.shard_params_tensor_parallel`` and
sequence parallelism attach to a ``nn.core.Linear``: its forward runs the
column- or row-parallel product (Megatron's pairing: one all-reduce after
each row-parallel product, before its bias) and ``full`` gathers the whole
weight for a fused kernel that takes a whole MLP (K1, K2, K4, K5), whose
gradient then comes back as the rank's slice. Sums of gradients are taken
in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

# The most bytes that all_reduce_mean_ flattens into one all-reduce.
BUCKET_BYTES = 64 << 20


def group_size(group) -> int:
  return dist.get_world_size(group)


def group_rank(group) -> int:
  return dist.get_rank(group)


class _AllReduceSum(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group):
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y

  @staticmethod
  def backward(ctx, g):
    return g, None


def _sum_f32(g, group):
  """g summed over ``group`` in f32, returned in g's dtype (summed in a
  copy: an incoming gradient may be shared)."""
  g32 = g.float().contiguous()
  if g32 is g:
    g32 = g.clone()
  dist.all_reduce(g32, group=group)
  return g32.to(g.dtype)


class _GradAllReduce(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    return _sum_f32(g, ctx.group), None


def gather(x, dim: int, group):
  """Every rank's x (equal shapes) concatenated along ``dim``, with no
  gradient."""
  parts = [torch.empty_like(x) for _ in range(group_size(group))]
  dist.all_gather(parts, x.contiguous(), group=group)
  return torch.cat(parts, dim)


class _AllGather(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, dim, group, reduce_grad):
    ctx.dim, ctx.group, ctx.reduce_grad = dim, group, reduce_grad
    return gather(x, dim, group)

  @staticmethod
  def backward(ctx, g):
    if ctx.reduce_grad:
      g = _sum_f32(g, ctx.group)
    part = g.chunk(group_size(ctx.group), ctx.dim)[group_rank(ctx.group)]
    return part.contiguous(), None, None, None


class _Split(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, dim, group):
    ctx.dim, ctx.group = dim, group
    return x.chunk(group_size(group), dim)[group_rank(group)].contiguous()

  @staticmethod
  def backward(ctx, g):
    return gather(g, ctx.dim, ctx.group), None, None


def all_reduce_sum(x, group):
  return _AllReduceSum.apply(x, group)


def grad_all_reduce(x, group):
  return _GradAllReduce.apply(x, group)


def all_gather(x, dim: int, group, reduce_grad: bool):
  """Every rank's x (equal shapes) concatenated along ``dim`` (module
  doc)."""
  return _AllGather.apply(x, dim, group, reduce_grad)


def split(x, dim: int, group):
  """This rank's part of x along ``dim`` (equal parts; module doc)."""
  return _Split.apply(x, dim, group)


def all_reduce_mean_(tensors, group):
  """Averages ``tensors`` in place over ``group``, in buckets of at most
  ``BUCKET_BYTES`` flattened into one all-reduce each (one dtype per
  bucket)."""
  size = group_size(group)
  bucket, nbytes = [], 0

  def flush():
    if not bucket:
      return
    flat = torch.cat([t.reshape(-1) for t in bucket])
    dist.all_reduce(flat, group=group)
    flat.div_(size)
    offset = 0
    for t in bucket:
      t.copy_(flat[offset:offset + t.numel()].view_as(t))
      offset += t.numel()
    bucket.clear()

  for t in tensors:
    if bucket and (t.dtype != bucket[0].dtype
                   or nbytes + t.numel() * t.element_size() > BUCKET_BYTES):
      flush()
      nbytes = 0
    bucket.append(t)
    nbytes += t.numel() * t.element_size()
  flush()


@dataclasses.dataclass
class LinearSharding:
  """How a Linear (w [in, out], b [out]) runs across ranks.

  mode: "col" (w holds this rank's columns of the model group's split, b
    its entries), "row" (w holds its rows, b whole) or "rep" (whole).
  group: the model (tensor-parallel) group of "col" and "row".
  grad_group: a group whose ranks each hold part of the gradient of w and
    b (sequence parallelism), summed in the backward; or None.
  """
  mode: str = "rep"
  group: Optional[object] = None
  grad_group: Optional[object] = None

  def params(self, lin):
    w, b = lin.w, lin.b
    if self.grad_group is not None:
      w = grad_all_reduce(w, self.grad_group)
      b = None if b is None else grad_all_reduce(b, self.grad_group)
    return w, b

  def enter(self, x):
    """A replicated input of a column-parallel product."""
    return grad_all_reduce(x, self.group) if self.mode == "col" else x

  def forward(self, lin, x):
    w, b = self.params(lin)
    y = self.enter(x) @ w.to(x.dtype)
    if self.mode == "row":
      y = all_reduce_sum(y, self.group)
    return y if b is None else y + b.to(x.dtype)

  def full(self, lin, name: str):
    """The whole w or b (name), gathered where this rank holds a part."""
    value = self.params(lin)[0 if name == "w" else 1]
    if value is None or self.mode == "rep" or (self.mode == "row"
                                               and name == "b"):
      return value
    dim = 0 if self.mode == "row" or name == "b" else 1
    return all_gather(value, dim, self.group, reduce_grad=False)
