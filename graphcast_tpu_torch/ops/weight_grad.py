"""The weight-gradient reduction shared by the backward kernels K4 and K5.

``out[K, N] += a[R, K]^T @ b[R, N]`` with bf16 operands and f32 sums
(csrc/weight_grad.cu: split-K over the rows, TMA and wgmma, partials
reduced in a fixed order). It replaces the constant-index f32 accumulator
blocks of the TPU backward kernels (pallas_edge.py::_fused_edge_bwd_kernel,
pallas_decoder.py::_decoder_bwd_kernel), which sum over a grid that runs in
order. ``plan`` is the kernel's work plan, made here so that the CPU tests
can check it; ``run_plan_reference`` executes a plan with the plain
product.

``feature_grad`` is its narrow sibling for the embed modes' first layer
(the F raw edge features, 4 in GenCast): ``dw0[F, C] += x[R, F]^T @ d[R, C]``
and the raw-feature gradient ``d @ w0^T`` (csrc/weight_grad.cu,
feature_grad_kernel), the port of the dew0 / de lines of
pallas_edge.py::_fused_edge_bwd_kernel and pallas_decoder.py::
_decoder_bwd_kernel.

Each runs its kernel for CUDA tensors and its plain version
(``*_reference``) for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from graphcast_tpu_torch.native import build

TILE_M = 128    # dW rows (of K) per tile (csrc kWgBM)
SLAB = 64       # contraction rows per ring stage (csrc kWgSlab)
MIN_SLABS = 4   # least slabs in a row range


@dataclasses.dataclass(frozen=True)
class WorkPlan:
  """The kernel's work items for one (R, K, N).

  Attributes:
    items: [splits * tiles, 4] int32, item i = (k0, n0, r0, r1): the dW tile
      at rows k0.. of K and columns n0.. of N over operand rows [r0, r1).
      Item s * tiles + kt * (N // tile_n) + nt is row range s of tile
      (kt, nt); r0 is a multiple of SLAB, r1 too or R.
    splits: number of row ranges.
    tile_n: dW tile width, 256, or 128 where N is an odd multiple of 128.
  """
  items: np.ndarray
  splits: int
  tile_n: int


def plan(R: int, K: int, N: int, num_sms: int) -> WorkPlan:
  """Split-K plan: about one item per SM, each row range at least
  MIN_SLABS slabs, ranges in row order, each with every tile in order (so
  the blocks that run together read the same rows)."""
  tile_n = 256 if N % 256 == 0 else 128
  tiles_k, tiles_n = K // TILE_M, N // tile_n
  slabs = -(-R // SLAB)
  splits = max(1, min(num_sms // (tiles_k * tiles_n), -(-slabs // MIN_SLABS)))
  per = -(-slabs // splits) * SLAB
  splits = max(1, -(-R // per))
  r0 = np.arange(splits) * per
  r1 = np.minimum(r0 + per, R)
  kt, nt = np.meshgrid(np.arange(tiles_k), np.arange(tiles_n), indexing="ij")
  tiles = np.stack([kt.ravel() * TILE_M, nt.ravel() * tile_n], 1)
  items = np.concatenate([
      np.repeat(tiles[None], splits, 0),
      np.broadcast_to(np.stack([r0, r1], 1)[:, None], (splits, len(tiles), 2))
  ], 2).reshape(-1, 4)
  return WorkPlan(items.astype(np.int32), int(splits), tile_n)


def run_plan_reference(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                       work: WorkPlan):
  """``out += a^T @ b`` by ``work``'s items, as the kernel runs it: each
  item's partial tile in f32, then the partials of each tile summed in row
  range order and added to out."""
  af, bf = (t.to(torch.bfloat16).float() for t in (a, b))
  partial = [af[r0:r1, k0:k0 + TILE_M].t() @ bf[r0:r1, n0:n0 + work.tile_n]
             for k0, n0, r0, r1 in work.items.tolist()]
  tiles = len(partial) // work.splits
  for i, (k0, n0, _, _) in enumerate(work.items[:tiles].tolist()):
    total = partial[i]
    for s in range(1, work.splits):
      total = total + partial[s * tiles + i]
    out[k0:k0 + TILE_M, n0:n0 + work.tile_n] += total


@functools.lru_cache(maxsize=256)
def _device_plan(R, K, N, device):
  """``plan`` for this card, and its items on the device."""
  sms = torch.cuda.get_device_properties(device).multi_processor_count
  work = plan(R, K, N, sms)
  return work, torch.as_tensor(work.items, device=device)


def weight_grad_reference(a: torch.Tensor, b: torch.Tensor,
                          out: torch.Tensor):
  """Plain version: out += a^T @ b of the bf16 operands, in f32."""
  out += a.to(torch.bfloat16).float().t() @ b.to(torch.bfloat16).float()


def weight_grad(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor):
  """out[K, N] += a[R, K]^T @ b[R, N] (module doc).

  Args:
    a, b: bf16 row operands with unit column stride and 16-byte aligned
      rows (row slices of a larger buffer are fine); K, N multiples of 128.
    out: [K, N] f32, contiguous, added to.
  """
  R, K = a.shape
  N = b.shape[1]
  if b.shape[0] != R or out.shape != (K, N) or K % 128 or N % 128:
    raise ValueError(f"weight_grad shapes {tuple(a.shape)}, "
                     f"{tuple(b.shape)} -> {tuple(out.shape)}")
  if out.device.type == "cpu":
    weight_grad_reference(a, b, out)
    return
  if out.device.type != "cuda":
    raise ValueError(f"unsupported device {out.device}")
  if R == 0:
    return
  for name, t in (("a", a), ("b", b)):
    if t.device != out.device or t.dtype != torch.bfloat16:
      raise TypeError(f"{name} must be bf16 on {out.device}")
    if t.stride(1) != 1 or t.stride(0) % 8 or t.data_ptr() % 16:
      raise ValueError(f"{name} needs unit column stride and 16-byte "
                       "aligned rows")
  if out.dtype != torch.float32 or not out.is_contiguous():
    raise TypeError("out must be contiguous f32")
  work, items = _device_plan(R, K, N, out.device)
  ws = torch.empty(len(work.items) * TILE_M * work.tile_n,
                   dtype=torch.float32, device=out.device)
  lib = build.load_library()
  code = lib.gc_weight_grad(
      a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0), out.data_ptr(),
      R, K, N, items.data_ptr(), len(work.items), work.splits, work.tile_n,
      ws.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream)
  build.check(lib, code, "weight_grad kernel launch")
  weight_grad.launches += 1


weight_grad.launches = 0


MAX_FEATURES = 16  # raw features feature_grad takes (csrc kFgMaxF)


def feature_grad_reference(x: torch.Tensor, d: torch.Tensor,
                           w0: torch.Tensor, dw0: torch.Tensor):
  """Plain version: dw0 += bf16(x)^T @ bf16(d) in f32; returns bf16(d) @
  bf16(w0)^T in f32."""
  xb, db, wb = (t.to(torch.bfloat16).float() for t in (x, d, w0))
  dw0 += xb.t() @ db
  return db @ wb.t()


def feature_grad(x: torch.Tensor, d: torch.Tensor, w0: torch.Tensor,
                 dw0: torch.Tensor) -> torch.Tensor:
  """dw0[F, C] += x[R, F]^T @ d[R, C]; returns dx = d @ w0^T [R, F] f32.

  Args:
    x: bf16 raw features, contiguous [R, F], F <= MAX_FEATURES.
    d: bf16 [R, C] with unit column stride and 16-byte aligned rows.
    w0: bf16 [F, C], contiguous.
    dw0: [F, C] f32, contiguous, added to.
  """
  R, F = x.shape
  C = d.shape[1]
  if d.shape[0] != R or w0.shape != (F, C) or dw0.shape != (F, C):
    raise ValueError(f"feature_grad shapes {tuple(x.shape)}, "
                     f"{tuple(d.shape)}, {tuple(w0.shape)} -> "
                     f"{tuple(dw0.shape)}")
  if not 1 <= F <= MAX_FEATURES:
    raise ValueError(f"feature_grad takes 1 to {MAX_FEATURES} features")
  if dw0.device.type == "cpu":
    return feature_grad_reference(x, d, w0, dw0)
  if dw0.device.type != "cuda":
    raise ValueError(f"unsupported device {dw0.device}")
  for name, t in (("x", x), ("d", d), ("w0", w0)):
    if t.device != dw0.device or t.dtype != torch.bfloat16:
      raise TypeError(f"{name} must be bf16 on {dw0.device}")
  if not (x.is_contiguous() and w0.is_contiguous()) or d.stride(1) != 1:
    raise ValueError("x and w0 must be contiguous, d have unit column "
                     "stride")
  if dw0.dtype != torch.float32 or not dw0.is_contiguous():
    raise TypeError("dw0 must be contiguous f32")
  dx = torch.empty(R, F, dtype=torch.float32, device=dw0.device)
  if R == 0:
    return dx
  lib = build.load_library()
  code = lib.gc_feature_grad(
      x.data_ptr(), F, d.data_ptr(), d.stride(0), w0.data_ptr(),
      dw0.data_ptr(), dx.data_ptr(), R, C,
      torch.cuda.current_stream(dw0.device).cuda_stream)
  build.check(lib, code, "feature_grad kernel launch")
  feature_grad.launches += 1
  return dx


feature_grad.launches = 0
