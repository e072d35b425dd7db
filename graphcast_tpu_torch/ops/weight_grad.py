"""The weight-gradient reduction shared by the backward kernels K4 and K5.

``out[K, N] += a[R, K]^T @ b[R, N]`` with bf16 operands and f32 sums
(csrc/weight_grad.cu, a split-K reduction over the rows). It replaces the
constant-index f32 accumulator blocks of the TPU backward kernels
(pallas_edge.py::_fused_edge_bwd_kernel, pallas_decoder.py::
_decoder_bwd_kernel), which sum over a grid that runs in order.

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

import torch

from graphcast_tpu_torch.native import build


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
  lib = build.load_library()
  code = lib.gc_weight_grad(
      a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0), out.data_ptr(),
      R, K, N, torch.cuda.current_stream(out.device).cuda_stream)
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
