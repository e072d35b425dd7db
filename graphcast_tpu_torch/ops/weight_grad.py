"""The weight-gradient reduction shared by the backward kernels K4 and K5.

``out[K, N] += a[R, K]^T @ b[R, N]`` with bf16 operands and f32 sums
(csrc/weight_grad.cu, a split-K reduction over the rows). It replaces the
constant-index f32 accumulator blocks of the TPU backward kernels
(pallas_edge.py::_fused_edge_bwd_kernel, pallas_decoder.py::
_decoder_bwd_kernel), which sum over a grid that runs in order.

``weight_grad`` runs the kernel for CUDA tensors and the plain version,
``weight_grad_reference``, for CPU tensors.
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
