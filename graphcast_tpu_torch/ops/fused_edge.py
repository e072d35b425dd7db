"""K1: the fused InteractionNetwork edge step, and its plain-PyTorch twin.

Replaces graphcast_tpu/ops/pallas_edge.py::_fused_edge_kernel (ground truth:
``FusedEdgeStep._reference_math``). One call computes, over a receiver-sorted
edge list,

    x0  = e @ We + sproj[senders] + rproj[receivers] + b0
    y   = LN(swish(bf16(x0)) @ W1 + b1) * scale + offset
    e'  = e + y
    agg[n] = sum_{edges into n} bf16(y)      (f32)

Processor mode passes We/b0 and writes e'. Encoder mode (``we=None``,
``write_edges=False``) takes ``e`` as the hoisted static first-layer part
embed(features) @ We + b0 and returns only ``agg``.

Edge layout: the artifact's receiver-sorted order, as is; ``EdgeIndex``
holds the sender and receiver indices on the device. The TPU kernel's
chunk-aligned padded layout and bitpacked one-hot masks (ops/pallas_mp.py)
are Mosaic-specific and not ported.

``fused_edge`` runs the CUDA kernel (csrc/fused_edge.cu) for CUDA tensors and
the twin for CPU tensors; nothing else selects between them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from graphcast_tpu_torch.native import build

LN_EPS = 1e-5


class EdgeIndex:
  """A receiver-sorted edge list on one device, checked once on the host."""

  def __init__(self, senders: np.ndarray, receivers: np.ndarray,
               num_senders: int, num_receivers: int,
               device: torch.device | str = "cpu"):
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    if senders.ndim != 1 or senders.shape != receivers.shape:
      raise ValueError("senders/receivers must be 1-D of equal length")
    if senders.size >= 2**31:
      raise ValueError("edge list too large for int32 indices")
    if senders.size and (senders.min() < 0 or senders.max() >= num_senders):
      raise ValueError("sender index out of range")
    if receivers.size and (receivers.min() < 0
                           or receivers.max() >= num_receivers):
      raise ValueError("receiver index out of range")
    if (np.diff(receivers) < 0).any():
      raise ValueError("receivers must be sorted")
    self.num_edges = int(senders.size)
    self.num_senders = int(num_senders)
    self.num_receivers = int(num_receivers)
    # mesh2grid: exactly 3 edges per receiver, rows 3v..3v+2 (K2's layout).
    self.three_per_receiver = bool(
        self.num_edges == 3 * self.num_receivers
        and np.array_equal(receivers,
                           np.repeat(np.arange(num_receivers), 3)))
    self.senders = torch.as_tensor(senders.astype(np.int32), device=device)
    self.receivers = torch.as_tensor(receivers.astype(np.int32),
                                     device=device)

  @property
  def device(self) -> torch.device:
    return self.senders.device


def swish_of(x: torch.Tensor, dtype) -> torch.Tensor:
  """swish of x rounded to ``dtype``, evaluated in f32, rounded to ``dtype``
  (the kernels' activation; csrc/common.cuh swish_of_bf16)."""
  xd = x.to(dtype).float()
  return (xd * torch.sigmoid(xd)).to(dtype)


def layer_norm_f32(y: torch.Tensor, scale, offset) -> torch.Tensor:
  """LN of f32 rows with f32 statistics, then f32 affine."""
  mean = y.mean(-1, keepdim=True)
  var = (y - mean).square().mean(-1, keepdim=True)
  return (y - mean) * torch.rsqrt(var + LN_EPS) * scale + offset


def fused_edge_reference(edges: EdgeIndex, e, sproj, rproj, we, b0, w1, b1,
                         scale, offset, write_edges: bool):
  """Plain-PyTorch twin of the K1 kernel (same rounding points)."""
  dtype = sproj.dtype
  f32 = torch.float32
  x0 = (e.float() @ we.to(dtype).float() if we is not None else e.float())
  x0 = x0 + sproj[edges.senders.long()].float()
  x0 = x0 + rproj[edges.receivers.long()].float()
  if we is not None:
    x0 = x0 + b0.float()
  h = swish_of(x0, dtype)
  y = h.float() @ w1.to(dtype).float() + b1.float()
  yn = layer_norm_f32(y, scale.float(), offset.float())
  agg = torch.zeros(edges.num_receivers, yn.shape[-1], dtype=f32,
                    device=yn.device)
  agg.index_add_(0, edges.receivers.long(), yn.to(dtype).float())
  if not write_edges:
    return agg
  return (e.float() + yn).to(dtype), agg


def _check_cuda(tensors: dict, device, dtype):
  for name, t in tensors.items():
    if t.device != device:
      raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
      raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
      raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
      raise ValueError(f"{name} must be 16-byte aligned")


def _no_grad_inputs(*tensors):
  if torch.is_grad_enabled() and any(
      t is not None and t.requires_grad for t in tensors):
    raise NotImplementedError(
        "the CUDA kernels are forward-only: run under torch.no_grad() or "
        "torch.inference_mode() (the backward kernels are not ported yet)")


def fused_edge(edges: EdgeIndex, e: torch.Tensor, sproj: torch.Tensor,
               rproj: torch.Tensor, we: Optional[torch.Tensor],
               b0: Optional[torch.Tensor], w1: torch.Tensor,
               b1: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
               write_edges: bool = True):
  """One fused edge step (module doc). Returns (e_out [E, C], agg [N, C]
  f32), or agg alone with ``write_edges=False``.

  Args:
    edges: receiver-sorted edge list on the tensors' device.
    e: [E, C] edge latents (processor) or hoisted first-layer part
      (encoder, ``we=None``), activation dtype.
    sproj / rproj: [num_senders, C] / [num_receivers, C] node projections
      (activation dtype); gathered by index inside the step.
    we, b0: [C, C], [C] edge part and bias of the first layer, or None.
    w1, b1: second layer [C, C], [C]; scale, offset: LayerNorm [C].
      Matrices are cast to the activation dtype; vectors are used in f32.
  """
  if e.device.type == "cpu":
    return fused_edge_reference(edges, e, sproj, rproj, we, b0, w1, b1,
                                scale, offset, write_edges)
  if e.device.type != "cuda":
    raise ValueError(f"unsupported device {e.device}")
  _no_grad_inputs(e, sproj, rproj, we, b0, w1, b1, scale, offset)
  if (we is None) != (b0 is None):
    raise ValueError("pass we and b0 together")
  E, C = e.shape
  bf16 = torch.bfloat16
  if E != edges.num_edges:
    raise ValueError(f"e has {E} rows, edge list has {edges.num_edges}")
  if C % 128 or not 128 <= C <= 512:
    raise ValueError(f"latent width {C} must be a multiple of 128 in "
                     "[128, 512]")
  if sproj.shape != (edges.num_senders, C) or rproj.shape != (
      edges.num_receivers, C):
    raise ValueError("sproj/rproj shapes do not match the edge list")
  if edges.device != e.device:
    raise ValueError(f"edge list is on {edges.device}, tensors on {e.device}")
  dev = e.device
  w1 = w1.to(bf16).contiguous()
  vecs = {"b1": b1, "scale": scale, "offset": offset}
  if we is not None:
    we = we.to(bf16).contiguous()
    vecs["b0"] = b0
  vecs = {k: v.float().contiguous() for k, v in vecs.items()}
  mats = {"e": e, "sproj": sproj, "rproj": rproj, "w1": w1}
  if we is not None:
    mats["we"] = we
  _check_cuda(mats, dev, bf16)
  _check_cuda(vecs, dev, torch.float32)
  for name, v in vecs.items():
    if v.shape != (C,):
      raise ValueError(f"{name} must have shape ({C},)")
  if w1.shape != (C, C) or (we is not None and we.shape != (C, C)):
    raise ValueError(f"we/w1 must have shape ({C}, {C})")

  lib = build.load_library()
  agg = torch.zeros(edges.num_receivers, C, dtype=torch.float32, device=dev)
  eout = torch.empty_like(e) if write_edges else None
  ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
  code = lib.gc_fused_edge(
      e.data_ptr(), sproj.data_ptr(), edges.senders.data_ptr(),
      rproj.data_ptr(), edges.receivers.data_ptr(), ptr(we),
      ptr(vecs.get("b0")), w1.data_ptr(), vecs["b1"].data_ptr(),
      vecs["scale"].data_ptr(), vecs["offset"].data_ptr(), ptr(eout),
      agg.data_ptr(), E, C, int(we is not None), int(write_edges),
      torch.cuda.current_stream(dev).cuda_stream)
  build.check(lib, code, "fused_edge kernel launch")
  fused_edge.launches += 1
  return (eout, agg) if write_edges else agg


fused_edge.launches = 0
