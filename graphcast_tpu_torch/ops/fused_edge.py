"""K1: the fused InteractionNetwork edge step, its backward K4, and the
plain-PyTorch twin.

Replaces graphcast_tpu/ops/pallas_edge.py::_fused_edge_kernel (ground truth:
``FusedEdgeStep._reference_math``). One call computes, over a receiver-sorted
edge list,

    x0  = e @ We + sproj[senders] + rproj[receivers] + b0
    y   = LN(swish(bf16(x0)) @ W1 + b1) * scale + offset
    e'  = e + y
    agg[n] = sum_{edges into n} bf16(y)      (f32)

Processor mode passes We/b0 and writes e'. Encoder mode (``we=None``,
``write_edges=False``) takes ``e`` as the hoisted static first-layer part
embed(features) @ We + b0 and returns only ``agg``. Embed mode (GenCast's
grid2mesh, ``embed_weights=(ew0, eb0, ew1, eb1)``) takes ``e`` as the raw
[E, F] edge features and embeds them in the step first
(pallas_edge.py:124-157):

    en  = bf16(LN0(bf16(swish(bf16(f @ ew0 + eb0))) @ ew1 + eb1))
    x0  = en @ We' + sproj[senders] + rproj[receivers] + b0'

with LN0 parameter-free (f32 statistics); the norm conditioning is folded
into We', b0' and the step's LayerNorm scale/offset by the caller. On the
card it runs aggregation-only (``write_edges=False``), as the denoiser
calls it.

Gradients: on CUDA tensors that require grad, ``fused_edge`` runs K1 inside
a ``torch.autograd.Function`` whose backward is K4
(``fused_edge_backward``; csrc/fused_edge_bwd.cu + csrc/weight_grad.cu),
the port of pallas_edge.py::_fused_edge_bwd_kernel; in embed mode the
backward is K4's embed mode (``fused_edge_embed_backward``), which also
recomputes the in-tile embed and emits the embed MLP's gradients and the
raw-feature gradient. The forward keeps only its inputs; K4 recomputes the
rest. On CPU tensors the twin runs under plain autograd.

Edge layout: the artifact's receiver-sorted order, as is; ``EdgeIndex``
holds the sender and receiver indices on the device. The TPU kernel's
chunk-aligned padded layout and bitpacked one-hot masks (ops/pallas_mp.py)
are Mosaic-specific and not ported.

``fused_edge`` runs the CUDA kernels for CUDA tensors and the twin for CPU
tensors; nothing else selects between them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from graphcast_tpu_torch.native import build
from graphcast_tpu_torch.ops import segment_sum
from graphcast_tpu_torch.ops.weight_grad import feature_grad, weight_grad

LN_EPS = 1e-5
# Edge rows per K4 launch: bounds its h / dy row buffers (2 x 268 MB at
# C = 512).
BWD_CHUNK_ROWS = 1 << 18
# Raw edge features the embed-mode kernel takes (GenCast: 4).
MAX_EMBED_FEATURES = 16


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
    # CSR row offsets [num_receivers + 1] of the sorted receivers (host).
    self.row_offsets = np.concatenate(
        [[0], np.cumsum(np.bincount(receivers, minlength=num_receivers))]
    ).astype(np.int32)
    self._segment_plan = None

  @property
  def device(self) -> torch.device:
    return self.senders.device

  def segment_plan(self) -> segment_sum.SegmentPlan:
    """K3's work plan for this edge list on its device (built at first
    use; ops/segment_sum.py)."""
    if self._segment_plan is None:
      self._segment_plan = segment_sum.plan_segments(self.row_offsets,
                                                     self.device)
    return self._segment_plan


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


def embed_edges_reference(features, embed_weights, dtype):
  """The embed mode's edge embedding: raw [E, F] features → bf16 ``en``
  (parameter-free LayerNorm), as K1 computes it (vectors in f32)."""
  ew0, eb0, ew1, eb1 = embed_weights
  x = features.to(dtype).float() @ ew0.to(dtype).float() + eb0.float()
  y0 = swish_of(x, dtype).float() @ ew1.to(dtype).float() + eb1.float()
  return layer_norm_f32(y0, 1.0, 0.0).to(dtype)


def fused_edge_reference(edges: EdgeIndex, e, sproj, rproj, we, b0, w1, b1,
                         scale, offset, write_edges: bool,
                         embed_weights=None):
  """Plain-PyTorch twin of the K1 kernel (same rounding points)."""
  dtype = sproj.dtype
  f32 = torch.float32
  if embed_weights is not None:
    e = embed_edges_reference(e, embed_weights, dtype)
  x0 = (e.float() @ we.to(dtype).float() if we is not None else e.float())
  # Gathered from f32 copies, so that the gathers' backward (a scatter-add
  # over up to thousands of edges per node) sums in f32, as K4 does.
  x0 = x0 + sproj.float()[edges.senders.long()]
  x0 = x0 + rproj.float()[edges.receivers.long()]
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


def _vectors_f32(**vecs):
  return {k: v.float().contiguous() for k, v in vecs.items() if v is not None}


def _check_vectors(vecs: dict, dev, C: int):
  _check_cuda(vecs, dev, torch.float32)
  for name, v in vecs.items():
    if v.shape != (C,):
      raise ValueError(f"{name} must have shape ({C},)")


def _check_edge_shapes(edges: EdgeIndex, E: int, C: int, sproj, rproj,
                       device):
  if E != edges.num_edges:
    raise ValueError(f"e has {E} rows, edge list has {edges.num_edges}")
  if C % 128 or not 128 <= C <= 512:
    raise ValueError(f"latent width {C} must be a multiple of 128 in "
                     "[128, 512]")
  if sproj.shape != (edges.num_senders, C) or rproj.shape != (
      edges.num_receivers, C):
    raise ValueError("sproj/rproj shapes do not match the edge list")
  if edges.device != device:
    raise ValueError(f"edge list is on {edges.device}, tensors on {device}")


def _matrix_bf16(w, C: int, name: str):
  w = w.to(torch.bfloat16).contiguous()
  if w.shape != (C, C):
    raise ValueError(f"{name} must have shape ({C}, {C})")
  return w


def _launch_fused_edge(edges: EdgeIndex, e, sproj, rproj, we, b0, w1, b1,
                       scale, offset, write_edges: bool):
  """K1 on CUDA tensors (checks, then one launch)."""
  _check_edge_shapes(edges, *e.shape, sproj, rproj, e.device)
  C = e.shape[1]
  dev = e.device
  w1 = _matrix_bf16(w1, C, "w1")
  if we is not None:
    we = _matrix_bf16(we, C, "we")
  vecs = _vectors_f32(b0=b0, b1=b1, scale=scale, offset=offset)
  _check_cuda({"e": e, "sproj": sproj, "rproj": rproj, "w1": w1,
               **({"we": we} if we is not None else {})}, dev, torch.bfloat16)
  _check_vectors(vecs, dev, C)

  lib = build.load_library()
  agg = torch.zeros(edges.num_receivers, C, dtype=torch.float32, device=dev)
  eout = torch.empty_like(e) if write_edges else None
  ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
  code = lib.gc_fused_edge(
      e.data_ptr(), sproj.data_ptr(), edges.senders.data_ptr(),
      rproj.data_ptr(), edges.receivers.data_ptr(), ptr(we),
      ptr(vecs.get("b0")), w1.data_ptr(), vecs["b1"].data_ptr(),
      vecs["scale"].data_ptr(), vecs["offset"].data_ptr(), ptr(eout),
      agg.data_ptr(), edges.num_edges, C, int(we is not None),
      int(write_edges), torch.cuda.current_stream(dev).cuda_stream)
  build.check(lib, code, "fused_edge kernel launch")
  fused_edge.launches += 1
  if we is None:
    fused_edge.encoder_launches += 1
  return (eout, agg) if write_edges else agg


def fused_edge_backward(edges: EdgeIndex, e, sproj, rproj, we, b0, w1, b1,
                        scale, d_eout, d_agg):
  """K4: the gradients of one fused edge step on CUDA tensors.

  Args: K1's inputs (``offset`` is not needed: it only shifts y), and the
  cotangents d_eout ([E, C], processor mode; None in encoder mode) and
  d_agg ([N, C]). Returns (de, dsproj, drproj, dwe, db0, dw1, db1, dscale,
  doff), each in its input's dtype, as the JAX package returns them; dwe
  and db0 are None in encoder mode, where de = dsproj's per-edge rows.
  Row chunks of ``BWD_CHUNK_ROWS`` edges: each runs the per-row kernel (one
  launch, counted in ``fused_edge_backward.launches``), the weight-gradient
  reductions (ops/weight_grad.py) and the f32 scatter of the per-edge
  sender gradients to the sender nodes.
  """
  processor = we is not None
  if processor != (d_eout is not None):
    raise NotImplementedError(
        "K4 covers processor mode (we, e' written) and encoder mode "
        "(no we, aggregation only)")
  _check_edge_shapes(edges, *e.shape, sproj, rproj, e.device)
  E, C = e.shape
  dev = e.device
  bf16, f32 = torch.bfloat16, torch.float32
  w1b = _matrix_bf16(w1, C, "w1")
  mats = {"e": e, "sproj": sproj, "rproj": rproj, "w1": w1b,
          "w1t": w1b.t().contiguous()}
  if processor:
    web = _matrix_bf16(we, C, "we")
    mats.update(we=web, wet=web.t().contiguous(),
                deout=d_eout.to(bf16).contiguous())
  vecs = _vectors_f32(b0=b0, b1=b1, scale=scale)
  _check_cuda(mats, dev, bf16)
  _check_vectors(vecs, dev, C)
  d_agg = d_agg.to(f32).contiguous()
  if d_agg.shape != (edges.num_receivers, C):
    raise ValueError(f"d_agg must have shape ({edges.num_receivers}, {C})")

  lib = build.load_library()
  dgs = torch.empty(E, C, dtype=bf16, device=dev)
  de = torch.empty(E, C, dtype=bf16, device=dev) if processor else dgs
  dgr = torch.zeros(edges.num_receivers, C, dtype=f32, device=dev)
  dsproj = torch.zeros(edges.num_senders, C, dtype=f32, device=dev)
  sums = torch.zeros(4, C, dtype=f32, device=dev)
  dw1 = torch.zeros(C, C, dtype=f32, device=dev)
  dwe = torch.zeros(C, C, dtype=f32, device=dev) if processor else None
  rows = min(E, BWD_CHUNK_ROWS)
  hbuf = torch.empty(rows, C, dtype=bf16, device=dev)
  dybuf = torch.empty(rows, C, dtype=bf16, device=dev)
  ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
  stream = torch.cuda.current_stream(dev).cuda_stream
  for r0 in range(0, E, BWD_CHUNK_ROWS):
    n = min(BWD_CHUNK_ROWS, E - r0)
    part = slice(r0, r0 + n)
    code = lib.gc_fused_edge_bwd(
        e[part].data_ptr(), sproj.data_ptr(), edges.senders[part].data_ptr(),
        rproj.data_ptr(), edges.receivers[part].data_ptr(),
        ptr(mats.get("we")), ptr(mats.get("wet")), ptr(vecs.get("b0")),
        w1b.data_ptr(), mats["w1t"].data_ptr(), vecs["b1"].data_ptr(),
        vecs["scale"].data_ptr(),
        mats["deout"][part].data_ptr() if processor else None,
        d_agg.data_ptr(), hbuf.data_ptr(), dybuf.data_ptr(),
        dgs[part].data_ptr(), de[part].data_ptr(), dgr.data_ptr(),
        sums.data_ptr(), n, C, int(processor), stream)
    build.check(lib, code, "fused_edge_bwd kernel launch")
    fused_edge_backward.launches += 1
    weight_grad(hbuf[:n], dybuf[:n], dw1)
    if processor:
      weight_grad(e[part], dgs[part], dwe)
    dsproj.index_add_(0, edges.senders[part].long(), dgs[part].float())
  return (de, dsproj.to(sproj.dtype), dgr.to(rproj.dtype),
          dwe.to(we.dtype) if processor else None,
          sums[3].to(b0.dtype) if processor else None, dw1.to(w1.dtype),
          sums[2].to(b1.dtype), sums[0].to(scale.dtype), sums[1])


fused_edge_backward.launches = 0


class _FusedEdgeFunction(torch.autograd.Function):
  """K1 forward, K4 backward (module doc). Saves only the inputs."""

  @staticmethod
  def forward(ctx, edges, write_edges, e, sproj, rproj, we, b0, w1, b1,
              scale, offset):
    ctx.edges = edges
    ctx.write_edges = write_edges
    ctx.offset_dtype = offset.dtype
    ctx.save_for_backward(e, sproj, rproj, we, b0, w1, b1, scale)
    return _launch_fused_edge(edges, e, sproj, rproj, we, b0, w1, b1, scale,
                              offset, write_edges)

  @staticmethod
  def backward(ctx, *grads):
    e, sproj, rproj, we, b0, w1, b1, scale = ctx.saved_tensors
    d_eout, d_agg = grads if ctx.write_edges else (None, grads[0])
    de, dsproj, drproj, dwe, db0, dw1, db1, dscale, doff = (
        fused_edge_backward(ctx.edges, e, sproj, rproj, we, b0, w1, b1,
                            scale, d_eout, d_agg))
    return (None, None, de, dsproj, drproj, dwe, db0, dw1, db1, dscale,
            doff.to(ctx.offset_dtype))


def _launch_fused_edge_embed(edges: EdgeIndex, features, sproj, rproj, we,
                             b0, w1, b1, scale, offset, embed_weights):
  """K1 in embed mode on CUDA tensors, aggregation only (checks, then one
  launch)."""
  mats, vecs = _embed_operands(edges, features, sproj, rproj, we, b0, w1, b1,
                               scale, offset, embed_weights)
  E, F = features.shape
  C = sproj.shape[1]
  dev = sproj.device
  lib = build.load_library()
  agg = torch.zeros(edges.num_receivers, C, dtype=torch.float32, device=dev)
  code = lib.gc_fused_edge_embed(
      mats["features"].data_ptr(), mats["ew0"].data_ptr(),
      vecs["eb0"].data_ptr(), mats["ew1"].data_ptr(), vecs["eb1"].data_ptr(),
      sproj.data_ptr(), edges.senders.data_ptr(), rproj.data_ptr(),
      edges.receivers.data_ptr(), mats["we"].data_ptr(),
      vecs["b0"].data_ptr(), mats["w1"].data_ptr(), vecs["b1"].data_ptr(),
      vecs["scale"].data_ptr(), vecs["offset"].data_ptr(), agg.data_ptr(),
      E, F, C, torch.cuda.current_stream(dev).cuda_stream)
  build.check(lib, code, "fused_edge embed kernel launch")
  fused_edge.launches += 1
  fused_edge.embed_launches += 1
  return agg


def _embed_operands(edges: EdgeIndex, features, sproj, rproj, we, b0, w1,
                    b1, scale, offset, embed_weights):
  """Checks embed-mode operands on CUDA; returns (bf16 matrices with the
  features, f32 vectors)."""
  E, F = features.shape
  C = sproj.shape[1]
  if not 1 <= F <= MAX_EMBED_FEATURES:
    raise ValueError(f"embed mode takes 1 to {MAX_EMBED_FEATURES} raw "
                     f"features, got {F}")
  dev = sproj.device
  _check_edge_shapes(edges, E, C, sproj, rproj, features.device)
  ew0, eb0, ew1, eb1 = embed_weights
  ew0 = ew0.to(torch.bfloat16).contiguous()
  if ew0.shape != (F, C):
    raise ValueError(f"ew0 must have shape ({F}, {C})")
  mats = {"features": features.to(torch.bfloat16).contiguous(),
          "sproj": sproj, "rproj": rproj, "ew0": ew0,
          "ew1": _matrix_bf16(ew1, C, "ew1"), "we": _matrix_bf16(we, C, "we"),
          "w1": _matrix_bf16(w1, C, "w1")}
  vecs = _vectors_f32(eb0=eb0, eb1=eb1, b0=b0, b1=b1, scale=scale,
                      offset=offset)
  _check_cuda(mats, dev, torch.bfloat16)
  _check_vectors(vecs, dev, C)
  return mats, vecs


def fused_edge_embed_backward(edges: EdgeIndex, features, sproj, rproj, we,
                              b0, w1, b1, scale, embed_weights, d_agg):
  """K4 in embed mode: the gradients of one aggregation-only embed-mode
  step on CUDA tensors, for the cotangent d_agg ([N, C]).

  Returns (dfeatures, dsproj, drproj, dwe, db0, dw1, db1, dscale, doff,
  (dew0, deb0, dew1, deb1)), each in its input's dtype (doff f32). Row
  chunks of ``BWD_CHUNK_ROWS`` edges: each runs the per-row kernel (one
  launch, counted in ``fused_edge_backward.launches`` and
  ``.embed_launches``), the reductions dW1 = hᵀ·dy, dWe' = enᵀ·dx0 and dEw1
  = hhᵀ·dy0 (ops/weight_grad.py), dEw0 and the raw-feature gradient
  (``feature_grad``), and the f32 scatter of the sender gradients.
  """
  mats, vecs = _embed_operands(edges, features, sproj, rproj, we, b0, w1, b1,
                               scale, None, embed_weights)
  E, F = features.shape
  C = sproj.shape[1]
  dev = sproj.device
  bf16, f32 = torch.bfloat16, torch.float32
  tr = {k: mats[k].t().contiguous() for k in ("ew1", "we", "w1")}
  d_agg = d_agg.to(f32).contiguous()
  if d_agg.shape != (edges.num_receivers, C):
    raise ValueError(f"d_agg must have shape ({edges.num_receivers}, {C})")

  lib = build.load_library()
  dgs = torch.empty(E, C, dtype=bf16, device=dev)
  dgr = torch.zeros(edges.num_receivers, C, dtype=f32, device=dev)
  dsproj = torch.zeros(edges.num_senders, C, dtype=f32, device=dev)
  sums = torch.zeros(6, C, dtype=f32, device=dev)
  dw = {k: torch.zeros(C, C, dtype=f32, device=dev)
        for k in ("w1", "we", "ew1")}
  dew0 = torch.zeros(F, C, dtype=f32, device=dev)
  dfeat = torch.empty(E, F, dtype=f32, device=dev)
  rows = min(E, BWD_CHUNK_ROWS)
  buf = {k: torch.empty(rows, C, dtype=bf16, device=dev)
         for k in ("h", "dy", "en", "hh", "dy0", "dxe")}
  en32 = torch.empty(rows, C, dtype=f32, device=dev)
  stream = torch.cuda.current_stream(dev).cuda_stream
  feats = mats["features"]
  for r0 in range(0, E, BWD_CHUNK_ROWS):
    n = min(BWD_CHUNK_ROWS, E - r0)
    part = slice(r0, r0 + n)
    code = lib.gc_fused_edge_bwd_embed(
        feats[part].data_ptr(), mats["ew0"].data_ptr(),
        vecs["eb0"].data_ptr(), mats["ew1"].data_ptr(),
        tr["ew1"].data_ptr(), vecs["eb1"].data_ptr(), sproj.data_ptr(),
        edges.senders[part].data_ptr(), rproj.data_ptr(),
        edges.receivers[part].data_ptr(), mats["we"].data_ptr(),
        tr["we"].data_ptr(), vecs["b0"].data_ptr(), mats["w1"].data_ptr(),
        tr["w1"].data_ptr(), vecs["b1"].data_ptr(),
        vecs["scale"].data_ptr(), d_agg.data_ptr(), buf["h"].data_ptr(),
        buf["dy"].data_ptr(), dgs[part].data_ptr(), dgr.data_ptr(),
        sums.data_ptr(), buf["en"].data_ptr(), en32.data_ptr(),
        buf["hh"].data_ptr(), buf["dy0"].data_ptr(), buf["dxe"].data_ptr(),
        n, F, C, stream)
    build.check(lib, code, "fused_edge_bwd embed kernel launch")
    fused_edge_backward.launches += 1
    fused_edge_backward.embed_launches += 1
    weight_grad(buf["h"][:n], buf["dy"][:n], dw["w1"])
    weight_grad(buf["en"][:n], dgs[part], dw["we"])
    weight_grad(buf["hh"][:n], buf["dy0"][:n], dw["ew1"])
    dfeat[part] = feature_grad(feats[part], buf["dxe"][:n], mats["ew0"],
                               dew0)
    dsproj.index_add_(0, edges.senders[part].long(), dgs[part].float())
  ew0, eb0, ew1, eb1 = embed_weights
  dembed = (dew0.to(ew0.dtype), sums[5].to(eb0.dtype),
            dw["ew1"].to(ew1.dtype), sums[4].to(eb1.dtype))
  return (dfeat.to(features.dtype), dsproj.to(sproj.dtype),
          dgr.to(rproj.dtype), dw["we"].to(we.dtype), sums[3].to(b0.dtype),
          dw["w1"].to(w1.dtype), sums[2].to(b1.dtype),
          sums[0].to(scale.dtype), sums[1], dembed)


fused_edge_backward.embed_launches = 0


class _FusedEdgeEmbedFunction(torch.autograd.Function):
  """K1 in embed mode forward, K4's embed mode backward (module doc).
  Saves only the inputs."""

  @staticmethod
  def forward(ctx, edges, features, sproj, rproj, we, b0, w1, b1, scale,
              offset, ew0, eb0, ew1, eb1):
    ctx.edges = edges
    ctx.offset_dtype = offset.dtype
    ctx.save_for_backward(features, sproj, rproj, we, b0, w1, b1, scale, ew0,
                          eb0, ew1, eb1)
    return _launch_fused_edge_embed(edges, features, sproj, rproj, we, b0,
                                    w1, b1, scale, offset,
                                    (ew0, eb0, ew1, eb1))

  @staticmethod
  def backward(ctx, d_agg):
    (features, sproj, rproj, we, b0, w1, b1, scale, *embed) = (
        ctx.saved_tensors)
    *grads, doff, dembed = fused_edge_embed_backward(
        ctx.edges, features, sproj, rproj, we, b0, w1, b1, scale, embed,
        d_agg)
    return (None, *grads, doff.to(ctx.offset_dtype), *dembed)


def fused_edge(edges: EdgeIndex, e: torch.Tensor, sproj: torch.Tensor,
               rproj: torch.Tensor, we: Optional[torch.Tensor],
               b0: Optional[torch.Tensor], w1: torch.Tensor,
               b1: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
               write_edges: bool = True, embed_weights=None):
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
    embed_weights: (ew0 [F, C], eb0, ew1 [C, C], eb1) for embed mode, where
      ``e`` holds the raw [E, F] edge features; needs ``we``.
  """
  if (we is None) != (b0 is None):
    raise ValueError("pass we and b0 together")
  if embed_weights is not None and we is None:
    raise ValueError("embed mode requires the edge matmul (we, b0)")
  if e.device.type == "cpu":
    return fused_edge_reference(edges, e, sproj, rproj, we, b0, w1, b1,
                                scale, offset, write_edges, embed_weights)
  if e.device.type != "cuda":
    raise ValueError(f"unsupported device {e.device}")
  if embed_weights is not None:
    if write_edges:
      raise NotImplementedError(
          "the embed mode kernel runs aggregation-only (write_edges=False)")
    inputs = (e, sproj, rproj, we, b0, w1, b1, scale, offset, *embed_weights)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
      return _FusedEdgeEmbedFunction.apply(edges, *inputs)
    return _launch_fused_edge_embed(edges, e, sproj, rproj, we, b0, w1, b1,
                                    scale, offset, embed_weights)
  inputs = (e, sproj, rproj, we, b0, w1, b1, scale, offset)
  if torch.is_grad_enabled() and any(
      t is not None and t.requires_grad for t in inputs):
    if (we is None) == write_edges:
      raise NotImplementedError(
          "the backward kernel covers processor mode (we, e' written) and "
          "encoder mode (no we, aggregation only)")
    return _FusedEdgeFunction.apply(edges, write_edges, *inputs)
  return _launch_fused_edge(edges, *inputs, write_edges)


fused_edge.launches = 0          # every K1 launch
fused_edge.encoder_launches = 0  # the encoder-mode ones among them
fused_edge.embed_launches = 0    # the embed-mode ones among them
