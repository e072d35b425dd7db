"""K2: the fused mesh2grid decoder, and its plain-PyTorch twin.

Replaces graphcast_tpu/ops/pallas_decoder.py::_decoder_kernel (ground truth:
``FusedMesh2GridDecoder._reference_math``, plain mode). Every grid node has
exactly 3 incoming edges, rows 3v..3v+2 of the receiver-sorted edge list;
one call runs the whole decoder per grid node:

    gproj = g @ Wr
    y_j   = LN(swish(bf16(const_j + mesh_proj[snd_j] + gproj)) @ W1 + b1)
            * escale + eoffset                      j = 0, 1, 2
    agg   = y_0 + y_1 + y_2                         (f32)
    upd   = LN(swish(bf16(g @ Wng + bf16(agg) @ Wna + bn0)) @ Wn1 + bn1)
            * nscale + noffset
    res   = bf16(g + upd)
    out   = swish(bf16(res @ Wd0 + bd0)) @ Wd1 + bd1

``const`` is the hoisted static part embed(edge features) @ We + b0, in the
edge list's own order ([3G, C]); the sender rows are gathered by index (the
TPU version's compact per-block sender tables are a gather workaround for
the TPU and are not ported).

All weights are cast to the activation dtype at use (vectors too, then used
in f32), as the TPU kernel receives them. ``fused_decode`` runs the CUDA
kernel (csrc/fused_decoder.cu) for CUDA tensors and the twin for CPU tensors.
"""

from __future__ import annotations

import torch

from graphcast_tpu_torch.native import build
from graphcast_tpu_torch.ops.fused_edge import (
    EdgeIndex, _check_cuda, _no_grad_inputs, layer_norm_f32, swish_of)

MATRICES = ("wr", "w1", "wng", "wna", "wn1", "wd0", "wd1")
VECTORS = ("b1", "escale", "eoffset", "bn0", "bn1", "nscale", "noffset",
           "bd0", "bd1")


def fused_decode_reference(edges: EdgeIndex, grid, mesh_proj, const,
                           weights: dict):
  """Plain-PyTorch twin of the K2 kernel (same rounding points)."""
  G, C = grid.shape
  dtype = grid.dtype
  w = {k: v.to(dtype).float() for k, v in weights.items()}
  gs = mesh_proj[edges.senders.long()].float().view(G, 3, C)
  const = const.float().view(G, 3, C)
  g32 = grid.float()
  gproj = g32 @ w["wr"]
  agg = torch.zeros_like(gproj)
  for j in range(3):
    h = swish_of(const[:, j] + gs[:, j] + gproj, dtype)
    y = h.float() @ w["w1"] + w["b1"]
    agg = agg + layer_norm_f32(y, w["escale"], w["eoffset"])
  x = g32 @ w["wng"] + agg.to(dtype).float() @ w["wna"] + w["bn0"]
  h = swish_of(x, dtype)
  upd = layer_norm_f32(h.float() @ w["wn1"] + w["bn1"], w["nscale"],
                       w["noffset"])
  res = (g32 + upd).to(dtype)
  h = swish_of(res.float() @ w["wd0"] + w["bd0"], dtype)
  return (h.float() @ w["wd1"] + w["bd1"]).to(dtype)


def fused_decode(edges: EdgeIndex, grid: torch.Tensor,
                 mesh_proj: torch.Tensor, const: torch.Tensor,
                 weights: dict) -> torch.Tensor:
  """The fused decoder (module doc). Returns [G, num_outputs] in the
  activation dtype.

  Args:
    edges: the mesh2grid edge list, 3 rows per grid node.
    grid: [G, C] grid latents; mesh_proj: [M, C] mesh latents @ Ws;
      const: [3G, C] hoisted static edge part (activation dtype).
    weights: wr, w1, wng, wna, wn1, wd0 [C, C], wd1 [C, num_outputs];
      b1, escale, eoffset, bn0, bn1, nscale, noffset, bd0 [C],
      bd1 [num_outputs].
  """
  if set(weights) != set(MATRICES + VECTORS):
    raise ValueError(f"weights must have keys {MATRICES + VECTORS}")
  if not edges.three_per_receiver:
    raise ValueError("the decoder needs exactly 3 receiver-sorted edges per "
                     "grid node")
  if grid.device.type == "cpu":
    return fused_decode_reference(edges, grid, mesh_proj, const, weights)
  if grid.device.type != "cuda":
    raise ValueError(f"unsupported device {grid.device}")
  _no_grad_inputs(grid, mesh_proj, const, *weights.values())
  G, C = grid.shape
  num_out = weights["wd1"].shape[1]
  no_pad = -(-num_out // 128) * 128
  dev = grid.device
  bf16 = torch.bfloat16
  if C % 128 or not 128 <= C <= 512 or no_pad > 512:
    raise ValueError(f"latent width {C} must be a multiple of 128 in "
                     f"[128, 512], outputs ({num_out}) at most 512")
  if G != edges.num_receivers or mesh_proj.shape != (edges.num_senders, C):
    raise ValueError("grid/mesh_proj shapes do not match the edge list")
  if const.shape != (edges.num_edges, C):
    raise ValueError(f"const must have shape ({edges.num_edges}, {C})")
  if edges.device != dev:
    raise ValueError(f"edge list is on {edges.device}, tensors on {dev}")
  mats = {k: weights[k].to(bf16).contiguous() for k in MATRICES}
  vecs = {k: weights[k].to(bf16).float().contiguous() for k in VECTORS}
  for k in MATRICES[:-1]:
    if mats[k].shape != (C, C):
      raise ValueError(f"{k} must have shape ({C}, {C})")
  for k in VECTORS[:-1]:
    if vecs[k].shape != (C,):
      raise ValueError(f"{k} must have shape ({C},)")
  if mats["wd1"].shape != (C, num_out) or vecs["bd1"].shape != (num_out,):
    raise ValueError("wd1/bd1 shapes disagree")
  # Output columns padded to whole 128-column passes of the kernel's product.
  mats["wd1"] = torch.nn.functional.pad(
      mats["wd1"], (0, no_pad - num_out)).contiguous()
  vecs["bd1"] = torch.nn.functional.pad(vecs["bd1"], (0, no_pad - num_out))
  _check_cuda({"grid": grid, "mesh_proj": mesh_proj, "const": const, **mats},
              dev, bf16)
  _check_cuda(vecs, dev, torch.float32)

  lib = build.load_library()
  out = torch.empty(G, num_out, dtype=bf16, device=dev)
  code = lib.gc_fused_decoder(
      grid.data_ptr(), mesh_proj.data_ptr(), const.data_ptr(),
      edges.senders.data_ptr(), mats["wr"].data_ptr(), mats["w1"].data_ptr(),
      vecs["b1"].data_ptr(), vecs["escale"].data_ptr(),
      vecs["eoffset"].data_ptr(), mats["wng"].data_ptr(),
      mats["wna"].data_ptr(), vecs["bn0"].data_ptr(), mats["wn1"].data_ptr(),
      vecs["bn1"].data_ptr(), vecs["nscale"].data_ptr(),
      vecs["noffset"].data_ptr(), mats["wd0"].data_ptr(),
      vecs["bd0"].data_ptr(), mats["wd1"].data_ptr(), vecs["bd1"].data_ptr(),
      out.data_ptr(), G, C, no_pad, num_out,
      torch.cuda.current_stream(dev).cuda_stream)
  build.check(lib, code, "fused_decoder kernel launch")
  fused_decode.launches += 1
  return out


fused_decode.launches = 0
