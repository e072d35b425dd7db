"""K2: the fused mesh2grid decoder, its backward K5, and the plain-PyTorch
twin.

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

Embed mode (GenCast's mesh2grid, pallas_decoder.py:116-124): with the extra
weights ``EMBED_KEYS`` (ew0, eb0, ew1, eb1, we, b0), ``const`` holds the raw
[3G, F] edge features, and each slot starts from

    en_j = bf16(LN0(bf16(swish(bf16(f_j @ ew0 + eb0))) @ ew1 + eb1))
    x0_j = en_j @ We' + b0' + mesh_proj[snd_j] + gproj

with LN0 parameter-free; the caller folds the norm conditioning into We',
b0', escale/eoffset and nscale/noffset.

All weights are cast to the activation dtype at use (vectors too, then used
in f32), as the TPU kernel receives them. ``fused_decode`` runs the CUDA
kernel (csrc/fused_decoder.cu) for CUDA tensors and the twin for CPU tensors.
Both kernels (csrc/decoder.cuh) run a cluster of two 64-node blocks that
share every weight box by TMA multicast; ``smem_layout`` is their shared
memory plan, made here so that the CPU tests can check it.

Gradients: on CUDA tensors that require grad, K2 runs inside a
``torch.autograd.Function`` whose backward is K5 (``fused_decode_backward``;
csrc/fused_decoder_bwd.cu + csrc/weight_grad.cu), the port of
pallas_decoder.py::_decoder_bwd_kernel, in plain and embed mode (the embed
mode recomputes each slot's embed and adds the gradients of ew0, eb0, ew1,
eb1, we and b0, and of the raw features). On CPU tensors the twin runs
under plain autograd.
"""

from __future__ import annotations

import torch

from graphcast_tpu_torch.native import build
from graphcast_tpu_torch.ops import segment_sum
from graphcast_tpu_torch.ops.fused_edge import (
    MAX_EMBED_FEATURES, EdgeIndex, _check_cuda, embed_edges_reference,
    layer_norm_f32, max_blocks, swish_of)
from graphcast_tpu_torch.ops.weight_grad import feature_grad, weight_grad

MATRICES = ("wr", "w1", "wng", "wna", "wn1", "wd0", "wd1")
VECTORS = ("b1", "escale", "eoffset", "bn0", "bn1", "nscale", "noffset",
           "bd0", "bd1")
KEYS = MATRICES + VECTORS
EMBED_KEYS = ("ew0", "eb0", "ew1", "eb1", "we", "b0")
# Grid nodes per K5 launch: bounds its scratch of 14 bf16 rows per node
# (1.9 GB at C = 512; embed mode 26 bf16 rows and 3 f32 rows, 4.3 GB).
BWD_CHUNK_NODES = 1 << 17
# K5's column sums, in the kernel's order (csrc/fused_decoder_bwd.cu); embed
# mode appends _BWD_SUMS_EMBED.
_BWD_SUMS = ("bd0", "noffset", "nscale", "bn1", "bn0", "eoffset", "escale",
             "b1")
_BWD_SUMS_EMBED = ("b0", "eb1", "eb0")
# K5's scratch slabs (csrc/fused_decoder_bwd.cu): per node, then per edge
# (3 slabs each); embed mode adds hh, en, dy0 and dxe per edge.
_SLABS = {"agg": 0, "hn": 1, "res": 2, "ho": 3, "dxo": 4, "dyn": 5,
          "dxn": 6, "dgproj": 7, "hs": 8, "dys": 11, "hh": 14, "en": 17,
          "dy0": 20, "dxe": 23}
# The kernels' block plan (csrc/decoder.cuh): the latent width they are
# built for (a narrower one runs in the same layout, zero-padded), grid
# nodes per block, blocks per cluster, the weight box, the shared memory a
# block may have, the ring's cap, the alignment slack, the row exchange.
WIDTH = 512
ROWS = 64
CLUSTER = 2
BOX = 64 * 64 * 2
SMEM_LIMIT = 232448
MAX_STAGES = 16
ALIGN = 1008
EXCHANGE = 2 * 2 * ROWS * 8
# K5's per-block work scratch in f32 per latent column (csrc kDecWork): an
# f32 tile of ROWS rows and two bf16 ones.
BWD_WORK = ROWS + 2 * ROWS // 2


def smem_layout(C: int, outputs: int, embed: bool = False,
                backward: bool = False) -> dict:
  """Shared memory of one block of K2 (``backward`` False) or K5 at latent
  width C, in bytes from its 1024-aligned base, as csrc/decoder.cuh
  dec_layout lays it out. Every width runs in the layout of WIDTH: the
  operand A (K5: wide enough for the padded outputs), the grid latents G,
  the weight ring (``stages`` boxes of BOX bytes, what is left up to
  MAX_STAGES, rounded down to an even count: csrc/decoder.cuh ClusterRing),
  the row exchange, K5's column sums and their
  per-warp parts, the barriers; ``total`` is the dynamic shared memory the
  launch asks for (with ALIGN bytes of slack)."""
  if C % 128 or not 128 <= C <= WIDTH or not 1 <= outputs <= 512:
    raise ValueError(f"latent width {C} or outputs {outputs} not taken")
  no_pad = -(-outputs // 128) * 128
  a_cols = max(WIDTH, no_pad) if backward else WIDTH
  kinds = len(_BWD_SUMS) + (len(_BWD_SUMS_EMBED) if embed else 0)
  sums = kinds * WIDTH + no_pad if backward else 0
  lay = {"a": 0, "g": a_cols // 64 * BOX}
  lay["ring"] = lay["g"] + WIDTH // 64 * BOX
  colred = 4 * WIDTH * 4 if sums else 0
  bars = (2 * MAX_STAGES + 2) * 8
  tail = EXCHANGE + sums * 4 + colred + bars
  lay["stages"] = min(MAX_STAGES, (SMEM_LIMIT - ALIGN - lay["ring"] - tail)
                      // BOX) & ~1
  lay["exchange"] = lay["ring"] + lay["stages"] * BOX
  lay["sums"] = lay["exchange"] + EXCHANGE
  lay["colred"] = lay["sums"] + sums * 4
  lay["bars"] = lay["colred"] + colred
  lay["total"] = lay["bars"] + bars + ALIGN
  return lay


def fused_decode_reference(edges: EdgeIndex, grid, mesh_proj, const,
                           weights: dict):
  """Plain-PyTorch twin of the K2 kernel (same rounding points)."""
  G, C = grid.shape
  dtype = grid.dtype
  w = {k: v.to(dtype).float() for k, v in weights.items()}
  # Gathered from an f32 copy: the gather's backward sums in f32, as K5's
  # sender scatter does.
  gs = mesh_proj.float()[edges.senders.long()].view(G, 3, C)
  embed = "ew0" in w
  const = const.view(G, 3, -1)
  g32 = grid.float()
  gproj = g32 @ w["wr"]
  agg = torch.zeros_like(gproj)
  for j in range(3):
    if embed:
      en = embed_edges_reference(const[:, j],
                                 [w[k] for k in EMBED_KEYS[:4]], dtype)
      cj = en.float() @ w["we"] + w["b0"]
    else:
      cj = const[:, j].float()
    h = swish_of(cj + gs[:, j] + gproj, dtype)
    y = h.float() @ w["w1"] + w["b1"]
    agg = agg + layer_norm_f32(y, w["escale"], w["eoffset"])
  x = g32 @ w["wng"] + agg.to(dtype).float() @ w["wna"] + w["bn0"]
  h = swish_of(x, dtype)
  upd = layer_norm_f32(h.float() @ w["wn1"] + w["bn1"], w["nscale"],
                       w["noffset"])
  res = (g32 + upd).to(dtype)
  h = swish_of(res.float() @ w["wd0"] + w["bd0"], dtype)
  return (h.float() @ w["wd1"] + w["bd1"]).to(dtype)


def _kernel_operands(edges: EdgeIndex, grid, mesh_proj, const,
                     weights: dict):
  """Checks K2/K5 operands on CUDA; returns (C, num_out, no_pad, bf16
  matrices with wd1 padded, f32 vectors with bd1 padded; in embed mode
  also ew0, ew1, we and eb0, eb1, b0)."""
  embed = "ew0" in weights
  if set(weights) != set(KEYS + EMBED_KEYS if embed else KEYS):
    raise ValueError(f"weights must have keys {KEYS}, plus {EMBED_KEYS} "
                     "in embed mode")
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
  F = const.shape[1]
  if const.shape[0] != edges.num_edges or (F != C and not embed):
    raise ValueError(f"const must have shape ({edges.num_edges}, {C})")
  if embed and not 1 <= F <= MAX_EMBED_FEATURES:
    raise ValueError(f"embed mode takes 1 to {MAX_EMBED_FEATURES} raw "
                     f"features, got {F}")
  if edges.device != dev:
    raise ValueError(f"edge list is on {edges.device}, tensors on {dev}")
  mat_keys = MATRICES + (("ew0", "ew1", "we") if embed else ())
  vec_keys = VECTORS + (("eb0", "eb1", "b0") if embed else ())
  mats = {k: weights[k].to(bf16).contiguous() for k in mat_keys}
  vecs = {k: weights[k].to(bf16).float().contiguous() for k in vec_keys}
  if embed and mats["ew0"].shape != (F, C):
    raise ValueError(f"ew0 must have shape ({F}, {C})")
  for k in mat_keys:
    if k not in ("wd1", "ew0") and mats[k].shape != (C, C):
      raise ValueError(f"{k} must have shape ({C}, {C})")
  for k in vec_keys:
    if k != "bd1" and vecs[k].shape != (C,):
      raise ValueError(f"{k} must have shape ({C},)")
  if mats["wd1"].shape != (C, num_out) or vecs["bd1"].shape != (num_out,):
    raise ValueError("wd1/bd1 shapes disagree")
  # Output columns padded to whole 128-column passes of the kernel's product;
  # the other vectors (and ew0's columns) zero-padded to the kernels' WIDTH.
  mats["wd1"] = torch.nn.functional.pad(
      mats["wd1"], (0, no_pad - num_out)).contiguous()
  vecs = {k: torch.nn.functional.pad(v, (0, (no_pad - num_out) if k == "bd1"
                                         else WIDTH - C)).contiguous()
          for k, v in vecs.items()}
  if embed:
    mats["ew0_pad"] = torch.nn.functional.pad(
        mats["ew0"], (0, WIDTH - C)).contiguous()
  _check_cuda({"grid": grid, "mesh_proj": mesh_proj, "const": const, **mats},
              dev, bf16)
  _check_cuda(vecs, dev, torch.float32)
  return C, num_out, no_pad, mats, vecs


def _launch_fused_decode(edges: EdgeIndex, grid, mesh_proj, const,
                         weights: dict) -> torch.Tensor:
  """K2 on CUDA tensors (checks, then one launch)."""
  embed = "ew0" in weights
  if embed:
    const = const.to(torch.bfloat16).contiguous()
  C, num_out, no_pad, mats, vecs = _kernel_operands(edges, grid, mesh_proj,
                                                    const, weights)
  G = grid.shape[0]
  lib = build.load_library()
  out = torch.empty(G, num_out, dtype=torch.bfloat16, device=grid.device)
  blocks = max_blocks(grid.device)
  agg = torch.empty(blocks, ROWS * WIDTH, dtype=torch.float32,
                    device=grid.device)
  stream = torch.cuda.current_stream(grid.device).cuda_stream
  if embed:
    code = lib.gc_fused_decoder_embed(
        grid.data_ptr(), mesh_proj.data_ptr(), const.data_ptr(),
        edges.senders.data_ptr(), mats["ew0_pad"].data_ptr(),
        vecs["eb0"].data_ptr(), mats["ew1"].data_ptr(),
        vecs["eb1"].data_ptr(), mats["we"].data_ptr(), vecs["b0"].data_ptr(),
        mats["wr"].data_ptr(), mats["w1"].data_ptr(),
        vecs["b1"].data_ptr(), vecs["escale"].data_ptr(),
        vecs["eoffset"].data_ptr(), mats["wng"].data_ptr(),
        mats["wna"].data_ptr(), vecs["bn0"].data_ptr(),
        mats["wn1"].data_ptr(), vecs["bn1"].data_ptr(),
        vecs["nscale"].data_ptr(), vecs["noffset"].data_ptr(),
        mats["wd0"].data_ptr(), vecs["bd0"].data_ptr(),
        mats["wd1"].data_ptr(), vecs["bd1"].data_ptr(), out.data_ptr(),
        agg.data_ptr(), G, C, no_pad, num_out, const.shape[1], blocks,
        stream)
    build.check(lib, code, "fused_decoder embed kernel launch")
    fused_decode.launches += 1
    fused_decode.embed_launches += 1
    return out
  code = lib.gc_fused_decoder(
      grid.data_ptr(), mesh_proj.data_ptr(), const.data_ptr(),
      edges.senders.data_ptr(), mats["wr"].data_ptr(), mats["w1"].data_ptr(),
      vecs["b1"].data_ptr(), vecs["escale"].data_ptr(),
      vecs["eoffset"].data_ptr(), mats["wng"].data_ptr(),
      mats["wna"].data_ptr(), vecs["bn0"].data_ptr(), mats["wn1"].data_ptr(),
      vecs["bn1"].data_ptr(), vecs["nscale"].data_ptr(),
      vecs["noffset"].data_ptr(), mats["wd0"].data_ptr(),
      vecs["bd0"].data_ptr(), mats["wd1"].data_ptr(), vecs["bd1"].data_ptr(),
      out.data_ptr(), agg.data_ptr(), G, C, no_pad, num_out, blocks, stream)
  build.check(lib, code, "fused_decoder kernel launch")
  fused_decode.launches += 1
  return out


def fused_decode_backward(edges: EdgeIndex, grid, mesh_proj, const,
                          weights: dict, dout):
  """K5: the gradients of the fused decoder on CUDA tensors.

  Returns (dgrid, dmesh_proj, dconst, {key: dweight}): dgrid in the
  activation dtype, dmesh_proj in mesh_proj's dtype (an f32 sum of the
  per-edge sender gradients, as the JAX package does outside its kernel),
  dconst in the activation dtype (embed mode: the raw features' gradient in
  their dtype), each weight gradient in f32, then cast to its weight's
  dtype. Chunks of ``BWD_CHUNK_NODES`` grid nodes: each runs the per-node
  kernel (one launch, counted in ``fused_decode_backward.launches``, and
  ``.embed_launches`` in embed mode), the 7 matrix-gradient reductions
  (ops/weight_grad.py; embed mode adds We', Ew1 and ``feature_grad`` for Ew0
  and the raw features); then one fixed-order f32 sum of the per-edge sender
  gradients into the mesh nodes (K3's sender mode, ops/segment_sum.py).
  Every sum has a fixed order: a rerun at the same chunking is bit-equal.
  """
  embed = "ew0" in weights
  if embed:
    const = const.to(torch.bfloat16).contiguous()
  C, num_out, no_pad, mats, vecs = _kernel_operands(edges, grid, mesh_proj,
                                                    const, weights)
  G = grid.shape[0]
  dev = grid.device
  bf16, f32 = torch.bfloat16, torch.float32
  if dout.shape != (G, num_out):
    raise ValueError(f"dout must have shape ({G}, {num_out})")
  dout = torch.nn.functional.pad(dout.to(bf16),
                                 (0, no_pad - num_out)).contiguous()
  lib = build.load_library()
  dgrid = torch.empty(G, C, dtype=bf16, device=dev)
  dgs = torch.empty(3 * G, C, dtype=bf16, device=dev)
  sum_keys = _BWD_SUMS + (_BWD_SUMS_EMBED if embed else ())
  sums = torch.zeros(len(sum_keys) * C + no_pad, dtype=f32, device=dev)
  blocks = max_blocks(dev)
  work = torch.empty(blocks, BWD_WORK * WIDTH, dtype=f32, device=dev)
  partials = torch.empty(blocks, sums.numel(), dtype=f32, device=dev)
  slab_rows = min(G, BWD_CHUNK_NODES)
  # The node pass hands each tile's dg and dagg to the edge pass (tiles in
  # whole cluster pairs).
  tiles = -(-slab_rows // (2 * ROWS)) * 2
  dg_t = torch.empty(2, tiles, ROWS * WIDTH, dtype=f32, device=dev)
  dw = {k: torch.zeros(C, C, dtype=f32, device=dev) for k in MATRICES}
  dw["wd1"] = torch.zeros(C, no_pad, dtype=f32, device=dev)
  slabs = 26 if embed else 14
  scratch = torch.empty(slabs, slab_rows, C, dtype=bf16, device=dev)
  flat = scratch.view(slabs * slab_rows, C)
  if embed:
    F = const.shape[1]
    dw.update(we=torch.zeros(C, C, dtype=f32, device=dev),
              ew1=torch.zeros(C, C, dtype=f32, device=dev),
              ew0=torch.zeros(F, C, dtype=f32, device=dev))
    en32 = torch.empty(3 * slab_rows, C, dtype=f32, device=dev)
    rstd0 = torch.empty(3 * slab_rows, dtype=f32, device=dev)
    dconst = torch.empty(3 * G, F, dtype=f32, device=dev)
  else:
    dconst = dgs
  stream = torch.cuda.current_stream(dev).cuda_stream
  for v0 in range(0, G, BWD_CHUNK_NODES):
    n = min(BWD_CHUNK_NODES, G - v0)
    nodes, rows = slice(v0, v0 + n), slice(3 * v0, 3 * (v0 + n))
    common = (
        mats["wr"].data_ptr(), mats["w1"].data_ptr(), vecs["b1"].data_ptr(),
        vecs["escale"].data_ptr(), vecs["eoffset"].data_ptr(),
        mats["wng"].data_ptr(), mats["wna"].data_ptr(),
        vecs["bn0"].data_ptr(), mats["wn1"].data_ptr(),
        vecs["bn1"].data_ptr(), vecs["nscale"].data_ptr(),
        vecs["noffset"].data_ptr(), mats["wd0"].data_ptr(),
        vecs["bd0"].data_ptr(), mats["wd1"].data_ptr(),
        dout[nodes].data_ptr(), dgrid[nodes].data_ptr(), dgs[rows].data_ptr(),
        scratch.data_ptr())
    tail = (work.data_ptr(), dg_t[0].data_ptr(), dg_t[1].data_ptr(),
            partials.data_ptr(), sums.data_ptr(), slab_rows, n, C, no_pad)
    # The node pass, then the edge pass (csrc/fused_decoder_bwd.cu).
    for passes in ("nodes", "edges"):
      if embed:
        code = getattr(lib, f"gc_fused_decoder_bwd_embed_{passes}")(
            grid[nodes].data_ptr(), mesh_proj.data_ptr(),
            const[rows].data_ptr(), edges.senders[rows].data_ptr(),
            mats["ew0_pad"].data_ptr(), vecs["eb0"].data_ptr(),
            mats["ew1"].data_ptr(), vecs["eb1"].data_ptr(),
            mats["we"].data_ptr(), vecs["b0"].data_ptr(), *common,
            en32.data_ptr(), rstd0.data_ptr(), *tail, F, blocks, stream)
      else:
        code = getattr(lib, f"gc_fused_decoder_bwd_{passes}")(
            grid[nodes].data_ptr(), mesh_proj.data_ptr(),
            const[rows].data_ptr(), edges.senders[rows].data_ptr(),
            *common, *tail, blocks, stream)
      build.check(lib, code, f"fused_decoder_bwd {passes} pass launch")
    fused_decode_backward.launches += 1
    fused_decode_backward.embed_launches += int(embed)

    def slab(name, k=1):
      s0 = _SLABS[name] * slab_rows
      return flat[s0:s0 + k * n]

    g = grid[nodes]
    weight_grad(slab("ho"), dout[nodes], dw["wd1"])
    weight_grad(slab("res"), slab("dxo"), dw["wd0"])
    weight_grad(slab("hn"), slab("dyn"), dw["wn1"])
    weight_grad(g, slab("dxn"), dw["wng"])
    weight_grad(slab("agg"), slab("dxn"), dw["wna"])
    weight_grad(slab("hs", 3), slab("dys", 3), dw["w1"])
    weight_grad(g, slab("dgproj"), dw["wr"])
    if embed:
      weight_grad(slab("en", 3), dgs[rows], dw["we"])
      weight_grad(slab("hh", 3), slab("dy0", 3), dw["ew1"])
      dconst[rows] = feature_grad(const[rows], slab("dxe", 3), mats["ew0"],
                                  dw["ew0"])
  dmesh = segment_sum.sender_segment_sum(edges, dgs)
  grads = dict(dw)
  grads["wd1"] = dw["wd1"][:, :num_out]
  grads.update({k: sums[i * C:(i + 1) * C] for i, k in enumerate(sum_keys)})
  grads["bd1"] = sums[len(sum_keys) * C:][:num_out]
  grads = {k: v.to(weights[k].dtype) for k, v in grads.items()}
  return dgrid, dmesh.to(mesh_proj.dtype), dconst, grads


fused_decode_backward.launches = 0        # every K5 launch
fused_decode_backward.embed_launches = 0  # the embed-mode ones among them


class _FusedDecodeFunction(torch.autograd.Function):
  """K2 forward, K5 backward (module doc), plain or embed mode by ``keys``.
  Saves only the inputs."""

  @staticmethod
  def forward(ctx, edges, keys, grid, mesh_proj, const, *weight_values):
    ctx.edges, ctx.keys = edges, keys
    ctx.const_dtype = const.dtype
    ctx.save_for_backward(grid, mesh_proj, const, *weight_values)
    return _launch_fused_decode(edges, grid, mesh_proj, const,
                                dict(zip(keys, weight_values)))

  @staticmethod
  def backward(ctx, dout):
    grid, mesh_proj, const, *weight_values = ctx.saved_tensors
    weights = dict(zip(ctx.keys, weight_values))
    dgrid, dmesh, dconst, dweights = fused_decode_backward(
        ctx.edges, grid, mesh_proj, const, weights, dout.contiguous())
    return (None, None, dgrid, dmesh, dconst.to(ctx.const_dtype),
            *(dweights[k] for k in ctx.keys))


def fused_decode(edges: EdgeIndex, grid: torch.Tensor,
                 mesh_proj: torch.Tensor, const: torch.Tensor,
                 weights: dict) -> torch.Tensor:
  """The fused decoder (module doc). Returns [G, num_outputs] in the
  activation dtype.

  Args:
    edges: the mesh2grid edge list, 3 rows per grid node.
    grid: [G, C] grid latents; mesh_proj: [M, C] mesh latents @ Ws;
      const: [3G, C] hoisted static edge part (activation dtype), or in
      embed mode the raw [3G, F] edge features.
    weights: wr, w1, wng, wna, wn1, wd0 [C, C], wd1 [C, num_outputs];
      b1, escale, eoffset, bn0, bn1, nscale, noffset, bd0 [C],
      bd1 [num_outputs]; embed mode adds ew0 [F, C], eb0, ew1 [C, C], eb1,
      we [C, C], b0.
  """
  embed = "ew0" in weights
  if set(weights) != set(KEYS + EMBED_KEYS if embed else KEYS):
    raise ValueError(f"weights must have keys {KEYS}, plus {EMBED_KEYS} "
                     "in embed mode")
  if not edges.three_per_receiver:
    raise ValueError("the decoder needs exactly 3 receiver-sorted edges per "
                     "grid node")
  if grid.device.type == "cpu":
    return fused_decode_reference(edges, grid, mesh_proj, const, weights)
  if grid.device.type != "cuda":
    raise ValueError(f"unsupported device {grid.device}")
  keys = KEYS + EMBED_KEYS if embed else KEYS
  if torch.is_grad_enabled() and any(
      t.requires_grad for t in (grid, mesh_proj, const,
                                *(weights[k] for k in keys))):
    return _FusedDecodeFunction.apply(edges, keys, grid, mesh_proj, const,
                                      *(weights[k] for k in keys))
  return _launch_fused_decode(edges, grid, mesh_proj, const, weights)


fused_decode.launches = 0        # every K2 launch
fused_decode.embed_launches = 0  # the embed-mode ones among them
