"""K5, the fused decoder's backward (ops/fused_decoder.py
``fused_decode_backward``, csrc/fused_decoder_bwd*.cu), plain mode: the
kernels' own products only, dX = dY·Wᵀ for each of K2's forward products
(8 width x width and one width x outputs a grid node); the weight
gradients are ``weight_grad``'s launches, the sender sums K3's, and the
recomputed forward is not counted."""


def count(grid: int, mesh: int, width: int, outputs: int
          ) -> tuple[float, float]:
  """(operations, bytes) of the K5 launches of one backward."""
  G, M, C, NO = grid, mesh, width, outputs
  flops = G * (16 * C * C + 2 * C * NO)
  mats = (6 * C * C + C * NO) * 2
  nbytes = (G * C * 2          # grid latents read
            + M * C * 2        # mesh projections read
            + 3 * G * C * 2    # static edge parts read
            + 12 * G           # sender indices
            + G * NO * 4       # output cotangents (f32)
            + G * C * 2        # d grid latents written
            + 3 * G * C * 2    # per-edge sender gradients written
            + 3 * G * C * 2    # d static edge parts written
            + mats)
  return float(flops), float(nbytes)
