"""K2, the fused mesh2grid decoder (ops/fused_decoder.py,
csrc/fused_decoder.cu), plain mode: per grid node its projection, three
edge MLPs on the static edge parts, their sum, the node MLP and the output
MLP. chip_smoke.py's ``_decoder_cost``, plain mode."""


def count(grid: int, mesh: int, width: int, outputs: int
          ) -> tuple[float, float]:
  """(operations, bytes) of one launch, bf16 activations: per grid node 8
  width x width products (its projection, 3 edge second layers, the node
  MLP's 3, the output MLP's first) and one width x outputs."""
  G, M, C, NO = grid, mesh, width, outputs
  flops = G * (16 * C * C + 2 * C * NO)
  mats = (6 * C * C + C * NO) * 2
  nbytes = (G * C * 2          # grid latents
            + M * C * 2        # mesh projections
            + 3 * G * C * 2    # the static edge parts
            + 12 * G           # sender indices
            + G * NO * 2       # outputs
            + mats)
  return float(flops), float(nbytes)
