"""K1, the fused edge step (ops/fused_edge.py, csrc/fused_edge.cu), in
processor mode: per edge row x = e·We + sproj[s] + rproj[r] + b0,
y = LayerNorm(swish(x)·W1 + b1), e' = e + y written, y summed into the
receivers in float32. chip_smoke.py's ``_edge_cost``, processor mode."""


def count(edges: int, senders: int, receivers: int, width: int
          ) -> tuple[float, float]:
  """(operations, bytes) of one launch over ``edges`` rows of ``width``
  latents, bf16 activations."""
  E, C = edges, width
  flops = 2 * 2 * E * C * C                    # e·We, h·W1
  nbytes = (2 * E * C * 2                      # e read, e' written
            + 8 * E                            # sender and receiver indices
            + (senders + receivers) * C * 2    # sproj, rproj rows
            + receivers * C * 4                # the f32 sums
            + 2 * C * C * 2)                   # We, W1
  return float(flops), float(nbytes)
