"""K4, the fused edge step's backward (ops/fused_edge.py
``fused_edge_backward``, csrc/fused_edge_bwd.cu), processor mode: the
kernel's own products only. For each forward product X·W the kernel makes
dX = dY·Wᵀ (dh = dy·W1ᵀ, de = dx·Weᵀ); the weight gradients Xᵀ·dY are
``weight_grad``'s launches and the sender sums K3's, counted apart. The
forward it recomputes is not counted: a backward that kept its
activations would do the same work without it."""


def count(edges: int, senders: int, receivers: int, width: int
          ) -> tuple[float, float]:
  """(operations, bytes) of the K4 launches over ``edges`` rows."""
  E, C = edges, width
  flops = 2 * 2 * E * C * C                     # dy·W1ᵀ, dx·Weᵀ
  nbytes = (2 * E * C * 2                       # e and d e' read
            + 8 * E                             # indices
            + (senders + receivers) * C * 2     # sproj, rproj rows
            + receivers * C * 4                 # d agg rows (f32)
            + 2 * E * C * 2                     # de and the sender rows
            + receivers * C * 4                 # d rproj (f32)
            + 2 * E * C * 2                     # h and dy for weight_grad
            + 2 * C * C * 2)                    # We, W1
  return float(flops), float(nbytes)
