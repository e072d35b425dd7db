"""K1 in processor mode (``fused_edge_kernel<true, true, false>``, one
launch a processor step over the multi-mesh's edges): the least time of
its launches a step (counts/k1.py) over their device time, in %."""

from portbench import readers
from portbench.counts import k1

K1 = readers.kernels(r"fused_edge_kernel<true, true, false>")


def read(ctx):
  if ctx.trace is None:
    return None
  n = readers.launches(ctx, K1)
  flops, nbytes = k1.count(ctx.sizes["mesh"], ctx.sizes["num_mesh"],
                           ctx.sizes["num_mesh"], ctx.cfg["latent_size"])
  return readers.roofline(ctx, K1, n * flops, n * nbytes)
