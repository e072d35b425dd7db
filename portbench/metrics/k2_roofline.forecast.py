"""K2 in plain mode (``fused_decoder_kernel<false>``, the whole decoder
over every grid node): the least time of its launches a step
(counts/k2.py) over their device time, in %."""

from portbench import readers
from portbench.counts import k2

K2 = readers.kernels(r"fused_decoder_kernel<false>")


def read(ctx):
  if ctx.trace is None:
    return None
  n = readers.launches(ctx, K2)
  flops, nbytes = k2.count(ctx.sizes["num_grid"], ctx.sizes["num_mesh"],
                           ctx.cfg["latent_size"],
                           readers.graphcast_sizes(ctx)["outputs"])
  return readers.roofline(ctx, K2, n * flops, n * nbytes)
