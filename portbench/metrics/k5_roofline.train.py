"""K5 in plain mode (``fused_decoder_bwd_kernel<false, 0|1>``, its node
and edge passes, one decoder backward a step): the least time of its own
products (counts/k5.py, no recomputed forward) over the device time of
its launches, in %."""

from portbench import readers
from portbench.counts import k5

K5 = readers.kernels(r"fused_decoder_bwd_kernel<false, [01]>")


def read(ctx):
  if ctx.trace is None:
    return None
  if not readers.launches(ctx, K5):
    return None
  flops, nbytes = k5.count(ctx.sizes["num_grid"], ctx.sizes["num_mesh"],
                           ctx.cfg["latent_size"],
                           readers.graphcast_sizes(ctx)["outputs"])
  n = ctx.sizes["batch"]
  return readers.roofline(ctx, K5, n * flops, n * nbytes)
