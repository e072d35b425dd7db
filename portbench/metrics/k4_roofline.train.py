"""K4 in processor mode (``fused_edge_bwd_kernel<true, false>``, launched
in row chunks, one backward a processor step): the least time of its own
products a step (counts/k4.py, no recomputed forward) over the device
time of its launches, in %."""

from portbench import readers
from portbench.counts import k4

K4 = readers.kernels(r"fused_edge_bwd_kernel<true, false>")


def read(ctx):
  if ctx.trace is None:
    return None
  if not readers.launches(ctx, K4):
    return None
  flops, nbytes = k4.count(ctx.sizes["mesh"], ctx.sizes["num_mesh"],
                           ctx.sizes["num_mesh"], ctx.cfg["latent_size"])
  steps = ctx.cfg["gnn_msg_steps"] * ctx.sizes["batch"]
  return readers.roofline(ctx, K4, steps * flops, steps * nbytes)
