"""K6 (``splash_fwd_kernel``, once a transformer layer a denoiser
evaluation, the members and heads folded into its batch): the least time
of its launches a step (counts/k6.py) over their device time, in %."""

from portbench import readers
from portbench.counts import k6

K6 = readers.kernels(r"splash_fwd_kernel")


def read(ctx):
  if ctx.trace is None:
    return None
  n = readers.launches(ctx, K6)
  t = ctx.cfg["transformer"]
  flops, nbytes = k6.count(ctx.sizes["batch"], t["num_heads"],
                           ctx.sizes["num_mesh"],
                           t["d_model"] // t["num_heads"],
                           ctx.sizes["mask_nnz"])
  return readers.roofline(ctx, K6, n * flops, n * nbytes)
