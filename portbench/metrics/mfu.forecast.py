"""GraphCast's defined operations a forecast step (counts/graphcast.py)
over the window's ``forecast_step_s`` and the bf16 peak, in %."""

from portbench import readers
from portbench.counts import graphcast


def read(ctx):
  if not ctx.e2e.get("forecast_step_s"):
    return None
  flops = graphcast.forward_flops(ctx.sizes, readers.graphcast_sizes(ctx),
                                  ctx.sizes["batch"])
  return readers.mfu(ctx, flops, "forecast_step_s")
