"""GraphCast's defined operations a training step, three forwards
(counts/graphcast.py), over the window's ``train_step_s`` and the bf16
peak, in %."""

from portbench import readers
from portbench.counts import graphcast


def read(ctx):
  if not ctx.e2e.get("train_step_s"):
    return None
  flops = graphcast.train_flops(ctx.sizes, readers.graphcast_sizes(ctx),
                                ctx.sizes["batch"])
  return readers.mfu(ctx, flops, "train_step_s")
