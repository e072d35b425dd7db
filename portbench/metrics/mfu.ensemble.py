"""GenCast's defined operations a member-step, the evaluations of one 12 h
sample (counts/gencast.py), over the window's ``member_step_s`` and the
bf16 peak, in %."""

from portbench import readers
from portbench.counts import gencast


def read(ctx):
  if not ctx.e2e.get("member_step_s"):
    return None
  flops = (gencast.evaluations(ctx.cfg["sampler"])
           * gencast.forward_flops(ctx.sizes, readers.gencast_sizes(ctx)))
  return readers.mfu(ctx, flops, "member_step_s")
