"""The device's idle share over the ensemble cell's traced steps:
100 × (1 - the union of the device intervals / the traced window), from
the profiler (trace.py)."""

from portbench import readers


def read(ctx):
  return readers.idle_share(ctx)
