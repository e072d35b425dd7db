"""What the per-layer metrics' readers (``portbench/metrics/<name>.py``)
read, and the arithmetic they share. A reader is a module with
``read(ctx) -> float | None``; None means it found nothing to read, and the
harness leaves the metric out of the result line."""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional

from portbench import peaks
from portbench.trace import Trace


@dataclasses.dataclass
class Context:
  cell: dict                 # the BENCHMARK.json workload entry
  cfg: dict                  # the configuration's file
  traffic: dict              # the traffic mix's file
  e2e: dict                  # end-to-end values of this run's window
  trace: Optional[Trace]     # the traced sub-window
  sizes: dict                # graph sizes, from the reference's graph


def kernels(pattern: str) -> Callable[[str], bool]:
  """A predicate on device operation names: ``pattern`` searched as a
  regular expression."""
  rx = re.compile(pattern)
  return lambda name: rx.search(name) is not None


def launches(ctx: Context, predicate) -> float:
  return ctx.trace.launches(predicate) if ctx.trace else 0.0


def roofline(ctx: Context, predicate, flops: float, nbytes: float
             ) -> Optional[float]:
  """100 × the least time of (flops, nbytes) a step over the device time a
  step of the kernels that match; None where none ran."""
  if ctx.trace is None:
    return None
  seconds = ctx.trace.matching(predicate)
  if seconds <= 0.0:
    return None
  return 100.0 * peaks.bound_s(flops, nbytes) / seconds


def share(ctx: Context, predicate) -> Optional[float]:
  """100 × the device time of the matching operations over all device
  time; None where none ran."""
  if ctx.trace is None:
    return None
  part = ctx.trace.matching(predicate)
  whole = ctx.trace.matching(lambda _: True)
  return 100.0 * part / whole if part > 0.0 and whole > 0.0 else None


def idle_share(ctx: Context) -> Optional[float]:
  if ctx.trace is None or ctx.trace.window_s <= 0.0:
    return None
  return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu(ctx: Context, flops_per_step: float, step_metric: str
        ) -> Optional[float]:
  """100 × the defined operations a step over the window's step time and
  the bf16 peak."""
  step_s = ctx.e2e.get(step_metric)
  if not step_s:
    return None
  return 100.0 * flops_per_step / step_s / peaks.BF16_FLOPS


def graphcast_sizes(ctx: Context) -> dict:
  """GraphCast's count arguments (counts/graphcast.py) from the
  configuration's file."""
  from portbench.reference import graphcast as ref
  return {"latent_size": ctx.cfg["latent_size"],
          "gnn_msg_steps": ctx.cfg["gnn_msg_steps"],
          "node_in": ref.grid_input_channels(ctx.cfg) + 3,
          "outputs": ref.output_channels(ctx.cfg)}


def gencast_sizes(ctx: Context) -> dict:
  """GenCast's count arguments (counts/gencast.py) from the
  configuration's file."""
  from portbench.reference import gencast as ref
  t = ctx.cfg["transformer"]
  return {"latent_size": ctx.cfg["latent_size"],
          "node_in": ref.grid_input_channels(ctx.cfg) + 3,
          "outputs": ref.output_channels(ctx.cfg),
          "d_model": t["d_model"], "num_layers": t["num_layers"],
          "ffw_hidden": t["ffw_hidden"]}
