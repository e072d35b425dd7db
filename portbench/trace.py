"""The device trace of a short steady sub-window: ``torch.profiler`` with
CPU and CUDA activities around a few whole steps, reduced to device busy
time (the union of the device intervals), kernel time by name, and the
longest idle gaps with what the host was doing meanwhile. The union
arithmetic is chip_smoke.py's ``_profile_step``."""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

TOP = 10


@dataclasses.dataclass
class Trace:
  window_s: float            # host clock over the traced steps
  busy_s: float              # union of the device intervals
  steps: int                 # whole steps traced
  kernel_s: dict             # device seconds by operation name
  kernel_n: dict             # launches by operation name
  gaps: list                 # [(host activity, seconds)], longest first

  def matching(self, predicate: Callable[[str], bool]) -> float:
    """Device seconds a step of the operations whose names match."""
    return sum(s for n, s in self.kernel_s.items() if predicate(n)) / self.steps

  def launches(self, predicate: Callable[[str], bool]) -> float:
    """Launches a step of the operations whose names match."""
    return sum(c for n, c in self.kernel_n.items() if predicate(n)) / self.steps

  def breakdown(self) -> dict:
    ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in self.gaps[:TOP]]}


def _union(spans):
  busy, end = 0.0, float("-inf")
  for a, b in sorted(spans):
    if b > end:
      busy += b - max(a, end)
      end = b
  return busy


def _gaps(spans, host_ops, t_start, t_end, named_gaps=200):
  """The longest idle intervals between device work, each named by the
  innermost host operation (the latest started) that covers its middle;
  [(name, longest such gap in seconds)], longest first. Only the
  ``named_gaps`` longest gaps are named: a step of many small launches
  has tens of thousands of gaps."""
  out, end = [], t_start
  for a, b in sorted(spans):
    if a > end:
      out.append((end, a))
    end = max(end, b)
  if t_end > end:
    out.append((end, t_end))
  out = sorted(out, key=lambda g: g[0] - g[1])[:named_gaps]
  starts = np.array([s for s, _, _ in host_ops], np.float64)
  ends = np.array([e for _, e, _ in host_ops], np.float64)
  named = collections.defaultdict(float)
  for a, b in out:
    mid = 0.5 * (a + b)
    cover = np.flatnonzero((starts <= mid) & (mid <= ends))
    name = (host_ops[cover[np.argmax(starts[cover])]][2] if cover.size
            else "(no host operation)")
    named[name] = max(named[name], (b - a) / 1e6)
  return sorted(named.items(), key=lambda kv: -kv[1])


def profile(run_steps: Callable[[], int], device) -> Trace:
  """Traces ``run_steps()``, which runs some whole steps, returns how many,
  and leaves the device idle (it synchronises)."""
  from torch.profiler import ProfilerActivity, profile as torch_profile
  torch.cuda.synchronize(device)
  with torch_profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    steps = run_steps()
    torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
  kernel_s = collections.defaultdict(float)
  kernel_n = collections.defaultdict(int)
  spans, host_ops = [], []
  for evt in prof.events():
    tr = evt.time_range
    if evt.device_type == torch.autograd.DeviceType.CUDA:
      kernel_s[evt.name] += tr.elapsed_us() / 1e6
      kernel_n[evt.name] += 1
      spans.append((tr.start, tr.end))
    else:
      host_ops.append((tr.start, tr.end, evt.name))
  if not spans:
    raise RuntimeError("the profiler recorded no device operation")
  t_start = min(min(a for a, _ in spans),
                min((s for s, _, _ in host_ops), default=float("inf")))
  t_end = max(b for _, b in spans)
  return Trace(window_s=window_s, busy_s=_union(spans) / 1e6, steps=steps,
               kernel_s=dict(kernel_s), kernel_n=dict(kernel_n),
               gaps=_gaps(spans, host_ops, t_start, t_end))
