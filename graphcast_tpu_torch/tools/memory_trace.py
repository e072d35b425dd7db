"""Per-block memory breakdown at the peak of a run on the card: what the
memdump drivers print in place of the JAX package's compile-time memory
analysis, which PyTorch has no counterpart of.

``record(fn, device)`` runs ``fn`` with the caching allocator's history on
(``torch.cuda.memory._record_memory_history``, Python stacks of each
allocation), from before ``fn`` allocates anything, and returns the
allocator's snapshot and the peak that ``torch.cuda.max_memory_allocated``
saw above what was allocated before ``fn``. ``peak_breakdown(snapshot)``
replays the device's trace from an empty allocator: each ``alloc`` adds
its block, each
``free_completed`` removes it. At the event where the live total is
largest it lists the live blocks, grouped by the allocating frame of the
port (the innermost stack frame inside ``graphcast_tpu_torch/``, as
file:line; ``NO_FRAME`` for blocks the autograd engine allocated), largest
group first, with their total.
"""

from __future__ import annotations

import os

import torch

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_ENTRIES = 4_000_000  # trace events kept (the oldest are dropped)
# An allocation with no Python frame: made by the autograd engine's own
# thread, in a backward formula of PyTorch's (a custom Function's backward
# is Python and has frames).
NO_FRAME = "<no Python frame: autograd backward>"


def record(fn, device: torch.device):
  """(fn's result, the allocator's snapshot with its trace, the peak
  bytes allocated during ``fn()`` above what was allocated before it) of
  ``fn()`` run with the allocation history on."""
  torch.cuda.synchronize(device)
  base = torch.cuda.memory_allocated(device)
  torch.cuda.reset_peak_memory_stats(device)
  torch.cuda.memory._record_memory_history(
      enabled="all", context="alloc", stacks="python",
      max_entries=MAX_ENTRIES)
  try:
    out = fn()
    torch.cuda.synchronize(device)
    snapshot = torch.cuda.memory._snapshot()
  finally:
    torch.cuda.memory._record_memory_history(enabled=None)
  return out, snapshot, torch.cuda.max_memory_allocated(device) - base


def site(frames, package: str = PACKAGE) -> str:
  """The allocating frame of the port (module doc) as
  "relative/path.py:line function", else the innermost frame's."""
  for f in frames:
    name = f.get("filename", "")
    if name.startswith(package + os.sep):
      rel = os.path.relpath(name, os.path.dirname(package))
      return f"{rel}:{f.get('line')} {f.get('name')}"
  if frames:
    f = frames[0]
    return f"{f.get('filename')}:{f.get('line')} {f.get('name')}"
  return NO_FRAME


def peak_breakdown(snapshot: dict, device_index: int = 0,
                   package: str = PACKAGE) -> dict:
  """{"peak_bytes", "peak_event", "events", "sites": [{"site", "bytes",
  "blocks"}, ...] largest first, "listed_bytes"} at the trace's peak."""
  trace = snapshot["device_traces"][device_index]

  def replay(stop):
    """(live blocks after event ``stop``, peak total, its event)."""
    live, current, peak, peak_at = {}, 0, 0, -1
    for i, event in enumerate(trace[:stop + 1]):
      action = event["action"]
      if action == "alloc":
        live[event["addr"]] = (event["size"], event.get("frames", []))
        current += event["size"]
        if current > peak:
          peak, peak_at = current, i
      elif action == "free_completed" and event["addr"] in live:
        current -= live.pop(event["addr"])[0]
    return live, peak, peak_at

  _, peak, peak_at = replay(len(trace) - 1)
  at_peak, _, _ = replay(peak_at)
  groups = {}
  for size, frames in at_peak.values():
    key = site(frames, package)
    total, count = groups.get(key, (0, 0))
    groups[key] = (total + size, count + 1)
  sites = [{"site": k, "bytes": b, "blocks": n}
           for k, (b, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])]
  return {"peak_bytes": peak, "peak_event": peak_at, "events": len(trace),
          "sites": sites, "listed_bytes": sum(s["bytes"] for s in sites)}


def summary(breakdown: dict, measured_peak_bytes: int | None,
            top: int = 25) -> dict:
  """The record's memory fields: the replayed peak, the allocator's own
  peak above the start (``record``'s third result), the listed blocks'
  share of it, and the ``top`` largest sites in GB."""
  gb = 1e9
  out = {
      "peak_gb": breakdown["peak_bytes"] / gb,
      "listed_gb": breakdown["listed_bytes"] / gb,
      "trace_events": breakdown["events"],
      "sites": [{"site": s["site"], "gb": s["bytes"] / gb,
                 "blocks": s["blocks"]} for s in breakdown["sites"][:top]],
      "other_sites_gb": sum(s["bytes"] for s in breakdown["sites"][top:]) / gb,
  }
  if measured_peak_bytes:
    out["measured_peak_gb"] = measured_peak_bytes / gb
    out["listed_over_measured"] = (breakdown["listed_bytes"]
                                   / measured_peak_bytes)
  return out
