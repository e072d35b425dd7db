"""What the entries share: step marks on the device's clock, the sample of
answers a run keeps for its comparison, and the comparison arithmetic."""

from __future__ import annotations

import gc
import random
import sys
import time

import numpy as np
import torch

from portbench import data


class Marks:
  """Marks recorded on the device's stream between steps, read after the
  window: CUDA events on a card (no synchronisation inside the loop), the
  host clock on the CPU."""

  def __init__(self, device):
    self.cuda = device.type == "cuda"
    self.marks = []

  def mark(self):
    if self.cuda:
      e = torch.cuda.Event(enable_timing=True)
      e.record()
      self.marks.append(e)
    else:
      self.marks.append(time.perf_counter())

  def intervals(self) -> list[float]:
    """Seconds between consecutive marks (after a synchronise)."""
    if self.cuda:
      return [a.elapsed_time(b) / 1e3
              for a, b in zip(self.marks[:-1], self.marks[1:])]
    return [b - a for a, b in zip(self.marks[:-1], self.marks[1:])]


class Collections:
  """The host clock's seconds spent in Python's garbage collector, by
  generation, while open."""

  def __init__(self):
    self.seconds = [0.0, 0.0, 0.0]
    self.count = [0, 0, 0]
    self.longest = 0.0
    self._start = None
    gc.callbacks.append(self._callback)

  def _callback(self, phase, info):
    if phase == "start":
      self._start = time.perf_counter()
    elif self._start is not None:
      s = time.perf_counter() - self._start
      self.seconds[info["generation"]] += s
      self.count[info["generation"]] += 1
      self.longest = max(self.longest, s)
      self._start = None

  def close(self):
    gc.callbacks.remove(self._callback)

  def __str__(self):
    return (f"{self.count} collections by generation, "
            f"{[round(s, 6) for s in self.seconds]} s, the longest "
            f"{self.longest:.6f} s")


def log_slowest(steps, where, yielded, elapsed, n=5):
  """Logs the window's slowest steps (device clock), where they fell, and
  how far ahead of the device the host was when each was yielded."""
  total = sum(steps)
  order = sorted(range(len(steps)), key=lambda i: -steps[i])[:n]
  done = [sum(steps[:i + 1]) for i in range(len(steps))]
  print(f"[portbench] steps: device sum {total:.6f} s of {elapsed:.6f} s; "
        f"median {float(np.median(steps)):.6f} s; slowest "
        + ", ".join(f"#{i} {where[i]} {steps[i]:.6f} s (host yielded at "
                    f"{yielded[i]:.3f}, device done at {done[i]:.3f})"
                    for i in order), file=sys.stderr)


def synchronize(device):
  if device.type == "cuda":
    torch.cuda.synchronize(device)


class Sample:
  """A sample, drawn from the seed, of the window's answers: the first
  always, and ``size`` of the others, uniform over however many the window
  gives (reservoir sampling)."""

  def __init__(self, seed: int, size: int):
    self.rng = random.Random(data.sub_seed(seed, "sample"))
    self.size = size
    self.first = None
    self.rest = []
    self.seen = 0

  def offer(self, make):
    """Offers the next answer; ``make()`` builds what is kept of it."""
    if self.first is None:
      self.first = make()
      return
    self.seen += 1
    if len(self.rest) < self.size:
      self.rest.append(make())
    else:
      j = self.rng.randrange(self.seen)
      if j < self.size:
        self.rest[j] = make()

  def items(self):
    return ([self.first] if self.first is not None else []) + self.rest


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
  """rms(a - b) / rms(b), in float64."""
  a, b = a.double(), b.double()
  return float((a - b).square().mean().sqrt()
               / b.square().mean().sqrt().clamp_min(1e-300))


def dot(a: torch.Tensor, b: torch.Tensor) -> float:
  """The inner product of ``a`` and ``b``, in float64."""
  return float((a.double() * b.double()).sum())


def worst_leaf_gap(program: dict, reference: dict, keep=None) -> float:
  """max over leaves of |‖program‖ - ‖reference‖| over the larger of the
  reference leaf's norm and the median leaf's; ``keep``: the leaves
  counted (all by default)."""
  names = [n for n in reference if keep is None or n in keep]
  ref_norms = {n: float(reference[n].double().norm()) for n in names}
  median = float(np.median(list(ref_norms.values())))
  worst = 0.0
  for n in names:
    gap = abs(float(program[n].double().norm()) - ref_norms[n])
    worst = max(worst, gap / max(ref_norms[n], median, 1e-300))
  return worst
