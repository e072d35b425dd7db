"""What the port's multi-step drivers share: their argv, the card, timing
and the record.

Each driver takes the positional arguments and environment knobs of its
twin under the repository's ``tools/``, plus ``--device`` (``cuda`` by
default: without a card it raises; ``cpu`` runs the kernels' plain
versions) and ``--out PATH``, the only file it writes. It prints its record
as one JSON line, the last of its standard output, with the card's name and
power limit as ``bench.card_info`` gives them.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from graphcast_tpu_torch import devices
from graphcast_tpu_torch.bench import card_info


def parser(description: str) -> argparse.ArgumentParser:
  """An argument parser with ``--device`` and ``--out``; a driver adds its
  twin's positional arguments."""
  p = argparse.ArgumentParser(description=description)
  p.add_argument("--device", default=devices.DEFAULT_DEVICE,
                 help="cuda (default) or cpu")
  p.add_argument("--out", default=None,
                 help="also write the JSON record to this path")
  return p


def env_int(name: str, default: int) -> int:
  return int(os.environ.get(name, str(default)))


def env_float(name: str, default: float) -> float:
  return float(os.environ.get(name, str(default)))


def env_bool(name: str, default: str = "0") -> bool:
  """A 0/1 knob read as the twins read it, ``bool(int(...))``."""
  return bool(int(os.environ.get(name, default)))


def choice(name: str, values: dict, default: str):
  """``values[os.environ[name]]``; any other value exits, naming the
  choices, as the twins do."""
  raw = os.environ.get(name, default)
  if raw not in values:
    raise SystemExit(f"{name}={raw!r}: expected one of {sorted(values)}")
  return values[raw]


def synchronize(device: torch.device):
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def reset_peak(device: torch.device):
  if device.type == "cuda":
    torch.cuda.reset_peak_memory_stats(device)


def peak_gb(device: torch.device):
  """Peak bytes the allocator handed out since the last ``reset_peak``, in
  GB; None on the CPU."""
  if device.type != "cuda":
    return None
  return torch.cuda.max_memory_allocated(device) / 1e9


def timed(fn, device: torch.device) -> tuple[float, object]:
  """(seconds, result) of ``fn()``, the card synchronized at both ends."""
  synchronize(device)
  t0 = time.perf_counter()
  out = fn()
  synchronize(device)
  return time.perf_counter() - t0, out


def emit(record: dict, device: torch.device, out: str | None) -> dict:
  """Adds the card and its power limit, prints the record as one JSON line
  and writes it to ``out`` if given."""
  name, limit = card_info(device)
  record = {**record, "card": name, "power_limit": limit}
  line = json.dumps(record)
  if out:
    with open(out, "w") as f:
      f.write(line + "\n")
  print(line, flush=True)
  return record
