"""Runs a function in one process per rank of a torch.distributed group.

``spawn(fn, world_size, args)`` starts ``world_size`` processes (the
``spawn`` start method), each of which joins the group at
``init_method`` (default ``tcp://localhost:<a free port>``; tests pass a
``file://`` path of their own), takes one CPU thread for torch, pins its
card where there is one per rank, runs ``fn(rank, *args)`` and leaves the
group. The ranks run on the card unless the caller passes
``device="cpu"``; without a card, the default raises. ``fn`` must be a
module-level function. Backends: ``nccl`` with one card per rank, ``gloo``
otherwise (the CPU, or several ranks on one card: gloo's collectives take
CUDA tensors). An exception in any rank raises here.
"""

from __future__ import annotations

import datetime
import socket
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from graphcast_tpu_torch import devices


def free_port() -> int:
  with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
    s.bind(("localhost", 0))
    return s.getsockname()[1]


def default_backend(world_size: int, device: str) -> str:
  """nccl where every rank has a card of its own, else gloo."""
  if device == "cuda" and torch.cuda.device_count() >= world_size:
    return "nccl"
  return "gloo"


def _run(rank: int, fn: Callable, world_size: int, backend: str,
         init_method: str, device: str, timeout_s: float, args: tuple):
  torch.set_num_threads(1)
  if device == "cuda":
    torch.cuda.set_device(rank % torch.cuda.device_count())
  dist.init_process_group(backend, init_method=init_method,
                          world_size=world_size, rank=rank,
                          timeout=datetime.timedelta(seconds=timeout_s))
  try:
    fn(rank, *args)
  finally:
    dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: tuple = (),
          device: str = devices.DEFAULT_DEVICE,
          init_method: Optional[str] = None, timeout_s: float = 600.0):
  """Runs fn(rank, *args) in ``world_size`` processes (module doc) on
  ``device`` ("cuda", the default, or "cpu") over ``default_backend``;
  ``timeout_s``: how long a collective waits for the other ranks before it
  raises."""
  device = devices.resolve(device).type
  backend = default_backend(world_size, device)
  init_method = init_method or f"tcp://localhost:{free_port()}"
  mp.start_processes(_run, args=(fn, world_size, backend, init_method,
                                 device, timeout_s, tuple(args)),
                     nprocs=world_size, join=True, start_method="spawn")
