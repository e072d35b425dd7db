"""Recompute and host offload of the tensors a backward needs.

The JAX package bounds training memory with ``jax.checkpoint`` and, for
named residuals, the policy ``save_and_offload_only_these_names`` that
keeps them in the host's pinned memory (wrappers/autoregressive.py,
nn/deep_gnn.py there). The port's counterparts:

- ``checkpoint(fn, *args)``: ``torch.utils.checkpoint`` without reentry.
  Under grad, the region keeps only its tensor arguments and recomputes
  the rest in the backward; without grad it is a plain call. A region
  nested in another hands its arguments to the outer one, which keeps
  nothing of them on its first pass, so only the outermost region's
  arguments stay resident: the JAX package's two-level checkpointing.
  Tensors that a region must not keep are passed as arguments, never
  read from a closure (a closure holds them until the backward).
- ``on_host()``: a ``saved_tensors_hooks`` context under which every
  tensor that autograd saves is copied to the host, pinned where the
  tensor is on the card (a plain copy on the CPU, where pinning needs a
  CUDA runtime), and copied back when the backward unpacks it. Wrapped
  around ``checkpoint(...)``, it moves exactly that region's arguments off
  the card: ``checkpoint`` saves them before its own hooks take over, and
  the recompute inside the backward runs outside the context.
- Names: ``offloading(name)`` marks the carries called ``name`` for the
  host for as long as it is active (the policy's names_which_can_be_
  offloaded), and ``named_checkpoint(name, fn, *args)`` is a ``checkpoint``
  whose arguments are such carries (``checkpoint_name`` there).

Copies to and from the host are exact, so no form changes a number.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.utils import checkpoint as torch_checkpoint

# The carry names that an enclosing ``offloading`` sends to the host.
_OFFLOADED = contextvars.ContextVar("offloaded", default=frozenset())


def checkpoint(fn, *args):
  """fn(*args) as a recompute region (module doc)."""
  return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _pack(t: torch.Tensor):
  with torch.no_grad():
    t = t.detach()
    if t.device.type == "cpu":
      return t.device, t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return t.device, host


def _unpack(packed) -> torch.Tensor:
  device, host = packed
  if device.type == "cpu":
    return host
  return host.to(device, non_blocking=True)


def on_host():
  """Saved tensors go to host memory while the context is active (module
  doc)."""
  return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


@contextlib.contextmanager
def offloading(*names: str):
  """The carries named ``names`` go to the host while this is active."""
  token = _OFFLOADED.set(_OFFLOADED.get() | frozenset(names))
  try:
    yield
  finally:
    _OFFLOADED.reset(token)


def named_checkpoint(name: str, fn, *args):
  """``checkpoint(fn, *args)`` whose arguments are the carries ``name``:
  kept on the host if ``offloading(name)`` is active, else where they
  are."""
  if name in _OFFLOADED.get() and torch.is_grad_enabled():
    with on_host():
      return checkpoint(fn, *args)
  return checkpoint(fn, *args)
