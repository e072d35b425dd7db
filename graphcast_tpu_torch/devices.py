"""Where the port's entry points put their tensors.

Model constructors and the synthetic-data helpers take ``device``, "cuda"
by default: a caller who names no device runs on the card, and on a machine
without one gets an error instead of a quiet CPU run. The CPU runs the
plain-PyTorch versions of the kernels and is asked for explicitly
(``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: torch.device | str = DEFAULT_DEVICE) -> torch.device:
  """``device`` as a torch.device; raises for "cuda" where torch sees no
  CUDA device."""
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "no CUDA device: pass device='cpu' to run the port on the CPU")
  return device
