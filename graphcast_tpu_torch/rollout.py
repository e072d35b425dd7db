"""Rollout helpers (port of graphcast_tpu/rollout.py, ``extend_targets_template``
only; the multi-step rollout itself is wrappers.Autoregressive)."""

from __future__ import annotations

import numpy as np
import torch

from graphcast_tpu_torch.fields import Field, FieldSet


def extend_targets_template(targets_template: FieldSet,
                            required_num_steps: int) -> FieldSet:
  """Extends a template along time to `required_num_steps`, zero-filled
  (reference: rollout.py:404-461)."""
  current = targets_template.sizes["time"]
  if current >= required_num_steps:
    return targets_template.isel(time=slice(0, required_num_steps))
  fields = {}
  for name in targets_template.var_names:
    f = targets_template[name]
    shape = list(f.shape)
    shape[f.dims.index("time")] = required_num_steps
    fields[name] = Field(
        torch.zeros(shape, dtype=f.dtype, device=f.data.device), f.dims)
  coords = targets_template.coords
  if "time" in coords and current >= 2:
    t = coords["time"]
    coords["time"] = t[0] + (t[1] - t[0]) * np.arange(required_num_steps)
  elif "time" in coords and current == 1:
    coords["time"] = coords["time"][0] * np.arange(1, required_num_steps + 1)
  return FieldSet(fields, coords=coords)
