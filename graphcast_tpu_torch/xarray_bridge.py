"""xarray ⇄ FieldSet boundary conversion (port of
graphcast_tpu/xarray_bridge.py).

The port keeps its data in FieldSets of torch tensors (fields.py) and meets
xarray only at the program boundary, here. The module is import-gated:
xarray is imported at the first conversion (``_require_xarray``), so the
port imports and runs without it.

Usage:
  from graphcast_tpu_torch import xarray_bridge as xb
  inputs = xb.from_xarray(ds_inputs)       # xarray.Dataset → FieldSet
  preds_ds = xb.to_xarray(predictions)     # FieldSet → xarray.Dataset
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from graphcast_tpu_torch import devices
from graphcast_tpu_torch.fields import Field, FieldSet


def _require_xarray():
  """The xarray module; raises ImportError where it is not installed."""
  try:
    import xarray  # type: ignore
  except ImportError as e:
    raise ImportError(
        "xarray is not installed. graphcast_tpu_torch works on FieldSets "
        "without it; install xarray to use the conversion boundary.") from e
  return xarray


# Dims the FieldSet layer understands; other coords are carried through.
_KNOWN_DIM_COORDS = ("batch", "time", "level", "lat", "lon")


def _tensor(data, device: torch.device) -> torch.Tensor:
  return torch.as_tensor(np.array(data), device=device)  # a C-order copy


def from_xarray(dataset: "xarray.Dataset",
                device: torch.device | str = devices.DEFAULT_DEVICE
                ) -> FieldSet:
  """Converts an xarray.Dataset (e.g. an ERA5 slice) to a FieldSet of
  tensors on ``device`` (the card unless the caller asks for "cpu").

  - dim coords for (batch, time, level, lat, lon) become FieldSet coords;
  - a non-dim "datetime" coord (batch, time) is preserved for the derived-
    forcings pipeline.
  """
  _require_xarray()
  device = devices.resolve(device)
  fields = {}
  for name, var in dataset.data_vars.items():
    fields[str(name)] = Field(_tensor(var.data, device),
                              tuple(str(d) for d in var.dims))
  coords: dict[str, np.ndarray] = {}
  for cname, cval in dataset.coords.items():
    cname = str(cname)
    if cname == "datetime":
      data = np.asarray(cval.data)
      if data.ndim == 1:  # promote to [batch, time]
        data = data[None]
      coords["datetime"] = data
    elif cname in _KNOWN_DIM_COORDS:
      coords[cname] = np.asarray(cval.data)
  return FieldSet(fields, coords=coords)


def _numpy(data: torch.Tensor) -> np.ndarray:
  data = data.detach().cpu()
  if data.dtype == torch.bfloat16:  # numpy has no bfloat16
    data = data.float()
  return data.numpy()


def to_xarray(fs: FieldSet,
              extra_coords: Optional[dict[str, Any]] = None
              ) -> "xarray.Dataset":
  """Converts a FieldSet to an xarray.Dataset (tensors → host numpy;
  bfloat16 as float32)."""
  xarray = _require_xarray()
  data_vars = {}
  for name in fs.var_names:
    f = fs[name]
    data_vars[name] = xarray.DataArray(_numpy(f.data), dims=f.dims)
  coords = dict(fs.coords)
  datetime = coords.pop("datetime", None)
  ds = xarray.Dataset(data_vars, coords=coords)
  if datetime is not None:
    ds = ds.assign_coords(
        datetime=xarray.DataArray(datetime, dims=("batch", "time")))
  if extra_coords:
    ds = ds.assign_coords(**extra_coords)
  return ds


def stats_from_xarray(dataset: "xarray.Dataset",
                      device: torch.device | str = devices.DEFAULT_DEVICE
                      ) -> FieldSet:
  """Converts a normalization-stats Dataset (per-variable scalars or
  per-level vectors, e.g. the published stddev_by_level.nc files)."""
  _require_xarray()
  device = devices.resolve(device)
  fields = {}
  for name, var in dataset.data_vars.items():
    fields[str(name)] = Field(_tensor(var.data, device),
                              tuple(str(d) for d in var.dims))
  coords = {}
  if "level" in dataset.coords:
    coords["level"] = np.asarray(dataset.coords["level"].data)
  return FieldSet(fields, coords=coords)
