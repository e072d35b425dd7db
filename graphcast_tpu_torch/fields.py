"""Named-dimension containers over torch tensors.

Port of graphcast_tpu/fields.py, holding only what the inference rollout
uses:

- a ``Field`` is a tensor plus a tuple of dimension names;
- a ``FieldSet`` is a mapping of variable name → ``Field``, kept sorted by
  name, plus per-dimension coordinate arrays (numpy, host-side).

Variables stay sorted by name so that channel stacking (``to_stacked``)
follows the reference's ``sorted(dataset.data_vars.keys())`` convention
(model_utils.py:650-652): the channel order is part of checkpoint
compatibility.
"""

from __future__ import annotations

import collections.abc
from typing import Any, Callable, Iterable, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch


class Field(NamedTuple):
  """A tensor with named dimensions."""
  data: torch.Tensor
  dims: tuple[str, ...]

  @property
  def shape(self):
    return tuple(self.data.shape)

  @property
  def dtype(self):
    return self.data.dtype

  @property
  def sizes(self) -> dict[str, int]:
    return dict(zip(self.dims, self.data.shape))

  def transpose(self, *dims: str) -> "Field":
    """Reorders axes by name. All of the field's dims must be given."""
    if set(dims) != set(self.dims):
      raise ValueError(f"transpose dims {dims} != field dims {self.dims}")
    perm = tuple(self.dims.index(d) for d in dims)
    return Field(self.data.permute(perm), tuple(dims))

  def isel(self, dim: str, index) -> "Field":
    """Integer/slice selection along a named dim."""
    if dim not in self.dims:
      raise KeyError(f"dim {dim!r} not in {self.dims}")
    axis = self.dims.index(dim)
    idx = [slice(None)] * len(self.dims)
    idx[axis] = index
    data = self.data[tuple(idx)]
    if isinstance(index, int):
      dims = self.dims[:axis] + self.dims[axis + 1:]
    else:
      dims = self.dims
    return Field(data, dims)

  def broadcast_like(self, dims: tuple[str, ...],
                     sizes: Mapping[str, int]) -> "Field":
    """Broadcasts this field to ``dims`` (a superset of its own dims, in a
    compatible order)."""
    missing = [d for d in self.dims if d not in dims]
    if missing:
      raise ValueError(f"cannot broadcast {self.dims} to {dims}: {missing}")
    our_order = [d for d in dims if d in self.dims]
    field = self if tuple(our_order) == self.dims else self.transpose(*our_order)
    shape = [field.sizes.get(d, 1) for d in dims]
    full_shape = tuple(field.sizes.get(d, sizes.get(d, 1)) for d in dims)
    return Field(field.data.reshape(shape).expand(full_shape), tuple(dims))

  def astype(self, dtype) -> "Field":
    return Field(self.data.to(dtype), self.dims)


def _coords_dict(coords: Optional[Mapping[str, Any]]) -> dict:
  if not coords:
    return {}
  return {k: np.asarray(v) for k, v in sorted(coords.items())
          if v is not None}


class FieldSet(collections.abc.Mapping):
  """A sorted mapping of variable name → Field, with host-side coords."""

  __slots__ = ("_fields", "_coords")

  def __init__(self,
               fields: Mapping[str, Field] | Iterable[tuple[str, Field]] = (),
               coords: Optional[Mapping[str, Any]] = None):
    items = dict(fields)
    for name, f in items.items():
      if not isinstance(f, Field):
        raise TypeError(f"value for {name!r} must be a Field, got {type(f)}")
      if f.data.ndim != len(f.dims):
        raise ValueError(
            f"{name!r}: data ndim {f.data.ndim} != len(dims) {f.dims}")
    self._fields = {k: items[k] for k in sorted(items)}
    self._coords = _coords_dict(coords)

  # --- Mapping protocol ---

  def __getitem__(self, name: str) -> Field:
    return self._fields[name]

  def __iter__(self):
    return iter(self._fields)

  def __len__(self):
    return len(self._fields)

  def __repr__(self):
    lines = ["FieldSet("]
    for k, f in self._fields.items():
      lines.append(f"  {k}: dims={f.dims} shape={tuple(f.data.shape)} "
                   f"dtype={f.data.dtype}")
    lines.append(f"  coords: {list(self._coords)}")
    lines.append(")")
    return "\n".join(lines)

  # --- accessors ---

  @property
  def var_names(self) -> tuple[str, ...]:
    return tuple(self._fields)

  def data(self, name: str) -> torch.Tensor:
    return self._fields[name].data

  @property
  def coords(self) -> dict[str, np.ndarray]:
    return dict(self._coords)

  @property
  def sizes(self) -> dict[str, int]:
    out: dict[str, int] = {}
    for f in self._fields.values():
      for d, s in zip(f.dims, f.data.shape):
        if d in out and out[d] != s:
          raise ValueError(f"inconsistent size for dim {d!r}: {out[d]} vs {s}")
        out[d] = s
    return out

  # --- construction helpers ---

  def select(self, names: Sequence[str]) -> "FieldSet":
    missing = [n for n in names if n not in self._fields]
    if missing:
      raise KeyError(f"variables not present: {missing}")
    return FieldSet({n: self._fields[n] for n in names}, coords=self._coords)

  def replace(self, **fields: Field) -> "FieldSet":
    """A copy with the given variables replaced or added."""
    return FieldSet({**self._fields, **fields}, coords=self._coords)

  def drop(self, names: Sequence[str]) -> "FieldSet":
    names = set(names)
    return FieldSet({n: f for n, f in self._fields.items() if n not in names},
                    coords=self._coords)

  def assign_coords(self, **coords) -> "FieldSet":
    merged = self.coords
    for k, v in coords.items():
      if v is None:
        merged.pop(k, None)
      else:
        merged[k] = np.asarray(v)
    return FieldSet(self._fields, coords=merged)

  def isel(self, **indexers) -> "FieldSet":
    """Index/slice along named dims; coords for those dims are sliced too."""
    fields = {}
    for name, f in self._fields.items():
      for dim, idx in indexers.items():
        if dim in f.dims:
          f = f.isel(dim, idx)
      fields[name] = f
    coords = self.coords
    for dim, idx in indexers.items():
      if dim in coords:
        c = coords[dim][idx]
        if np.ndim(c) == 0:
          del coords[dim]
        else:
          coords[dim] = c
    return FieldSet(fields, coords=coords)

  @staticmethod
  def concat(sets: Sequence["FieldSet"], dim: str) -> "FieldSet":
    """Concatenates FieldSets along a named dim (all must share variables)."""
    if not sets:
      raise ValueError("need at least one FieldSet")
    names = sets[0].var_names
    for fs in sets[1:]:
      if fs.var_names != names:
        raise ValueError(f"variable mismatch: {names} vs {fs.var_names}")
    fields = {}
    for n in names:
      dims = sets[0][n].dims
      axis = dims.index(dim)
      fields[n] = Field(torch.cat([fs[n].data for fs in sets], dim=axis), dims)
    coords = sets[0].coords
    if all(dim in fs.coords for fs in sets):
      coords[dim] = np.concatenate([fs.coords[dim] for fs in sets])
    else:
      coords.pop(dim, None)
    return FieldSet(fields, coords=coords)

  @staticmethod
  def merge(sets: Sequence["FieldSet"]) -> "FieldSet":
    """Merges variable sets (later sets override earlier on name clash)."""
    fields: dict[str, Field] = {}
    coords: dict[str, np.ndarray] = {}
    for fs in sets:
      fields.update(fs._fields)  # pylint: disable=protected-access
      coords.update(fs.coords)
    return FieldSet(fields, coords=coords)

  # --- elementwise ---

  def map(self, fn: Callable[[str, Field], Field]) -> "FieldSet":
    return FieldSet({n: fn(n, f) for n, f in self._fields.items()},
                    coords=self._coords)

  def map_data(self, fn: Callable[[Any], Any]) -> "FieldSet":
    return self.map(lambda n, f: Field(fn(f.data), f.dims))

  def astype(self, dtype) -> "FieldSet":
    """Casts the floating variables to ``dtype``."""
    return self.map_data(
        lambda x: x.to(dtype) if x.is_floating_point() else x)

  def to(self, device) -> "FieldSet":
    return self.map_data(lambda x: x.to(device))


def from_numpy(fields: Mapping[str, tuple[np.ndarray, tuple[str, ...]]],
               coords: Optional[Mapping[str, Any]] = None) -> FieldSet:
  """FieldSet of CPU tensors sharing memory with the given numpy arrays."""
  return FieldSet({n: Field(torch.from_numpy(np.asarray(a)), dims)
                   for n, (a, dims) in fields.items()}, coords=coords)


def align_for_broadcast(src: Field, dst: Field) -> torch.Tensor:
  """Reshapes ``src.data`` so it broadcasts against ``dst`` by dim name.

  ``src``'s dims must be a subset of ``dst``'s, in the same relative order.
  """
  extra = [d for d in src.dims if d not in dst.dims]
  if extra:
    raise ValueError(f"cannot broadcast {src.dims} onto {dst.dims}: "
                     f"extra dims {extra}")
  order = [d for d in dst.dims if d in src.dims]
  f = src if tuple(order) == src.dims else src.transpose(*order)
  shape = tuple(f.sizes.get(d, 1) for d in dst.dims)
  return f.data.reshape(shape)


# ---------------------------------------------------------------------------
# Stacking: FieldSet ⇄ single channel-last tensor (reference
# model_utils.py:594-720): variables sorted by name, non-preserved dims
# folded (in their original order) into a trailing "channels" axis.
# ---------------------------------------------------------------------------

DEFAULT_PRESERVED_DIMS = ("batch", "lat", "lon")


def field_to_stacked(field: Field,
                     sizes: Mapping[str, int],
                     preserved_dims: tuple[str, ...] = DEFAULT_PRESERVED_DIMS):
  """Returns a tensor of shape preserved_dims + (channels,)."""
  stack_dims = [d for d in field.dims if d not in preserved_dims]
  order = [d for d in preserved_dims if d in field.dims] + stack_dims
  f = field if tuple(order) == field.dims else field.transpose(*order)
  n_preserved_present = len(order) - len(stack_dims)
  channels = 1
  for d in stack_dims:
    channels *= f.sizes[d]
  data = f.data.reshape(tuple(f.data.shape[:n_preserved_present])
                        + (channels,))
  full_dims = tuple(preserved_dims) + ("channels",)
  present = tuple(d for d in preserved_dims if d in field.dims) + ("channels",)
  out_field = Field(data, present).broadcast_like(
      full_dims, {**dict(sizes), "channels": channels})
  return out_field.data


def to_stacked(fs: FieldSet,
               preserved_dims: tuple[str, ...] = DEFAULT_PRESERVED_DIMS):
  """FieldSet → tensor [*preserved_dims, total_channels], sorted var order."""
  if not len(fs):
    raise ValueError("cannot stack an empty FieldSet")
  sizes = fs.sizes
  parts = [field_to_stacked(fs[n], sizes, preserved_dims)
           for n in fs.var_names]
  return torch.cat(parts, dim=-1)


def stacked_channels(fs: FieldSet,
                     preserved_dims: tuple[str, ...] = DEFAULT_PRESERVED_DIMS
                     ) -> int:
  """Number of channels ``to_stacked`` would produce (from dims alone)."""
  total = 0
  for n in fs.var_names:
    c = 1
    for d, s in fs[n].sizes.items():
      if d not in preserved_dims:
        c *= s
    total += c
  return total


def from_stacked(stacked: torch.Tensor,
                 template: FieldSet,
                 preserved_dims: tuple[str, ...] = DEFAULT_PRESERVED_DIMS
                 ) -> FieldSet:
  """Inverse of ``to_stacked`` given a template FieldSet for shapes/dims."""
  expected = stacked_channels(template, preserved_dims)
  if expected != stacked.shape[-1]:
    raise ValueError(
        f"template expects {expected} channels, stacked has "
        f"{stacked.shape[-1]}")
  fields = {}
  index = 0
  for name in template.var_names:
    tf = template[name]
    stack_dims = [d for d in tf.dims if d not in preserved_dims]
    channels = 1
    for d in stack_dims:
      channels *= tf.sizes[d]
    chunk = stacked[..., index:index + channels]
    index += channels
    present_preserved = tuple(d for d in preserved_dims if d in tf.dims)
    # Drop preserved axes the template doesn't have (size-1 broadcasts:
    # take index 0).
    for i, d in reversed(list(enumerate(preserved_dims))):
      if d not in tf.dims:
        chunk = chunk.select(i, 0)
    shape = tuple(tf.sizes[d] for d in present_preserved) + tuple(
        tf.sizes[d] for d in stack_dims)
    dims = present_preserved + tuple(stack_dims)
    f = Field(chunk.reshape(shape), dims)
    if dims != tf.dims:
      f = f.transpose(*tf.dims)
    fields[name] = f
  return FieldSet(fields, coords=template.coords)
