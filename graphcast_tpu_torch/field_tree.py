"""map_structure over nests whose leaves are Fields / FieldSets.

Port of graphcast_tpu/field_tree.py (reference: xarray_tree.py:47-70): maps
a function over every variable of every FieldSet in a nest, treating each
FieldSet as an internal node rather than a leaf, and dropping variables for
which the function returns None.
"""

from __future__ import annotations

from typing import Callable, Optional

from graphcast_tpu_torch.fields import Field, FieldSet


def map_structure(fn: Callable[..., Optional[Field]], *structures):
  """Maps ``fn`` over corresponding Fields in nests of FieldSets/Fields."""
  first = structures[0]
  if isinstance(first, Field):
    return fn(*structures)
  if isinstance(first, FieldSet):
    out = {}
    for name in first.var_names:
      args = [s[name] if isinstance(s, FieldSet) else s for s in structures]
      result = fn(*args)
      if result is not None:
        out[name] = result
    return FieldSet(out, coords=first.coords)
  if isinstance(first, dict):
    return {k: map_structure(fn, *(s[k] for s in structures)) for k in first}
  if isinstance(first, (list, tuple)):
    return type(first)(
        map_structure(fn, *parts) for parts in zip(*structures))
  if first is None:
    return None
  return fn(*structures)


def map_data(fn, *structures):
  """Maps ``fn`` over raw leaf tensors of nests of FieldSets (keeps dims)."""
  def wrap(*fields):
    return Field(fn(*(f.data for f in fields)), fields[0].dims)
  return map_structure(wrap, *structures)
