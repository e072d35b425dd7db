"""Schema-typed .npz checkpointing (reference: graphcast/checkpoint.py).

Pinned copy of graphcast_tpu/checkpoint.py, which is numpy only but sits
in a package whose root imports jax; tests/test_torch_checkpoint.py holds
every function here equal to its original, and the two packages' bundles
loading into each other bit-equal.

Serializes nested dataclasses / dicts / lists / tuples of numpy arrays and
scalars into a single ``.npz`` with ``:``-joined flat keys, and reconstructs
them using the *target dataclass's type annotations* — the same on-disk
format as the reference (checkpoint.py:26-170), so published GraphCast /
GenCast checkpoint bundles can be read directly.
"""

from __future__ import annotations

import dataclasses
import io
import types
import typing
from typing import Any, BinaryIO, Optional, TypeVar, Union

import numpy as np

_T = TypeVar("_T")

_SEP = ":"


def _flatten(tree: Any, prefix: str = "", out: Optional[dict] = None) -> dict:
  if out is None:
    out = {}
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
  if isinstance(tree, dict):
    for k, v in tree.items():
      if _SEP in str(k):
        raise ValueError(f"key {k!r} must not contain {_SEP!r}")
      _flatten(v, f"{prefix}{k}{_SEP}", out)
    return out
  if isinstance(tree, (list, tuple)):
    for i, v in enumerate(tree):
      _flatten(v, f"{prefix}{i}{_SEP}", out)
    return out
  key = prefix[:-1] if prefix.endswith(_SEP) else prefix
  if tree is None:
    out[key] = np.array("__None__")
  elif isinstance(tree, str):
    out[key] = np.array(tree)
  elif isinstance(tree, bool):
    out[key] = np.array(tree)
  else:
    out[key] = np.asarray(tree)
  return out


def dump(dest: Union[str, BinaryIO], value: Any) -> None:
  """Serializes `value` (dataclass/dict tree of arrays) to an .npz."""
  flat = _flatten(value)
  buf = io.BytesIO()
  np.savez(buf, **flat)
  buf.seek(0)
  if isinstance(dest, str):
    with open(dest, "wb") as f:
      f.write(buf.read())
  else:
    dest.write(buf.read())


def _unflatten(flat: dict) -> dict:
  tree: dict = {}
  for key, value in flat.items():
    parts = key.split(_SEP)
    node = tree
    for p in parts[:-1]:
      node = node.setdefault(p, {})
    node[parts[-1]] = value
  return tree


def _strip_optional(annotation):
  origin = typing.get_origin(annotation)
  if origin in (Union, types.UnionType):
    args = [a for a in typing.get_args(annotation) if a is not type(None)]
    if len(args) == 1:
      return args[0], True
    raise TypeError(f"only Optional unions supported, got {annotation}")
  return annotation, False


def _convert(value: Any, annotation) -> Any:
  """Converts a raw unflattened node to the annotated type
  (reference: checkpoint.py:98-170)."""
  annotation, optional = _strip_optional(annotation)

  if isinstance(value, np.ndarray) and value.dtype.kind in ("U", "S"):
    s = str(value)
    if optional and s == "__None__":
      return None
    if annotation is str or annotation is Any:
      return s

  if optional and isinstance(value, np.ndarray) and value.shape == () and (
      value.dtype.kind in ("U", "S")) and str(value) == "__None__":
    return None

  origin = typing.get_origin(annotation)
  if dataclasses.is_dataclass(annotation):
    kwargs = {}
    hints = typing.get_type_hints(annotation)
    for f in dataclasses.fields(annotation):
      if f.name in value:
        kwargs[f.name] = _convert(value[f.name], hints[f.name])
      elif f.default is not dataclasses.MISSING:
        kwargs[f.name] = f.default
      elif f.default_factory is not dataclasses.MISSING:  # type: ignore
        kwargs[f.name] = f.default_factory()  # type: ignore
      else:
        raise ValueError(f"missing field {f.name} for {annotation}")
    return annotation(**kwargs)
  if origin in (dict, typing.Dict):
    args = typing.get_args(annotation)
    val_t = args[1] if args else Any
    return {k: _convert(v, val_t) for k, v in value.items()}
  if origin in (tuple, typing.Tuple):
    args = typing.get_args(annotation)
    items = [value[str(i)] for i in range(len(value))]
    if len(args) == 2 and args[1] is Ellipsis:
      return tuple(_convert(v, args[0]) for v in items)
    return tuple(_convert(v, t) for v, t in zip(items, args))
  if origin in (list, typing.List):
    args = typing.get_args(annotation)
    item_t = args[0] if args else Any
    return [_convert(value[str(i)], item_t)
            for i in range(len(value))]
  if annotation in (int, float, bool, str):
    return annotation(np.asarray(value).item())
  if isinstance(value, dict):
    # Untyped dict node (e.g. params: dict[str, Any]).
    return {k: _convert(v, Any) for k, v in value.items()}
  return value  # raw array


def load(source: Union[str, BinaryIO], schema: type[_T]) -> _T:
  """Loads an .npz written by `dump` (or the reference) as `schema`."""
  if isinstance(source, str):
    with open(source, "rb") as f:
      data = dict(np.load(io.BytesIO(f.read())))
  else:
    data = dict(np.load(io.BytesIO(source.read())))
  tree = _unflatten(data)
  return _convert(tree, schema)
