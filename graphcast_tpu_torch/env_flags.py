"""Centralized boolean environment knobs (a pinned copy of
graphcast_tpu/env_flags.py: the port imports nothing of the JAX package;
tests/test_torch_env_flags.py holds the two equal in behaviour).

One parser for every GC_* A/B flag. Only "1"/"true"/"yes"/"on" enable a
flag; unset, "", "0", "false", "no", "off" disable it; anything else raises
instead of silently picking a side.
"""

from __future__ import annotations

import os

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("", "0", "false", "no", "off")


def env_flag(name: str, default: bool = False) -> bool:
  val = os.environ.get(name)
  if val is None:
    return default
  val = val.strip().lower()
  if val in _TRUE:
    return True
  if val in _FALSE:
    return False
  raise ValueError(f"unrecognized boolean value {name}={val!r} "
                   f"(use one of {_TRUE + _FALSE})")
