"""Durations as numpy ``timedelta64[ns]``, without pandas.

The JAX package takes its durations through ``pandas.Timedelta``: strings
such as "6h", "12h", "24h", "0h", "1h" (task configs, lead times, the TOA
radiation window), ``datetime.timedelta`` (``pandas.Timedelta`` is one) and
``np.timedelta64``. ``to_timedelta64`` reads the same spellings: an
optional sign, then one or more number-unit pairs ("1d12h", "1.5h",
"30min"), units as pandas names them.
"""

from __future__ import annotations

import datetime
import re

import numpy as np

_UNIT_NS = {}
for _names, _ns in (
    (("w", "W"), 7 * 86_400 * 10**9),
    (("d", "D", "day", "days"), 86_400 * 10**9),
    (("h", "H", "hr", "hrs", "hour", "hours"), 3_600 * 10**9),
    (("m", "min", "mins", "minute", "minutes", "T"), 60 * 10**9),
    (("s", "S", "sec", "secs", "second", "seconds"), 10**9),
    (("ms", "milli", "millis", "millisecond", "milliseconds", "L"), 10**6),
    (("us", "micro", "micros", "microsecond", "microseconds", "U"), 10**3),
    (("ns", "nano", "nanos", "nanosecond", "nanoseconds", "N"), 1),
):
  for _name in _names:
    _UNIT_NS[_name] = _ns

_PART = re.compile(r"\s*(\d+(?:\.\d*)?|\.\d+)\s*([A-Za-z]+)")


def to_timedelta64(value) -> np.timedelta64:
  """``value`` (a duration string, ``datetime.timedelta`` or
  ``np.timedelta64``) as ``np.timedelta64`` in nanoseconds."""
  if isinstance(value, np.timedelta64):
    return value.astype("timedelta64[ns]")
  if isinstance(value, datetime.timedelta):
    return np.timedelta64(value // datetime.timedelta(microseconds=1),
                          "us").astype("timedelta64[ns]")
  if not isinstance(value, str):
    raise TypeError(f"not a duration: {value!r}")
  text = value.strip()
  sign = -1 if text.startswith("-") else 1
  rest = text.lstrip("+-")
  total, pos = 0, 0
  while pos < len(rest):
    m = _PART.match(rest, pos)
    if m is None or m.group(2) not in _UNIT_NS:
      raise ValueError(f"cannot parse duration {value!r}")
    number, unit = m.group(1), _UNIT_NS[m.group(2)]
    total += (int(number) * unit if "." not in number
              else round(float(number) * unit))
    pos = m.end()
    while pos < len(rest) and rest[pos].isspace():
      pos += 1
  if pos == 0:
    raise ValueError(f"cannot parse duration {value!r}")
  return np.timedelta64(sign * total, "ns")
