"""The port's pinned copy of the boolean environment knobs
(graphcast_tpu_torch/env_flags.py) against the JAX package's
(graphcast_tpu/env_flags.py): the same answer, or the same error, for every
accepted and refused spelling, with either default."""

import pytest

from graphcast_tpu import env_flags as jax_env_flags
from graphcast_tpu_torch import env_flags

_SPELLINGS = [None, "", "0", "1", "true", "TRUE", "True", " yes ", "on",
              "ON", "false", "FALSE", "no", "off", " 0 ", "2", "-1", "maybe",
              "enable", "y", "n", "t", "f", "1.0", "tru"]


def _outcome(env_flag, default):
  try:
    return env_flag("GC_TEST_FLAG", default)
  except ValueError as err:
    return f"ValueError: {err}"


@pytest.mark.parametrize("default", [False, True])
@pytest.mark.parametrize("spelling", _SPELLINGS)
def test_pinned_copy_parses_like_the_jax_package(spelling, default,
                                                 monkeypatch):
  if spelling is None:
    monkeypatch.delenv("GC_TEST_FLAG", raising=False)
  else:
    monkeypatch.setenv("GC_TEST_FLAG", spelling)
  got = _outcome(env_flags.env_flag, default)
  assert got == _outcome(jax_env_flags.env_flag, default)
  refused = spelling is not None and spelling.strip().lower() not in (
      env_flags._TRUE + env_flags._FALSE)
  assert isinstance(got, str) == refused
