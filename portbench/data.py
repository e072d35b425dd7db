"""Everything a run feeds the program and the reference, made from the
seed on the device: weights, normalisation statistics and ERA5-shaped
fields. Each draw has a generator of its own, seeded from (the run's seed,
a tag), so that a draw does not depend on which others ran before it."""

from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, *tag) -> int:
  """A 63-bit seed from the run's seed and a tag of words and numbers."""
  words = [int(seed) & (2**64 - 1), int(seed) >> 64]
  for t in tag:
    if isinstance(t, str):
      words.extend(t.encode())
    else:
      words.append(int(t) & (2**32 - 1))
  state = np.random.SeedSequence(words).generate_state(2, np.uint32)
  return (int(state[0]) << 31) | (int(state[1]) >> 1)


def generator(seed: int, *tag, device) -> torch.Generator:
  return torch.Generator(device=device).manual_seed(sub_seed(seed, *tag))


def make_weights(shapes: dict, seed: int, device) -> dict[str, torch.Tensor]:
  """float32 weights for ``shapes`` (name → shape) in one draw: a matrix
  ``w`` N(0, 1/fan_in) (its first axis), a bias or LayerNorm offset
  N(0, 0.01), a LayerNorm scale 1 + N(0, 0.01), views of one tensor."""
  total = sum(math.prod(s) for s in shapes.values())
  flat = torch.randn(total, generator=generator(seed, "weights",
                                                device=device),
                     device=device)
  out, offset = {}, 0
  for name, shape in shapes.items():
    n = math.prod(shape)
    t = flat[offset:offset + n].view(shape)
    offset += n
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 2:
      t.mul_(1.0 / math.sqrt(shape[0]))
    elif leaf == "scale":
      t.mul_(0.1).add_(1.0)
    else:
      t.mul_(0.1)
    out[name] = t
  return out


def make_stats(cfg, seed: int, device) -> dict[str, dict[str, torch.Tensor]]:
  """{"stddev", "mean", "diffs_stddev"} → variable → [levels] or scalar:
  stddevs in [0.5, 1.5), means in [0, 1)."""
  gen = generator(seed, "stats", device=device)
  names = sorted(set(cfg["input_variables"]) | set(cfg["target_variables"])
                 | set(cfg["forcing_variables"]))
  out = {}
  for kind, offset in (("stddev", 0.5), ("mean", 0.0),
                       ("diffs_stddev", 0.5)):
    out[kind] = {}
    for name in names:
      shape = ((len(cfg["pressure_levels"]),)
               if name in cfg["atmospheric_variables"] else ())
      out[kind][name] = torch.rand(shape, generator=gen,
                                   device=device) + offset
  return out


def grid_shape(cfg) -> tuple[int, int]:
  res = cfg["resolution"]
  return (len(np.arange(-90.0, 90.0 + res / 2, res)),
          len(np.arange(0.0, 360.0, res)))


def make_fields(cfg, names, batch: int, times: int, gen: torch.Generator,
                device, dtype=torch.float32) -> dict[str, torch.Tensor]:
  """N(0, 1) fields: name → [batch, times, (levels,) lat, lon]; a static
  variable → [lat, lon]."""
  lat, lon = grid_shape(cfg)
  nlev = len(cfg["pressure_levels"])
  out = {}
  for name in sorted(names):
    if name in cfg["static_variables"]:
      shape = (lat, lon)
    elif name in cfg["atmospheric_variables"]:
      shape = (batch, times, nlev, lat, lon)
    else:
      shape = (batch, times, lat, lon)
    out[name] = torch.randn(shape, generator=gen, device=device).to(dtype)
  return out
