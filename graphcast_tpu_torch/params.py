"""Parameters by flat key, shared with the JAX package.

A GraphCast or GenCast module's parameter names, with "/" in place of ".", are
graphcast_tpu's flat param keys (e.g.
``mesh_gnn/processor_3_edges_mesh/mlp/linear_1/w``), pinned by
tests/goldens/zoo_param_shapes.json; weights are stored [in, out] in both
packages, so they cross with no transposes.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

# Non-trainable data the JAX package threads inside its params tree: graph
# statics (graphcast_tpu/train.py partition_params) and GenCast's SHT noise
# basis (gencast.py:174); the port keeps both on the model.
STATICS_KEYS = ("graph_statics", "noise_statics")


def flat_params(module: nn.Module) -> dict[str, torch.Tensor]:
  """{flat key: parameter} of a module."""
  return {name.replace(".", "/"): p for name, p in module.named_parameters()}


def params_from_jax(tree: Mapping) -> dict[str, np.ndarray]:
  """Flattens a graphcast_tpu param tree (nested dicts of arrays) to
  {flat key: float32 numpy array}, dropping the non-trainable statics."""
  out = {}

  def walk(node, prefix):
    for k, v in node.items():
      if k in STATICS_KEYS:
        continue
      key = f"{prefix}/{k}" if prefix else str(k)
      if isinstance(v, Mapping):
        walk(v, key)
      else:
        out[key] = np.asarray(v, dtype=np.float32)

  walk(tree, "")
  return out


@torch.no_grad()
def load_params(module: nn.Module, flat: Mapping[str, np.ndarray]):
  """Copies {flat key: array} into ``module``'s parameters. The key sets
  and every shape must match exactly."""
  own = flat_params(module)
  missing = sorted(set(own) - set(flat))
  extra = sorted(set(flat) - set(own))
  if missing or extra:
    raise KeyError(f"param keys differ: missing {missing[:5]}, "
                   f"unexpected {extra[:5]}")
  for key, p in own.items():
    value = torch.from_numpy(np.array(flat[key], dtype=np.float32))
    if tuple(value.shape) != tuple(p.shape):
      raise ValueError(f"{key}: shape {tuple(value.shape)} != "
                       f"{tuple(p.shape)}")
    p.copy_(value.to(p.dtype))


def params_to_jax(module: nn.Module) -> dict:
  """The module's parameters as a graphcast_tpu-style nested numpy tree."""
  tree: dict = {}
  for key, p in flat_params(module).items():
    node = tree
    *path, leaf = key.split("/")
    for part in path:
      node = node.setdefault(part, {})
    node[leaf] = p.detach().cpu().numpy()
  return tree
