"""Parameters of the port: flat keys and shapes equal the JAX package's
goldens, weights cross by key both ways, and random init draws the JAX
package's distribution. The pinned config copies agree with the JAX
package's."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from graphcast_tpu import train
from graphcast_tpu.data import synthetic as jax_synthetic
from graphcast_tpu.models import configs as jax_configs
from graphcast_tpu.models import zoo as jax_zoo
from graphcast_tpu.models.graphcast import GraphCast as JaxGraphCast
from graphcast_tpu_torch import params
from graphcast_tpu_torch.models import configs, zoo
from graphcast_tpu_torch.models.graphcast import (
    GraphCast, num_grid_input_channels)
from graphcast_tpu_torch.nn import core

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "goldens",
                           "zoo_param_shapes.json")

TINY_TASK = dict(
    input_variables=("2m_temperature", "temperature",
                     "toa_incident_solar_radiation", "land_sea_mask"),
    target_variables=("2m_temperature", "temperature"),
    forcing_variables=("toa_incident_solar_radiation",),
    pressure_levels=(500, 850),
    input_duration="12h")
TINY_MODEL = dict(resolution=30.0, mesh_size=1, latent_size=16,
                  gnn_msg_steps=2, hidden_layers=1)


@pytest.mark.parametrize("name", sorted(zoo.GRAPHCAST_PRESETS))
def test_param_keys_and_shapes_match_golden(name):
  with open(GOLDEN_PATH) as f:
    golden = json.load(f)[name]
  preset = zoo.GRAPHCAST_PRESETS[name]()
  model = GraphCast(preset.model_config, preset.task_config,
                    generator=torch.Generator().manual_seed(0), device="cpu")
  shapes = {k: list(p.shape) for k, p in params.flat_params(model).items()}
  assert shapes == golden


@pytest.mark.parametrize("name", sorted(zoo.GRAPHCAST_PRESETS))
def test_presets_and_configs_equal_jax_package(name):
  ours = zoo.GRAPHCAST_PRESETS[name]()
  ref = jax_zoo.GRAPHCAST_PRESETS[name]()
  assert ours.name == ref.name
  assert (dataclasses.asdict(ours.model_config)
          == dataclasses.asdict(ref.model_config))
  assert (dataclasses.asdict(ours.task_config)
          == dataclasses.asdict(ref.task_config))
  assert (configs.num_output_channels(ours.task_config)
          == jax_configs.num_output_channels(ref.task_config))


def test_input_channels_match_stacked_data():
  """num_grid_input_channels (from the task config) equals the channel count
  the JAX package stacks from real example data."""
  from graphcast_tpu.fields import stacked_channels
  task = jax_configs.TASK_13
  inputs, _, forcings = jax_synthetic.make_example_batch(
      task, resolution=30.0)
  expected = stacked_channels(inputs) + stacked_channels(forcings)
  assert num_grid_input_channels(configs.TASK_13) == expected


def test_params_from_jax_round_trips():
  task = jax_configs.TaskConfig(**TINY_TASK)
  inputs, targets, forcings = jax_synthetic.make_example_batch(
      task, resolution=30.0)
  jax_model = JaxGraphCast(jax_configs.ModelConfig(**TINY_MODEL), task,
                           cache_dir="")
  tree = jax_model.init(jax.random.PRNGKey(3), inputs, targets, forcings)
  assert "graph_statics" in tree
  learned, _ = train.partition_params(tree)
  flat = params.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
  assert not any("graph_statics" in k for k in flat)
  model = GraphCast(configs.ModelConfig(**TINY_MODEL),
                    configs.TaskConfig(**TINY_TASK),
                    generator=torch.Generator().manual_seed(0), device="cpu")
  params.load_params(model, flat)
  back = params.params_to_jax(model)
  want = jax.tree_util.tree_map(np.asarray, learned)
  assert (jax.tree_util.tree_structure(back)
          == jax.tree_util.tree_structure(want))
  for a, b in zip(jax.tree_util.tree_leaves(back),
                  jax.tree_util.tree_leaves(want)):
    np.testing.assert_array_equal(a, b)


def test_load_params_rejects_missing_keys_and_bad_shapes():
  model = GraphCast(configs.ModelConfig(**TINY_MODEL),
                    configs.TaskConfig(**TINY_TASK),
                    generator=torch.Generator().manual_seed(0), device="cpu")
  flat = {k: p.detach().numpy() for k, p in params.flat_params(model).items()}
  key = next(iter(flat))
  with pytest.raises(KeyError):
    params.load_params(model, {k: v for k, v in flat.items() if k != key})
  bad = dict(flat)
  bad[key] = np.zeros((1,) + flat[key].shape, np.float32)
  with pytest.raises(ValueError):
    params.load_params(model, bad)


def test_random_init_matches_jax_distribution_and_generator():
  """Truncated normal in [-2, 2] x 1/sqrt(fan_in), no variance correction
  (graphcast_tpu nn/core.py:43); biases/offsets 0, scales 1; the same
  generator seed gives the same weights."""
  lin = core.Linear(256, 512)
  core.reset_parameters(lin, torch.Generator().manual_seed(0))
  w = lin.w.detach().numpy()
  stddev = 1.0 / np.sqrt(256)
  assert np.abs(w).max() <= 2 * stddev + 1e-7
  # Sample stddev of a [-2, 2]-truncated unit normal: 0.8796.
  np.testing.assert_allclose(w.std() / stddev, core_factor(), rtol=0.01)
  key = jax.random.PRNGKey(0)
  jw = np.asarray(jax.random.truncated_normal(key, -2.0, 2.0, (256, 512)))
  np.testing.assert_allclose(w.std() / stddev, jw.std(), rtol=0.01)
  assert (lin.b.detach().numpy() == 0).all()
  lin2 = core.Linear(256, 512)
  core.reset_parameters(lin2, torch.Generator().manual_seed(0))
  assert torch.equal(lin.w, lin2.w)
  ln = core.LayerNorm(8)
  assert (ln.scale.detach().numpy() == 1).all()
  assert (ln.offset.detach().numpy() == 0).all()


def core_factor():
  from graphcast_tpu.nn.core import TRUNCATED_NORMAL_STDDEV_FACTOR
  return TRUNCATED_NORMAL_STDDEV_FACTOR

