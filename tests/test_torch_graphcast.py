"""The port's one-step GraphCast against graphcast_tpu's, f32, batch 1, on
shared weights and inputs (tiny config: 30° grid, mesh-1, latent 16, 2
message-passing steps).

The JAX model runs with ``fused_aggregation=True`` (Pallas kernels in
interpret mode) and ``False`` (plain XLA); tolerance 5e-4, that of
tests/test_graphcast_model.py:245-247. Both packages build the geometry with
the numpy connectivity backend (the port has no other), so the JAX side's
``build_artifact`` is pinned to it here.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from graphcast_tpu import train
from graphcast_tpu.data import synthetic as jax_synthetic
from graphcast_tpu.geometry import artifact as jax_artifact
from graphcast_tpu.models import configs as jax_configs
from graphcast_tpu.models.graphcast import GraphCast as JaxGraphCast
from graphcast_tpu_torch import params
from graphcast_tpu_torch.data import synthetic
from graphcast_tpu_torch.models import configs
from graphcast_tpu_torch.models.graphcast import GraphCast

TINY_TASK = dict(
    input_variables=("2m_temperature", "temperature",
                     "toa_incident_solar_radiation", "land_sea_mask"),
    target_variables=("2m_temperature", "temperature"),
    forcing_variables=("toa_incident_solar_radiation",),
    pressure_levels=(500, 850),
    input_duration="12h")
TINY_MODEL = dict(resolution=30.0, mesh_size=1, latent_size=16,
                  gnn_msg_steps=2, hidden_layers=1)


@pytest.fixture
def numpy_geometry(monkeypatch):
  monkeypatch.setattr(jax_artifact, "build_artifact", functools.partial(
      jax_artifact.build_artifact, backend="numpy"))


def _port_model(jax_params):
  model = GraphCast(configs.ModelConfig(**TINY_MODEL),
                    configs.TaskConfig(**TINY_TASK),
                    generator=torch.Generator().manual_seed(0), device="cpu")
  learned, _ = train.partition_params(jax_params)
  params.load_params(model, params.params_from_jax(
      jax.tree_util.tree_map(np.asarray, learned)))
  return model


@pytest.mark.parametrize("fused", [False, True])
def test_one_step_matches_jax_graphcast(fused, numpy_geometry):
  task = jax_configs.TaskConfig(**TINY_TASK)
  inputs, targets, forcings = jax_synthetic.make_example_batch(
      task, resolution=30.0, batch=1)
  jax_model = JaxGraphCast(jax_configs.ModelConfig(**TINY_MODEL), task,
                           cache_dir="", fused_aggregation=fused)
  jax_params = jax_model.init(jax.random.PRNGKey(0), inputs, targets,
                              forcings)
  want = jax_model(jax_params, None, inputs, targets, forcings)

  model = _port_model(jax_params)
  t_in, t_tg, t_fc = synthetic.make_example_batch(
      configs.TaskConfig(**TINY_TASK), resolution=30.0, batch=1, device="cpu")
  with torch.inference_mode():
    got = model(t_in, t_tg, t_fc)
  assert got.var_names == want.var_names
  for name in want.var_names:
    assert got[name].dims == want[name].dims
    np.testing.assert_allclose(got.data(name).numpy(),
                               np.asarray(want.data(name)),
                               rtol=5e-4, atol=5e-4, err_msg=name)


def test_hoisted_statics_give_the_same_prediction():
  model = GraphCast(configs.ModelConfig(**TINY_MODEL),
                    configs.TaskConfig(**TINY_TASK),
                    generator=torch.Generator().manual_seed(1), device="cpu")
  inputs, targets, forcings = synthetic.make_example_batch(
      configs.TaskConfig(**TINY_TASK), resolution=30.0, device="cpu")
  with torch.inference_mode():
    hoisted = model.precompute_step_statics(inputs)
    a = model(inputs, targets, forcings, **hoisted)
    b = model(inputs, targets, forcings)
  assert set(hoisted["static_edge_latents"]) == {"g2m_const", "m2g_const"}
  for name in targets.var_names:
    assert torch.equal(a.data(name), b.data(name))


def test_batch_above_one_is_not_ported():
  model = GraphCast(configs.ModelConfig(**TINY_MODEL),
                    configs.TaskConfig(**TINY_TASK),
                    generator=torch.Generator().manual_seed(0), device="cpu")
  inputs, targets, forcings = synthetic.make_example_batch(
      configs.TaskConfig(**TINY_TASK), resolution=30.0, batch=2, device="cpu")
  with pytest.raises(NotImplementedError, match="batch"):
    with torch.inference_mode():
      model(inputs, targets, forcings)
