"""The port's one-step GraphCast against graphcast_tpu's, f32, on shared
weights and inputs (tiny config: 30° grid, mesh-1, latent 16, 2
message-passing steps): batch 1 (the port's fused K1/K2 path) and batch 2
(its general path with K3's plain version, members with different inputs).

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


def _one_step_both(fused, batch):
  """(port prediction, JAX prediction) of one step on shared weights and
  inputs; at batch > 1 the inputs of each member differ."""
  task = jax_configs.TaskConfig(**TINY_TASK)
  inputs, targets, forcings = jax_synthetic.make_example_batch(
      task, resolution=30.0, batch=batch)
  t_in, t_tg, t_fc = synthetic.make_example_batch(
      configs.TaskConfig(**TINY_TASK), resolution=30.0, batch=batch,
      device="cpu")
  if batch > 1:
    rng = np.random.RandomState(7)
    for name in t_in.var_names:
      if "batch" in t_in[name].dims:
        noisy = (np.asarray(inputs.data(name)) + rng.randn(
            *inputs[name].shape).astype(np.float32))
        inputs = inputs.replace_data(name, noisy)
        t_in.data(name).copy_(torch.from_numpy(noisy))
  jax_model = JaxGraphCast(jax_configs.ModelConfig(**TINY_MODEL), task,
                           cache_dir="", fused_aggregation=fused)
  jax_params = jax_model.init(jax.random.PRNGKey(0), inputs, targets,
                              forcings)
  want = jax_model(jax_params, None, inputs, targets, forcings)
  model = _port_model(jax_params)
  with torch.inference_mode():
    got = model(t_in, t_tg, t_fc)
  return got, want


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("fused", [False, True])
def test_one_step_matches_jax_graphcast(fused, batch, numpy_geometry):
  """Batch 1 (fused K1/K2 twins) and batch 2 (the general path, K3's plain
  version) against JAX's fused and plain paths."""
  got, want = _one_step_both(fused, batch)
  assert got.var_names == want.var_names
  for name in want.var_names:
    assert got[name].dims == want[name].dims
    np.testing.assert_allclose(got.data(name).numpy(),
                               np.asarray(want.data(name)),
                               rtol=5e-4, atol=5e-4, err_msg=name)
  if batch > 1:
    t = got.data("temperature")
    assert not torch.allclose(t[0], t[1])  # members differ


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


def test_batch_members_match_batch_one_runs():
  """Each member of a batch-2 step (general path) equals a batch-1 step of
  its own inputs (fused path) on the CPU, at f32 summation-order level,
  and nothing is hoisted at batch 2."""
  model = GraphCast(configs.ModelConfig(**TINY_MODEL),
                    configs.TaskConfig(**TINY_TASK),
                    generator=torch.Generator().manual_seed(0), device="cpu")
  inputs, targets, forcings = synthetic.make_example_batch(
      configs.TaskConfig(**TINY_TASK), resolution=30.0, batch=2, device="cpu")
  inputs = inputs.map(lambda n, f: f._replace(data=f.data + torch.arange(
      2.0).reshape((2,) + (1,) * (f.data.ndim - 1)))
      if "batch" in f.dims else f)
  assert model.precompute_step_statics(inputs) == {}
  with torch.inference_mode():
    both = model(inputs, targets, forcings)
    for b in range(2):
      one = model(*(fs.isel(batch=slice(b, b + 1))
                    for fs in (inputs, targets, forcings)))
      for name in targets.var_names:
        np.testing.assert_allclose(both.data(name)[b:b + 1].numpy(),
                                   one.data(name).numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
