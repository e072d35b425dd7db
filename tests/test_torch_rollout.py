"""The wrapper stack Autoregressive(InputsAndResiduals(Bfloat16Cast(
GraphCast))) of the port against graphcast_tpu's, on shared weights and
inputs (tiny config, batch 1, JAX side on its plain XLA path).

- f32 (Bfloat16Cast disabled): rollout_final over 3 steps and the stacked
  2-step predictions, tolerance 2e-4 (f32 summation order, amplified by the
  autoregressive feedback).
- bf16: the noise-floor method of tests/test_wrapper_parity.py. bf16 output
  cannot match bit for bit (the two frameworks round elementwise chains at
  different points), so per variable rms(port bf16 - jax f32) must stay
  within 2 x rms(jax bf16 - jax f32) + 1e-4 x rms(jax f32), the JAX
  package's own bf16 rounding noise.

Also: the synthetic data and norm stats are the same numpy arrays; and
rollout.py's chunked forms against the JAX package's with the one-step
InputsAndResiduals(GraphCast) predictor, f32, 2e-4: ``chunked_prediction``
(3 one-step chunks fed back as inputs), ``chunked_ensemble_prediction``
(2 members, the batch-2 general path), ``tile_batch``, ``get_next_inputs``,
the error on uneven target times, and one generator drawn in chunk order.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from graphcast_tpu import rollout as jax_rollout
from graphcast_tpu import train
from graphcast_tpu.data import synthetic as jax_synthetic
from graphcast_tpu.geometry import artifact as jax_artifact
from graphcast_tpu.models import configs as jax_configs
from graphcast_tpu.models.graphcast import GraphCast as JaxGraphCast
from graphcast_tpu.wrappers import (
    Autoregressive as JaxAutoregressive, Bfloat16Cast as JaxBfloat16Cast,
    InputsAndResiduals as JaxInputsAndResiduals)
from graphcast_tpu_torch import params, rollout
from graphcast_tpu_torch.data import synthetic
from graphcast_tpu_torch.models import configs
from graphcast_tpu_torch.models.graphcast import GraphCast
from graphcast_tpu_torch.rollout import extend_targets_template
from graphcast_tpu_torch.wrappers import (
    Autoregressive, Bfloat16Cast, InputsAndResiduals)

TINY_TASK = dict(
    input_variables=("2m_temperature", "temperature",
                     "toa_incident_solar_radiation", "land_sea_mask"),
    target_variables=("2m_temperature", "temperature"),
    forcing_variables=("toa_incident_solar_radiation",),
    pressure_levels=(500, 850),
    input_duration="12h")
TINY_MODEL = dict(resolution=30.0, mesh_size=1, latent_size=16,
                  gnn_msg_steps=2, hidden_layers=1)
STEPS = 3


@pytest.fixture(scope="module")
def case():
  """JAX params + both packages' stacks (bf16 on/off) and inputs."""
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jax_artifact, "build_artifact", functools.partial(
        jax_artifact.build_artifact, backend="numpy"))
    jtask = jax_configs.TaskConfig(**TINY_TASK)
    task = configs.TaskConfig(**TINY_TASK)
    j_in, j_tg, j_fc = jax_synthetic.make_example_batch(
        jtask, resolution=30.0, batch=1, num_target_times=STEPS)
    t_in, t_tg, t_fc = synthetic.make_example_batch(
        task, resolution=30.0, batch=1, num_target_times=STEPS, device="cpu")
    jax_model = JaxGraphCast(jax_configs.ModelConfig(**TINY_MODEL), jtask,
                             cache_dir="", fused_aggregation=False)
    jax_params = jax_model.init(
        jax.random.PRNGKey(0), j_in, j_tg.isel(time=slice(0, 1)),
        j_fc.isel(time=slice(0, 1)))
    j_stats = jax_synthetic.make_norm_stats(jtask)
    t_stats = synthetic.make_norm_stats(task, device="cpu")
    model = GraphCast(configs.ModelConfig(**TINY_MODEL), task,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    learned, _ = train.partition_params(jax_params)
    params.load_params(model, params.params_from_jax(
        jax.tree_util.tree_map(np.asarray, learned)))
    jax_out = {}
    for bf16 in (False, True):
      stack = JaxAutoregressive(JaxInputsAndResiduals(
          JaxBfloat16Cast(jax_model, enabled=bf16),
          stddev_by_level=j_stats[0], mean_by_level=j_stats[1],
          diffs_stddev_by_level=j_stats[2]))
      jax_out[bf16] = stack.rollout_final(
          jax_params, jax.random.PRNGKey(0), j_in,
          j_tg.isel(time=slice(0, 1)), j_fc)
      if not bf16:
        jax_out["stacked"] = stack(
            jax_params, jax.random.PRNGKey(0), j_in,
            j_tg.isel(time=slice(0, 2)), j_fc.isel(time=slice(0, 2)))

  def port_stack(bf16):
    return Autoregressive(InputsAndResiduals(
        Bfloat16Cast(model, enabled=bf16), stddev_by_level=t_stats[0],
        mean_by_level=t_stats[1], diffs_stddev_by_level=t_stats[2]))

  def jax_stack(bf16):
    return JaxInputsAndResiduals(
        JaxBfloat16Cast(jax_model, enabled=bf16), stddev_by_level=j_stats[0],
        mean_by_level=j_stats[1], diffs_stddev_by_level=j_stats[2])

  return dict(jax=jax_out, port_stack=port_stack, inputs=t_in,
              targets=t_tg, forcings=t_fc, jax_stack=jax_stack,
              jax_params=jax_params, jax_data=(j_in, j_tg, j_fc))


def _rms(x):
  return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))


def test_rollout_final_f32_matches_jax(case):
  final = case["port_stack"](False).rollout_final(
      case["inputs"], case["targets"].isel(time=slice(0, 1)),
      case["forcings"])
  want = case["jax"][False]
  assert final.var_names == want.var_names
  for name in want.var_names:
    np.testing.assert_allclose(final.data(name).numpy(),
                               np.asarray(want.data(name)),
                               rtol=2e-4, atol=2e-4, err_msg=name)


def test_stacked_predictions_f32_match_jax(case):
  preds = case["port_stack"](False)(
      case["inputs"], case["targets"].isel(time=slice(0, 2)),
      case["forcings"].isel(time=slice(0, 2)))
  want = case["jax"]["stacked"]
  for name in want.var_names:
    assert preds[name].dims == want[name].dims
    np.testing.assert_allclose(preds.data(name).numpy(),
                               np.asarray(want.data(name)),
                               rtol=2e-4, atol=2e-4, err_msg=name)


def test_rollout_final_bf16_within_jax_noise_floor(case):
  final = case["port_stack"](True).rollout_final(
      case["inputs"], case["targets"].isel(time=slice(0, 1)),
      case["forcings"])
  for name in TINY_TASK["target_variables"]:
    jf = np.asarray(case["jax"][False].data(name), np.float32)
    jb = np.asarray(case["jax"][True].data(name), np.float32)
    ours = final.data(name).float().numpy()
    assert final.data(name).dtype == torch.float32
    floor = _rms(jb - jf)
    assert floor > 1e-5, name  # non-vacuity: bf16 must actually bite
    assert _rms(ours - jf) <= 2 * floor + 1e-4 * _rms(jf), (
        name, _rms(ours - jf), floor)


@pytest.mark.parametrize("which", ["batch", "norm_stats"])
def test_synthetic_data_equals_jax_package(which):
  task = configs.TaskConfig(**TINY_TASK)
  jtask = jax_configs.TaskConfig(**TINY_TASK)
  if which == "batch":
    ours = synthetic.make_example_batch(task, 30.0, num_target_times=2,
                                        device="cpu")
    ref = jax_synthetic.make_example_batch(jtask, 30.0, num_target_times=2)
  else:
    ours = synthetic.make_norm_stats(task, device="cpu")
    ref = jax_synthetic.make_norm_stats(jtask)
  for a, b in zip(ours, ref):
    assert a.var_names == b.var_names
    assert a.coords.keys() == b.coords.keys()
    for k in a.coords:
      np.testing.assert_array_equal(a.coords[k], b.coords[k])
    for n in a.var_names:
      assert a[n].dims == b[n].dims
      np.testing.assert_array_equal(a.data(n).numpy(), np.asarray(b.data(n)))


def test_extend_targets_template_matches_jax():
  _, targets, _ = synthetic.make_example_batch(
      configs.TaskConfig(**TINY_TASK), 30.0, num_target_times=1, device="cpu")
  _, j_targets, _ = jax_synthetic.make_example_batch(
      jax_configs.TaskConfig(**TINY_TASK), 30.0, num_target_times=1)
  ours = extend_targets_template(targets, 4)
  ref = jax_rollout.extend_targets_template(j_targets, 4)
  np.testing.assert_array_equal(ours.coords["time"], ref.coords["time"])
  for n in ref.var_names:
    assert tuple(ours[n].shape) == tuple(ref[n].shape)
    assert not ours.data(n).any()
  assert extend_targets_template(ours, 2).sizes["time"] == 2


def _one_step_stacks(case):
  """(port predictor_fn, JAX predictor_fn): InputsAndResiduals(GraphCast),
  f32, one step a call."""
  port = case["port_stack"](False)._predictor
  jstack = case["jax_stack"](False)

  def jax_fn(rng, inputs, targets_template, forcings):
    return jstack(case["jax_params"], rng, inputs, targets_template,
                  forcings)

  return port, jax_fn


def _assert_fieldsets_close(got, want, tol=2e-4):
  assert got.var_names == want.var_names
  for name in want.var_names:
    assert got[name].dims == want[name].dims
    assert got.data(name).device.type == "cpu"
    np.testing.assert_allclose(got.data(name).numpy(),
                               np.asarray(want.data(name)), rtol=tol,
                               atol=tol, err_msg=name)
  for k in ("time",):
    np.testing.assert_array_equal(got.coords[k], want.coords[k])


def test_chunked_prediction_matches_jax(case):
  """3 chunks of one step each, fed back as inputs (f32, 2e-4 as the
  autoregressive tests)."""
  port, jax_fn = _one_step_stacks(case)
  j_in, j_tg, j_fc = case["jax_data"]
  want = jax_rollout.chunked_prediction(jax_fn, jax.random.PRNGKey(0), j_in,
                                        j_tg, j_fc)
  got = rollout.chunked_prediction(port, None, case["inputs"],
                                   case["targets"], case["forcings"])
  assert got.sizes["time"] == STEPS
  _assert_fieldsets_close(got, want)


def test_chunked_ensemble_prediction_matches_jax(case):
  """Two members of a deterministic predictor, two chunks of one step: the
  batch-2 general path in both packages; the members agree."""
  port, jax_fn = _one_step_stacks(case)
  j_in, j_tg, j_fc = case["jax_data"]
  two = slice(0, 2)
  want = jax_rollout.chunked_ensemble_prediction(
      jax_fn, jax.random.PRNGKey(0), j_in, j_tg.isel(time=two),
      j_fc.isel(time=two), num_samples=2)
  got = rollout.chunked_ensemble_prediction(
      port, None, case["inputs"], case["targets"].isel(time=two),
      case["forcings"].isel(time=two), num_samples=2)
  assert got.sizes["batch"] == 2 and got.sizes["time"] == 2
  _assert_fieldsets_close(got, want)
  t = got.data("temperature")
  np.testing.assert_allclose(t[0].numpy(), t[1].numpy(), rtol=1e-5,
                             atol=1e-5)


def test_tile_batch_and_get_next_inputs_match_jax(case):
  j_in, j_tg, j_fc = case["jax_data"]
  t_in, t_tg, t_fc = case["inputs"], case["targets"], case["forcings"]
  for ours, ref in ((rollout.tile_batch(t_in, 3),
                     jax_rollout.tile_batch(j_in, 3)),
                    (rollout.get_next_inputs(t_in, t_tg.isel(time=slice(0, 1)),
                                             t_fc.isel(time=slice(0, 1))),
                     jax_rollout.get_next_inputs(
                         j_in, j_tg.isel(time=slice(0, 1)),
                         j_fc.isel(time=slice(0, 1))))):
    assert ours.var_names == ref.var_names
    assert ours.coords.keys() == ref.coords.keys()
    for n in ref.var_names:
      assert ours[n].dims == ref[n].dims
      np.testing.assert_array_equal(ours.data(n).numpy(),
                                    np.asarray(ref.data(n)))


def test_non_equispaced_target_times_raise(case):
  port, _ = _one_step_stacks(case)
  targets = case["targets"]
  bad = targets.assign_coords(time=targets.coords["time"] * np.array([1, 2,
                                                                      4]))
  with pytest.raises(ValueError, match="evenly spaced"):
    rollout.chunked_prediction(port, None, case["inputs"], bad,
                               case["forcings"])
  with pytest.raises(ValueError, match="divide"):
    rollout.chunked_prediction(port, None, case["inputs"], targets,
                               case["forcings"], num_steps_per_chunk=2)


def test_generator_is_drawn_in_chunk_order(case):
  """One generator serves every chunk, drawn in chunk order: chunk k gets
  the k-th draw of a fresh generator of the same seed."""
  def noisy(inputs, targets_template, forcings, generator):
    del inputs, forcings
    draw = float(torch.rand(1, generator=generator))
    return targets_template.map_data(lambda x: torch.full_like(x, draw))

  got = rollout.chunked_prediction(
      noisy, torch.Generator().manual_seed(3), case["inputs"],
      case["targets"], case["forcings"])
  want = torch.rand(STEPS, generator=torch.Generator().manual_seed(3))
  t = got.data("2m_temperature")
  for k in range(STEPS):
    assert torch.all(t[:, k] == want[k])
