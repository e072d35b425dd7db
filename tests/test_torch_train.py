"""The port's training path against graphcast_tpu's, on shared weights and
inputs (tiny config: 30° grid, mesh-1, latent 16, 2 message-passing steps,
batch 1, and batch 2 where named; both packages build the geometry with
their default backend, which resolves alike in both).

- ``GraphCast.loss`` and every parameter gradient, f32, against the JAX
  model with ``fused_aggregation`` False (plain XLA) and True (Pallas
  forward and backward kernels in interpret mode): rtol/atol 5e-4, as
  tests/test_pallas_edge.py:324-331 holds the JAX paths to each other.
- The bf16 wrapper stack's AR-1 loss and gradients within JAX's own bf16
  noise floor: per parameter, rms(port bf16 - jax f32) <= 2 x rms(jax bf16
  - jax f32) + 1e-4 x rms(jax f32) (tests/test_torch_rollout.py's rule).
  The floor is that of the JAX configuration the port mirrors,
  ``fused_aggregation=True`` (bf16 hoisted edge consts, fused kernels):
  the plain XLA path rounds the mesh2grid edge-embed gradients, sums over
  all edges, at other points, and its floor there is a third lower.
- A 2-step AR loss and its gradients: with per-step checkpointing equal to
  without (rtol 1e-6: the recompute runs the same CPU operations), and
  equal to the JAX stack's (5e-4).
- At batch 2, the f32 stack's AR-1 and AR-2 loss and every gradient
  against the JAX stack's (5e-4): both packages' general path, the batch
  mean of the per-example losses, the base of data parallelism.
- The optimizer against optax's chain fed the same numpy gradients, 5
  steps (1e-6; the first step's learning rate is 0, so it changes nothing).
- 3 ``make_train_step`` steps against the JAX package's jitted train step:
  losses 5e-4; parameters 5e-4 plus 5e-5 absolute (AdamW moves each element
  by about the learning rate, 1e-4 here, whatever the gradient's size, so
  elements whose tiny gradients differ in sign may differ by that much).
- ``autoregressive_curriculum`` against the JAX package's.
"""

import sys

import torch

# torch.utils.checkpoint and torch.optim import torch._dynamo at first use.
# That import calls importlib.util.find_spec on optional packages, which
# raises on a module without __spec__, such as the fake ``xarray`` that
# tests/fake_xarray.py installs for other test files. Import it now, with
# any such module set aside.
_xarray = sys.modules.pop("xarray", None)
try:
  import torch._dynamo  # noqa: F401
finally:
  if _xarray is not None:
    sys.modules["xarray"] = _xarray

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from graphcast_tpu import train as jax_train
from graphcast_tpu.data import synthetic as jax_synthetic
from graphcast_tpu.models import configs as jax_configs
from graphcast_tpu.models.graphcast import GraphCast as JaxGraphCast
from graphcast_tpu.wrappers import (
    Autoregressive as JaxAutoregressive, Bfloat16Cast as JaxBfloat16Cast,
    InputsAndResiduals as JaxInputsAndResiduals)
from graphcast_tpu_torch import params, train
from graphcast_tpu_torch.data import synthetic
from graphcast_tpu_torch.models import configs
from graphcast_tpu_torch.models.graphcast import GraphCast
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
TOL = 5e-4


@pytest.fixture(scope="module")
def case():
  return build_case()


@pytest.fixture(scope="module")
def case2():
  return build_case(batch=2)


def build_case(batch=1):
  """JAX models/params and data, the port's data and a model factory."""
  jtask = jax_configs.TaskConfig(**TINY_TASK)
  task = configs.TaskConfig(**TINY_TASK)
  j_data = jax_synthetic.make_example_batch(
      jtask, resolution=30.0, batch=batch, num_target_times=2)
  t_data = synthetic.make_example_batch(
      task, resolution=30.0, batch=batch, num_target_times=2,
      device="cpu")
  models = {fused: JaxGraphCast(jax_configs.ModelConfig(**TINY_MODEL),
                                jtask, cache_dir="",
                                fused_aggregation=fused)
            for fused in (False, True)}
  j1 = [fs.isel(time=slice(0, 1)) if i else fs
        for i, fs in enumerate(j_data)]
  jax_params = models[False].init(jax.random.PRNGKey(0), *j1)
  learned, statics = jax_train.partition_params(jax_params)
  fused_params = models[True].attach_graph_statics(dict(learned),
                                                   j_data[0])
  _, fused_statics = jax_train.partition_params(fused_params)
  flat = params.params_from_jax(jax.tree_util.tree_map(np.asarray, learned))

  def port_model():
    model = GraphCast(configs.ModelConfig(**TINY_MODEL), task,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    params.load_params(model, flat)
    return model

  return dict(jax_models=models, learned=learned,
              statics={False: statics, True: fused_statics},
              j_data=j_data, t_data=t_data, port_model=port_model,
              j_stats=jax_synthetic.make_norm_stats(jtask),
              t_stats=synthetic.make_norm_stats(task, device="cpu"))


def _steps(data, n):
  inputs, targets, forcings = data
  return inputs, targets.isel(time=slice(0, n)), forcings.isel(
      time=slice(0, n))


def _jax_loss_and_grads(predictor, case, statics, n):
  data = _steps(case["j_data"], n)

  def fn(learned):
    loss, _ = predictor.loss({**learned, **statics}, jax.random.PRNGKey(0),
                             *data)
    return jnp.mean(loss)

  loss, grads = jax.jit(jax.value_and_grad(fn))(case["learned"])
  return float(loss), params.params_from_jax(
      jax.tree_util.tree_map(np.asarray, grads))


def _port_loss_and_grads(predictor, model, case, n):
  model.zero_grad(set_to_none=True)
  data = _steps(case["t_data"], n)
  loss, diagnostics = predictor.loss(*data)
  assert loss.dtype == torch.float32
  assert loss.shape == (data[1].sizes["batch"],)
  assert set(diagnostics) == set(TINY_TASK["target_variables"])
  loss = loss.mean()
  loss.backward()
  grads = {k: (np.zeros(tuple(p.shape), np.float32) if p.grad is None
               else p.grad.numpy().copy())
           for k, p in params.flat_params(model).items()}
  return loss.item(), grads


def _jax_stack(case, bf16, fused=False, **kw):
  s = case["j_stats"]
  return JaxAutoregressive(JaxInputsAndResiduals(
      JaxBfloat16Cast(case["jax_models"][fused], enabled=bf16),
      stddev_by_level=s[0], mean_by_level=s[1], diffs_stddev_by_level=s[2]),
                           **kw)


def _port_stack(case, model, bf16, **kw):
  s = case["t_stats"]
  return Autoregressive(InputsAndResiduals(
      Bfloat16Cast(model, enabled=bf16), stddev_by_level=s[0],
      mean_by_level=s[1], diffs_stddev_by_level=s[2]), **kw)


def _assert_grads_close(got, want, rtol=TOL, atol=TOL):
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                               err_msg=k)


def _rms(x):
  return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))


@pytest.mark.parametrize("fused", [False, True])
def test_graphcast_loss_and_grads_match_jax(fused, case):
  model = case["port_model"]()
  want_loss, want = _jax_loss_and_grads(case["jax_models"][fused], case,
                                        case["statics"][fused], 1)
  got_loss, got = _port_loss_and_grads(model, model, case, 1)
  np.testing.assert_allclose(got_loss, want_loss, rtol=TOL)
  _assert_grads_close(got, want)


def test_bf16_stack_loss_and_grads_within_jax_noise_floor(case):
  jf_loss, jf = _jax_loss_and_grads(_jax_stack(case, False), case,
                                    case["statics"][False], 1)
  jb_loss, jb = _jax_loss_and_grads(_jax_stack(case, True, fused=True), case,
                                    case["statics"][True], 1)
  model = case["port_model"]()
  loss, got = _port_loss_and_grads(_port_stack(case, model, True), model,
                                   case, 1)
  assert abs(jb_loss - jf_loss) > 0  # non-vacuity: bf16 must bite
  assert abs(loss - jf_loss) <= 2 * abs(jb_loss - jf_loss) + 1e-4 * jf_loss
  for k in jf:
    floor = _rms(jb[k] - jf[k])
    assert _rms(got[k] - jf[k]) <= 2 * floor + 1e-4 * _rms(jf[k]), (
        k, _rms(got[k] - jf[k]), floor)


def test_ar2_loss_checkpointed_equals_plain_and_jax(case):
  statics = case["statics"][False]
  want_loss, want = _jax_loss_and_grads(
      _jax_stack(case, False, gradient_checkpointing=True), case, statics, 2)
  out = {}
  for ckpt in (False, True):
    model = case["port_model"]()
    out[ckpt] = _port_loss_and_grads(
        _port_stack(case, model, False, gradient_checkpointing=ckpt), model,
        case, 2)
  np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
  _assert_grads_close(out[True][1], out[False][1], rtol=1e-6, atol=1e-9)
  np.testing.assert_allclose(out[True][0], want_loss, rtol=TOL)
  _assert_grads_close(out[True][1], want)


@pytest.mark.parametrize("steps", [1, 2])
def test_loss_and_grads_match_jax_at_batch_2(steps, case2):
  """AR-1 and AR-2 (per-step checkpointing) at batch 2: the loss is the
  mean of the two examples' and every gradient that mean's."""
  want_loss, want = _jax_loss_and_grads(
      _jax_stack(case2, False, gradient_checkpointing=True), case2,
      case2["statics"][False], steps)
  model = case2["port_model"]()
  got_loss, got = _port_loss_and_grads(
      _port_stack(case2, model, False, gradient_checkpointing=True), model,
      case2, steps)
  np.testing.assert_allclose(got_loss, want_loss, rtol=TOL)
  _assert_grads_close(got, want)


def test_ar2_loss_and_predictions_stack_over_time(case):
  model = case["port_model"]()
  stack = _port_stack(case, model, False, gradient_checkpointing=True)
  (loss, diagnostics), preds = stack.loss_and_predictions(
      *_steps(case["t_data"], 2))
  targets = case["t_data"][1]
  assert loss.shape == (1,) and torch.isfinite(loss).all()
  for name in targets.var_names:
    assert preds[name].dims == targets[name].dims
    assert preds[name].shape == targets[name].shape
    assert diagnostics[name].shape == (1,)


def test_optimizer_matches_optax_chain():
  rng = np.random.RandomState(0)
  shapes = {"w": (6, 5), "b": (5,), "s": (3,)}
  init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
  # Gradients of growing size: the global-norm clip (32) acts from step 3.
  grads = [{k: (rng.randn(*s) * 6.0 * (i + 1)).astype(np.float32)
            for k, s in shapes.items()} for i in range(5)]
  kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.1,
            clip_norm=32.0)
  opt = jax_train.graphcast_optimizer(**kw)
  j_params = {k: jnp.asarray(v) for k, v in init.items()}
  state = opt.init(j_params)
  t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
  t_opt = train.graphcast_optimizer(t_params.values(), **kw)
  for i, g in enumerate(grads):
    updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, j_params)
    j_params = optax.apply_updates(j_params, updates)
    t_opt.zero_grad()
    for k, p in t_params.items():
      p.grad = torch.from_numpy(g[k].copy())
    t_opt.step()
    for k in shapes:
      got = t_params[k].detach().numpy()
      np.testing.assert_allclose(got, np.asarray(j_params[k]), rtol=1e-6,
                                 atol=1e-6, err_msg=f"step {i} {k}")
      if i == 0:
        np.testing.assert_array_equal(got, init[k])  # learning rate 0


def test_schedule_matches_optax():
  kw = dict(init_value=0.0, peak_value=1e-3, warmup_steps=10,
            decay_steps=50)
  ours = train.warmup_cosine_decay_schedule(**kw)
  ref = optax.warmup_cosine_decay_schedule(**kw)
  for count in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80):
    # optax evaluates in f32: atol 1e-6 of the peak.
    np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6,
                               atol=1e-9)


def test_train_steps_match_jax(case):
  kw = dict(peak_lr=1e-4, warmup_steps=1, total_steps=10)
  j_stack = _jax_stack(case, False)
  j_data = _steps(case["j_data"], 1)
  optimizer = jax_train.graphcast_optimizer(**kw)
  state = jax_train.init_train_state(j_stack, optimizer,
                                     jax.random.PRNGKey(0), *j_data)
  state.params = jax_train.merge_params(case["learned"],
                                        case["statics"][False])
  state.opt_state = optimizer.init(case["learned"])
  j_step = jax_train.make_train_step(j_stack, optimizer, donate=False)
  model = case["port_model"]()
  t_step = train.make_train_step(
      _port_stack(case, model, False),
      train.graphcast_optimizer(model.parameters(), **kw))
  t_data = _steps(case["t_data"], 1)
  for i in range(3):
    state, j_loss, _ = j_step(state, jax.random.PRNGKey(i), *j_data)
    t_loss, diagnostics = t_step(*t_data)
    assert t_loss.shape == () and set(diagnostics) == set(
        TINY_TASK["target_variables"])
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=TOL)
  learned, _ = jax_train.partition_params(state.params)
  want = params.params_from_jax(jax.tree_util.tree_map(np.asarray, learned))
  got = {k: p.detach().numpy() for k, p in params.flat_params(model).items()}
  _assert_grads_close(got, want, atol=5e-5)


def test_autoregressive_curriculum_matches_jax():
  for kw in (dict(), dict(total_steps=1000, fine_tune_steps=110,
                          max_ar_steps=4)):
    ours = train.autoregressive_curriculum(**kw)
    ref = jax_train.autoregressive_curriculum(**kw)
    total = kw.get("total_steps", 300_000)
    for step in sorted({0, 1, total // 2, total - 1, total,
                        *range(total - kw.get("fine_tune_steps", 11_000) - 2,
                               total, 997 if not kw else 7)}):
      assert ours(step) == ref(step), step
