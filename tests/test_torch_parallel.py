"""The port's parallelism (graphcast_tpu_torch/parallel, train.py's
data-parallel step, rollout.py's sharded ensemble, GenCast's sequence
parallelism, graft_entry.py's dry run) against the JAX package's on the
CPU.

The port's ranks are gloo processes (parallel/launch.py, the rank
functions in tests/torch_parallel_workers.py) that meet through a
``file://`` address under the test's tmp_path, so that test workers never
race for a port; they take one CPU thread each. The JAX side runs in the
test process on the 8 virtual CPU devices of tests/conftest.py. Weights
and data cross as numpy arrays in .npz files.

Tolerances: f32 5e-4 unless stated (summation order only); GenCast
gradients 2e-3 plus 2e-3 of each one's largest element, as
tests/test_torch_gencast.py holds them. Where the port's ranks compute the
same thing, they must agree bit for bit.
"""

import functools
import sys

import torch

# torch.optim imports torch._dynamo at first use, which calls
# importlib.util.find_spec on optional packages and raises on a module
# without __spec__, such as the fake ``xarray`` of tests/fake_xarray.py.
_xarray = sys.modules.pop("xarray", None)
try:
  import torch._dynamo  # noqa: F401
finally:
  if _xarray is not None:
    sys.modules["xarray"] = _xarray

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

import torch_parallel_workers as workers
from graphcast_tpu import fields as jax_fields
from graphcast_tpu import rollout as jax_rollout
from graphcast_tpu import train as jax_train
from graphcast_tpu.data import synthetic as jax_synthetic
from graphcast_tpu.diffusion import noise as jax_noise
from graphcast_tpu.models import configs as jax_configs
from graphcast_tpu.models import denoiser as jax_denoiser
from graphcast_tpu.models import gencast as jax_gencast
from graphcast_tpu.models import sparse_transformer as jax_st
from graphcast_tpu.models.graphcast import GraphCast as JaxGraphCast
from graphcast_tpu.parallel import sharding as jax_sharding
from graphcast_tpu.wrappers import (
    Autoregressive as JaxAutoregressive, Bfloat16Cast as JaxBfloat16Cast,
    InputsAndResiduals as JaxInputsAndResiduals, NaNCleaner as JaxNaNCleaner)
from graphcast_tpu_torch import graft_entry, params, rollout
from graphcast_tpu_torch.parallel import launch, sharding

TOL = 5e-4


def _spawn(tmp_path, fn, world, *args):
  launch.spawn(fn, world, args=(str(tmp_path),) + args, device="cpu",
               init_method=f"file://{tmp_path}/rendezvous", timeout_s=60)


def _save_weights(tmp_path, jax_params):
  learned, _ = jax_train.partition_params(jax_params)
  workers.save(tmp_path, "weights", **params.params_from_jax(
      jax.tree_util.tree_map(np.asarray, learned)))
  return learned


# ----- meshes -----

def test_hybrid_mesh_arrangement_matches_jax():
  """The dcn-major block arrangement: axis index = dcn_coord * ici_size +
  ici_coord, rank for device id, as the JAX package emulates it."""
  devs = jax.devices()[:8]
  for axes, dcn in (({"batch": 4, "model": 2}, {"batch": 2}),
                    ({"batch": 2, "model": 2, "sp": 2}, {"batch": 2}),
                    ({"batch": 8}, {"batch": 4}), ({"batch": 8}, None)):
    want = jax_sharding.make_hybrid_mesh(axes, dcn_axes=dcn, devices=devs)
    got = sharding.hybrid_rank_array(axes, dcn, range(8))
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got, ids - ids.min())


@pytest.mark.parametrize("axes,dcn,match", [
    ({"batch": 4}, {"batch": 3}, "not divisible"),
    ({"batch": 8}, {"dp": 2}, "not in axis_sizes"),
    ({"batch": 4}, {"batch": 2}, "devices"),
])
def test_hybrid_mesh_refuses_what_jax_refuses(axes, dcn, match):
  ranks = range(4 if "dp" not in dcn and dcn["batch"] == 3 else 8)
  with pytest.raises(ValueError, match=match):
    jax_sharding.make_hybrid_mesh(axes, dcn_axes=dcn,
                                  devices=jax.devices()[:len(ranks)])
  with pytest.raises(ValueError, match=match):
    sharding.hybrid_rank_array(axes, dcn, ranks)


def test_make_mesh_checks_its_size(tmp_path):
  dist.init_process_group("gloo", init_method=f"file://{tmp_path}/r",
                          world_size=1, rank=0)
  try:
    mesh = sharding.make_mesh()
    assert mesh.mesh_dim_names == ("batch",) and mesh.mesh.tolist() == [0]
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
      sharding.make_mesh({"batch": 2})
  finally:
    dist.destroy_process_group()


# ----- tensor parallelism: the plan -----

def _jax_graphcast():
  task = jax_configs.TaskConfig(**workers.GC_TASK)
  model = JaxGraphCast(jax_configs.ModelConfig(**workers.GC_MODEL), task,
                       cache_dir="", fused_aggregation=False)
  data = jax_synthetic.make_example_batch(task, resolution=30.0, batch=2,
                                          num_target_times=1)
  return model, task, data


def _jax_gencast(attention_type="mha", mesh_size=1, **kw):
  st = jax_st.SparseTransformerConfig(
      attention_k_hop=2, d_model=16, num_layers=2, num_heads=2,
      attention_type=attention_type, ffw_hidden=32, block_q=32, block_kv=32)
  return jax_gencast.GenCast(
      task_config=jax_configs.TaskConfig(**workers.GEN_TASK),
      denoiser_architecture_config=jax_denoiser.DenoiserArchitectureConfig(
          sparse_transformer_config=st, mesh_size=mesh_size, latent_size=16,
          hidden_layers=1),
      sampler_config=jax_gencast.SamplerConfig(
          num_noise_levels=workers.NOISE_LEVELS),
      noise_config=jax_gencast.NoiseConfig(),
      noise_encoder_config=jax_denoiser.NoiseEncoderConfig(
          num_frequencies=8, output_sizes=(16, 8)),
      cache_dir="", interpret_attention=True, **kw)


def _jax_specs(jax_params, model_size):
  """{flat key: PartitionSpec tuple} of the JAX package's plan."""
  mesh = jax_sharding.make_mesh({"batch": 8 // model_size,
                                 "model": model_size})
  learned, _ = jax_train.partition_params(jax_params)
  sharded = jax_sharding.shard_params_tensor_parallel(learned, mesh)
  flat = {}

  def walk(node, prefix):
    for k, v in node.items():
      key = f"{prefix}/{k}" if prefix else k
      if isinstance(v, dict):
        walk(v, key)
      else:
        spec = tuple(v.sharding.spec)
        while spec and spec[-1] is None:
          spec = spec[:-1]
        flat[key] = spec

  walk(sharded, "")
  return flat


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("which", ["graphcast", "gencast"])
def test_tensor_parallel_plan_matches_jax_leaf_for_leaf(which, model_size):
  """Column, row or replicated, for every parameter of GraphCast and of
  GenCast (its transformer's ffw and attention projections, its noise
  encoder's MLP), against the PartitionSpecs of the JAX package's
  shard_params_tensor_parallel."""
  if which == "graphcast":
    model, _, (inputs, targets, forcings) = _jax_graphcast()
  else:
    model = _jax_gencast()
    inputs, targets, forcings = jax_synthetic.make_example_batch(
        jax_configs.TaskConfig(**workers.GEN_TASK), resolution=30.0,
        batch=1, num_target_times=1, time_step_hours=12)
  jax_params = model.init(jax.random.PRNGKey(0), inputs, targets, forcings)
  want = _jax_specs(jax_params, model_size)
  shapes = {k: v.shape for k, v in params.params_from_jax(
      jax.tree_util.tree_map(np.asarray, jax_train.partition_params(
          jax_params)[0])).items()}
  got = {k: tuple(s for s in spec) for k, spec in
         sharding.tensor_parallel_plan(shapes, model_size).items()}
  got = {k: v[:-1] if v and v[-1] is None else v for k, v in got.items()}
  assert got == want
  assert any(v == (None, "model") for v in got.values())
  assert any(v == ("model",) for v in got.values())


# ----- data parallelism -----

def test_data_parallel_train_step_matches_jax_batch_sharded_step(tmp_path):
  """Two train steps at global batch 2 over {"batch": 2} (one example per
  rank) against the JAX step with its batch sharded over two devices
  (tests/test_rollout_train.py:86): losses and parameters 5e-4 (+5e-5
  absolute, tests/test_torch_train.py's rule for AdamW); the two ranks'
  parameters bit-equal."""
  jmodel, jtask, data = _jax_graphcast()
  s = jax_synthetic.make_norm_stats(jtask)
  stack = JaxAutoregressive(JaxInputsAndResiduals(
      JaxBfloat16Cast(jmodel, enabled=False), stddev_by_level=s[0],
      mean_by_level=s[1], diffs_stddev_by_level=s[2]))
  optimizer = jax_train.graphcast_optimizer(**workers.OPTIMIZER)
  state = jax_train.init_train_state(stack, optimizer, jax.random.PRNGKey(0),
                                     *data)
  _save_weights(tmp_path, state.params)
  mesh = jax_sharding.make_mesh({"batch": 2}, devices=jax.devices()[:2])
  sharded = jax_sharding.shard_fieldsets(mesh, *data)
  state = jax_sharding.replicate(state, mesh)
  step = jax_train.make_train_step(stack, optimizer, donate=False)
  want_losses = []
  for i in range(2):
    state, loss, _ = step(state, jax.random.PRNGKey(i), *sharded)
    want_losses.append(float(loss))
  learned, _ = jax_train.partition_params(state.params)
  want = params.params_from_jax(jax.tree_util.tree_map(np.asarray, learned))

  _spawn(tmp_path, workers.dp_train, 2, 2)
  ranks = [workers.load(tmp_path, f"dp{r}") for r in range(2)]
  np.testing.assert_allclose(ranks[0]["losses"], want_losses, rtol=TOL)
  for key, w in want.items():
    np.testing.assert_allclose(ranks[0][key], w, rtol=TOL, atol=5e-5,
                               err_msg=key)
    np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)


# ----- tensor parallelism: forward and gradients -----

@pytest.mark.parametrize("axes", [{"batch": 2, "model": 2},
                                  {"batch": 1, "model": 2}])
def test_tensor_parallel_forward_and_grads_match_jax(axes, tmp_path):
  """GraphCast with its MLPs split over "model" (the JAX test's
  tests/test_rollout_train.py:131 layout: one example per rank runs the
  fused path on gathered weights; with "batch" 1, both examples on each
  rank run the general path's split products): the prediction against
  the JAX package's tensor-parallel forward, the loss and every gradient
  shard against the JAX gradient's slice, f32."""
  jmodel, jtask, data = _jax_graphcast()
  s = jax_synthetic.make_norm_stats(jtask)
  stack = JaxAutoregressive(JaxInputsAndResiduals(
      JaxBfloat16Cast(jmodel, enabled=False), stddev_by_level=s[0],
      mean_by_level=s[1], diffs_stddev_by_level=s[2]))
  jparams = stack.init(jax.random.PRNGKey(0), *data)
  learned = _save_weights(tmp_path, jparams)
  mesh = jax_sharding.make_mesh({"batch": 2, "model": 2},
                                devices=jax.devices()[:4])
  params_tp = jax_sharding.shard_params_tensor_parallel(jparams, mesh)
  want_pred = jax.jit(functools.partial(stack, params_tp))(
      jax.random.PRNGKey(0), *jax_sharding.shard_fieldsets(mesh, *data))
  _, statics = jax_train.partition_params(jparams)

  def loss_fn(learned):
    loss, _ = stack.loss({**learned, **statics}, jax.random.PRNGKey(0),
                         *data)
    return jnp.mean(loss)

  want_loss, grads = jax.value_and_grad(loss_fn)(learned)
  want_grads = params.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             grads))

  world = axes["batch"] * axes["model"]
  _spawn(tmp_path, workers.tensor_parallel, world, axes, 2)
  ranks = [workers.load(tmp_path, f"tp{r}") for r in range(world)]
  per = 2 // axes["batch"]
  for r, got in enumerate(ranks):
    b = r // axes["model"]  # the rank's row of the batch axis
    for n in want_pred.var_names:
      np.testing.assert_allclose(
          got[f"pred/{n}"], np.asarray(want_pred.data(n))[b * per:(b + 1)
                                                          * per],
          rtol=TOL, atol=TOL, err_msg=n)
    np.testing.assert_allclose(float(got["loss"]), float(want_loss),
                               rtol=TOL)
  plan = sharding.tensor_parallel_plan(
      {k: v.shape for k, v in want_grads.items()}, axes["model"])
  for key, w in want_grads.items():
    spec = plan[key]
    dim = spec.index("model") if "model" in spec else None
    parts = [ranks[m][f"grad/{key}"] for m in range(axes["model"])]
    got = parts[0] if dim is None else np.concatenate(parts, dim)
    np.testing.assert_allclose(got, w, rtol=TOL, atol=TOL * max(
        np.abs(w).max(), 1e-3), err_msg=key)


# ----- the ensemble -----

def test_sharded_ensemble_matches_jax_on_member_noise(tmp_path,
                                                      monkeypatch):
  """Four GenCast members split over {"batch": 2}, two chunks of one step
  (each rank's carried inputs its own, every chunk's predictions
  gathered) against the JAX
  package's ensemble (tests/test_ensemble.py:84), both sampling on the
  same numpy noise per member (torch_parallel_workers.member_noise); the
  port's sharded and unsharded ensembles agree within 1e-5 (the batch of
  2 and of 4 sum in other orders on the CPU)."""
  members = 4
  jmodel = _jax_gencast()
  inputs, targets, forcings = jax_synthetic.make_example_batch(
      jax_configs.TaskConfig(**workers.GEN_TASK), resolution=30.0, batch=1,
      num_target_times=workers.ENSEMBLE_STEPS, time_step_hours=12)
  one = slice(0, 1)
  jparams = jmodel.init(jax.random.PRNGKey(0), inputs, targets.isel(time=one),
                        forcings.isel(time=one))
  _save_weights(tmp_path, jparams)
  jstack = JaxNaNCleaner(JaxInputsAndResiduals(
      jmodel, *jax_synthetic.make_norm_stats(jax_configs.TaskConfig(
          **workers.GEN_TASK))), var_to_clean="sea_surface_temperature",
                         fill_value=0.0)
  calls = []

  def jax_fake(key, template, basis_arrays=None):
    del key, basis_arrays
    k = len(calls)
    calls.append(k)
    shapes = {n: template[n].shape[1:] for n in template.var_names}
    draws = [workers.member_noise(shapes, k // 2,
                                  "init" if k % 2 == 0 else "churn", m)
             for m in range(members)]
    return jax_fields.FieldSet(
        {n: jax_fields.Field(jnp.asarray(np.stack([d[n] for d in draws]),
                                         template[n].dtype),
                             template[n].dims) for n in template.var_names},
        coords=template.coords)

  monkeypatch.setattr(jax_noise, "spherical_white_noise_like", jax_fake)

  def predictor_fn(rng, inputs, targets_template, forcings):
    calls.clear()
    return jstack(jparams, rng, inputs, targets_template, forcings)

  with jax.disable_jit():
    want = jax_rollout.chunked_ensemble_prediction(
        predictor_fn, jax.random.PRNGKey(0), inputs, targets, forcings,
        num_samples=members)
  _spawn(tmp_path, workers.ensemble, 2, members)
  ranks = [workers.load(tmp_path, f"ens{r}") for r in range(2)]
  for n in targets.var_names:
    w = np.asarray(want.data(n), np.float32)
    got = ranks[0][f"sharded/{n}"]
    assert got.shape == w.shape
    np.testing.assert_array_equal(got, ranks[1][f"sharded/{n}"])
    np.testing.assert_allclose(got, w, rtol=TOL,
                               atol=TOL * np.nanmax(np.abs(w)), err_msg=n)
    np.testing.assert_allclose(got, ranks[0][f"whole/{n}"], rtol=1e-5,
                               atol=1e-5 * np.nanmax(np.abs(w)), err_msg=n)


def test_member_streams_come_from_one_draw_of_the_generator():
  """A member's stream depends on the generator's state and the member's
  global index alone: the same members of a split get the same streams,
  and a second call from the same generator draws other ones."""
  g = torch.Generator().manual_seed(workers.ENSEMBLE_SEED)
  first = [m.initial_seed() for m in rollout.member_generators(g, range(4))]
  second = [m.initial_seed() for m in rollout.member_generators(g, range(4))]
  part = rollout.member_generators(
      torch.Generator().manual_seed(workers.ENSEMBLE_SEED), range(2, 4))
  assert [m.initial_seed() for m in part] == first[2:]
  assert len(set(first)) == 4 and not set(first) & set(second)


# ----- sequence parallelism -----

def test_gencast_sequence_parallel_matches_jax(tmp_path, monkeypatch):
  """GenCast's loss and every gradient with its transformer's nodes split
  over {"sp": 2} (mesh-2: 162 nodes, the second shard's q tiles partly
  padding) against the JAX model with sequence_parallel over two devices
  (tests/test_gencast.py:263), on the same σ and noise, NaN SST."""
  rng = np.random.RandomState(3)
  mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("sp",))
  jmodel = _jax_gencast("splash_mha", mesh_size=2,
                        sequence_parallel=(mesh, "sp"))
  jtask = jax_configs.TaskConfig(**workers.GEN_TASK)
  inputs, targets, forcings = jax_synthetic.make_example_batch(
      jtask, resolution=30.0, batch=1, num_target_times=1,
      time_step_hours=12)
  jparams = jmodel.init(jax.random.PRNGKey(0), inputs, targets, forcings)
  learned, statics = jax_train.partition_params(jparams)
  flat = params.params_from_jax(jax.tree_util.tree_map(np.asarray, learned))
  # Draws for the near-zero-initialised weights (as test_torch_gencast.py
  # does), so that attention and conditioning reach the loss.
  for key in sorted(flat):
    if any(p in key for p in ("norm_conditioning", "mha_final",
                              "ffw_down")):
      fan_in = flat[key.rsplit("/", 1)[0] + "/w"].shape[0]
      flat[key] = (rng.randn(*flat[key].shape) / np.sqrt(fan_in)).astype(
          np.float32)
  workers.save(tmp_path, "weights", **flat)
  sigma = np.array([1.3], np.float32)
  draws = {n: rng.randn(*targets[n].shape).astype(np.float32)
           for n in targets.var_names}
  workers.save(tmp_path, "draws", sigma=sigma, **draws)

  def noise_like(key, template, basis_arrays=None):
    del key, basis_arrays
    return jax_fields.FieldSet(
        {n: jax_fields.Field(jnp.asarray(draws[n], template[n].dtype),
                             template[n].dims) for n in template.var_names},
        coords=template.coords)

  monkeypatch.setattr(jax_noise, "rho_inverse_cdf",
                      lambda **kw: jnp.asarray(sigma, kw["cdf"].dtype))
  monkeypatch.setattr(jax_noise, "spherical_white_noise_like", noise_like)
  sst = np.asarray(inputs.data("sea_surface_temperature")).copy()
  sst[..., :2] = np.nan
  inputs = inputs.replace_data("sea_surface_temperature", sst)
  sst = np.asarray(targets.data("sea_surface_temperature")).copy()
  sst[..., :2] = np.nan
  targets = targets.replace_data("sea_surface_temperature", sst)
  jstack = JaxNaNCleaner(JaxInputsAndResiduals(
      jmodel, *jax_synthetic.make_norm_stats(jtask)),
                         var_to_clean="sea_surface_temperature",
                         fill_value=0.0)

  def loss_fn(flat_params):
    tree = {}
    for k, v in flat_params.items():
      node = tree
      *path, leaf = k.split("/")
      for part in path:
        node = node.setdefault(part, {})
      node[leaf] = v
    loss, _ = jstack.loss(jax_train.merge_params(tree, statics),
                          jax.random.PRNGKey(0), inputs, targets, forcings)
    return jnp.mean(loss)

  want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(
      {k: jnp.asarray(v) for k, v in flat.items()})
  _spawn(tmp_path, workers.sp_gencast, 2, 2)
  ranks = [workers.load(tmp_path, f"sp{r}") for r in range(2)]
  for got in ranks:
    np.testing.assert_allclose(float(got["loss"]), float(want_loss),
                               rtol=TOL)
  for key, w in want.items():
    w = np.asarray(w, np.float32)
    np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)
    np.testing.assert_allclose(ranks[0][key], w, rtol=2e-3,
                               atol=2e-3 * np.abs(w).max(), err_msg=key)


# ----- the dry run -----

@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_runs_one_finite_step(n, tmp_path, capfd):
  """The twin of __graft_entry__.dryrun_multichip on n gloo processes:
  the JAX package's factoring of n and one finite train step (with sp,
  the denoiser's loss and gradients through sequence-parallel
  attention)."""
  axes = graft_entry.mesh_axes(n)
  assert axes == ({"batch": 2, "model": 2} if n == 4 else
                  {"batch": 2, "model": 2, "sp": 2})
  graft_entry.dryrun_multichip(n, init_method=f"file://{tmp_path}/r")
  out = capfd.readouterr().out
  line = [ln for ln in out.splitlines() if ln.startswith("dryrun_multichip")]
  assert len(line) == 1, out
  assert line[0].startswith(
      f"dryrun_multichip({n}): train step OK on mesh (batch=2, model=2")
  loss = float(line[0].split("loss=")[1].split(",")[0])
  assert np.isfinite(loss)
  assert (", sp=2 denoiser loss+grads OK" in line[0]) == (n == 8)


def test_entry_forward_step_runs():
  """The twin of __graft_entry__.entry: a GraphCast forward step at 4°,
  mesh-3, latent 128, on the CPU here (the card by default)."""
  fn, (inputs, targets, forcings) = graft_entry.entry(device="cpu")
  with torch.no_grad():
    out = fn(inputs, targets, forcings)
  assert out.var_names == targets.var_names
  for n in targets.var_names:
    assert out[n].shape == targets[n].shape
    assert torch.isfinite(out.data(n)).all()
