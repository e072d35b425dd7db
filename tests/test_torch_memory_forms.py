"""The port's memory-shaped forms against the same forms of graphcast_tpu,
at tiny sizes (30° grid, mesh-1, latent 16, 4 message-passing steps, f32;
GenCast as in tests/test_torch_gencast.py), on shared weights and inputs.

- The pinned node-chunk plan (geometry/chunking.py) equals the JAX plan,
  field for field.
- GraphCast one step at batches 1 and 2, and its loss with every gradient
  at batch 1, in each form: chunked encode (3 chunks) and decode (4),
  ``fused_aggregation`` False, "processor" and "encoder", the processor
  remat, and the 0.25° training form's combination. Tolerance f32 5e-4.
  ``fused_aggregation`` is named on both sides: the JAX package's None
  means False on the CPU, the port's means True.
- GenCast's denoiser and its loss with every gradient, chunked encode and
  decode with ``fused_aggregation=False`` at batch 2 (a noise level and a
  conditioning per member), at tests/test_torch_gencast.py's tolerances.
- ``Autoregressive`` at 4 steps in each memory form of the loss: against
  the JAX package's same form (5e-4), and bit-equal to the port's
  per-step checkpointed loss and gradients (the forms only move and
  recompute tensors). The JAX validation errors, message for message.
- The geometry artifact's disk cache both ways (either package writes,
  the other reads), "" writes nothing, the environment variable and HOME
  set the default, and the one known difference: an empty variable.

Both packages build the geometry with their default connectivity backend,
which resolves alike in both, and every JAX model gets ``cache_dir=""``: no
run leaves a cache file in the tree.
"""

import functools
import os
import pathlib
import sys
import threading

import torch

# torch.utils.checkpoint imports torch._dynamo at first use, which calls
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

import test_torch_gencast as gencast_case
from graphcast_tpu import train as jax_train
from graphcast_tpu.data import synthetic as jax_synthetic
from graphcast_tpu.geometry import artifact as jax_artifact
from graphcast_tpu.geometry import chunking as jax_chunking
from graphcast_tpu.geometry import icosahedron as jax_icosahedron
from graphcast_tpu.models import configs as jax_configs
from graphcast_tpu.models import denoiser as jax_denoiser
from graphcast_tpu.models import gencast as jax_gencast
from graphcast_tpu.models import sparse_transformer as jax_st
from graphcast_tpu.models.graphcast import GraphCast as JaxGraphCast
from graphcast_tpu.wrappers import Autoregressive as JaxAutoregressive
from graphcast_tpu.wrappers import InputsAndResiduals as JaxInputsAndResiduals
from graphcast_tpu_torch import params
from graphcast_tpu_torch.data import synthetic
from graphcast_tpu_torch.geometry import (
    artifact, chunking, connectivity, icosahedron)
from graphcast_tpu_torch.models import configs, denoiser, gencast
from graphcast_tpu_torch.models import sparse_transformer
from graphcast_tpu_torch.models.graphcast import GraphCast
from graphcast_tpu_torch.nn import remat
from graphcast_tpu_torch.wrappers import Autoregressive, InputsAndResiduals

TOL = 5e-4
TINY_TASK = dict(
    input_variables=("2m_temperature", "temperature",
                     "toa_incident_solar_radiation", "land_sea_mask"),
    target_variables=("2m_temperature", "temperature"),
    forcing_variables=("toa_incident_solar_radiation",),
    pressure_levels=(500, 850),
    input_duration="12h")
TINY_MODEL = dict(resolution=30.0, mesh_size=1, latent_size=16,
                  gnn_msg_steps=4, hidden_layers=1)
# The AR loss tests' model: 2 steps, the processor remat's blocks of one.
AR_MODEL = dict(TINY_MODEL, gnn_msg_steps=2)
# The 0.25° training form (tools/bench_train_025.py:55-83), chunk counts
# cut to the tiny grid.
TRAINING_FORM = dict(fused_aggregation="processor", remat_processor=True,
                     encode_chunks=3, decode_chunks=4)
FORMS = {
    "unfused": dict(fused_aggregation=False),
    "unfused_chunked": dict(fused_aggregation=False, encode_chunks=3,
                            decode_chunks=4),
    "processor": dict(fused_aggregation="processor"),
    "encoder_chunked_decode": dict(fused_aggregation="encoder",
                                   decode_chunks=4),
    "fused_remat": dict(fused_aggregation=True, remat_processor=True),
    "training_form": TRAINING_FORM,
}


# ----- the node-chunk plan -----

def _random_receivers():
  """Sorted receivers over 40 nodes, a third of them without edges."""
  rng = np.random.RandomState(0)
  counts = rng.randint(1, 9, size=40) * (rng.rand(40) > 0.33)
  return np.repeat(np.arange(40), counts).astype(np.int32), 40


def _artifact_receivers():
  lat, lon = synthetic.grid_coords(10.0)
  art = artifact.build_artifact(lat, lon, 2, cache_dir="")
  return art.grid2mesh.receivers, art.num_mesh_nodes


@pytest.mark.parametrize("k", [1, 3, 7, 1000])
@pytest.mark.parametrize("source", [_artifact_receivers, _random_receivers])
def test_chunk_plan_matches_jax(source, k):
  receivers, num_nodes = source()
  got = chunking.plan_balanced_node_chunks(receivers, num_nodes, k)
  want = jax_chunking.plan_balanced_node_chunks(receivers, num_nodes, k)
  for field in ("num_chunks", "num_nodes", "num_edges", "max_nodes",
                "max_edges", "node_bounds", "edge_layout", "local_receivers",
                "node_gather"):
    np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                  err_msg=field)
  # The port's contiguous ranges are the plan's chunks without padding.
  bounds = got.edge_bounds
  for i in range(got.num_chunks):
    lo, hi = got.node_bounds[i], got.node_bounds[i + 1]
    span = slice(bounds[i], bounds[i + 1])
    assert ((receivers[span] >= lo) & (receivers[span] < hi)).all()
    layout = got.edge_layout[i * got.max_edges:(i + 1) * got.max_edges]
    np.testing.assert_array_equal(layout[layout < got.num_edges],
                                  np.arange(bounds[i], bounds[i + 1]))
  assert bounds[-1] == receivers.size


# ----- GraphCast -----

def _graphcast_both(form, batch, num_target_times=1, model_config=None):
  """(JAX model, its params, port model with the same weights, JAX data,
  port data); at batch > 1 the members' inputs differ."""
  model_config = model_config or TINY_MODEL
  task = jax_configs.TaskConfig(**TINY_TASK)
  j_data = jax_synthetic.make_example_batch(
      task, resolution=30.0, batch=batch, num_target_times=num_target_times)
  t_data = synthetic.make_example_batch(
      configs.TaskConfig(**TINY_TASK), resolution=30.0, batch=batch,
      num_target_times=num_target_times, device="cpu")
  if batch > 1:
    rng = np.random.RandomState(7)
    inputs = j_data[0]
    for name in t_data[0].var_names:
      if "batch" in t_data[0][name].dims:
        noisy = np.asarray(inputs.data(name)) + rng.randn(
            *inputs[name].shape).astype(np.float32)
        inputs = inputs.replace_data(name, noisy)
        t_data[0].data(name).copy_(torch.from_numpy(noisy))
    j_data = (inputs,) + tuple(j_data[1:])
  jmodel = JaxGraphCast(jax_configs.ModelConfig(**model_config), task,
                        cache_dir="", **form)
  j1 = [fs.isel(time=slice(0, 1)) if i else fs
        for i, fs in enumerate(j_data)]
  jparams = jmodel.init(jax.random.PRNGKey(0), *j1)
  learned, _ = jax_train.partition_params(jparams)
  model = GraphCast(configs.ModelConfig(**model_config),
                    configs.TaskConfig(**TINY_TASK), **form,
                    generator=torch.Generator().manual_seed(0), device="cpu")
  params.load_params(model, params.params_from_jax(
      jax.tree_util.tree_map(np.asarray, learned)))
  return jmodel, jparams, model, j_data, t_data


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_graphcast_form_matches_jax(form, batch):
  jmodel, jparams, model, j_data, t_data = _graphcast_both(FORMS[form], batch)
  want = jmodel(jparams, None, *j_data)
  with torch.inference_mode():
    got = model(*t_data)
  for name in want.var_names:
    np.testing.assert_allclose(got.data(name).numpy(),
                               np.asarray(want.data(name)), rtol=TOL,
                               atol=TOL, err_msg=name)


def _jax_grads(loss_fn, jparams):
  learned, statics = jax_train.partition_params(jparams)

  def fn(learned):
    return jnp.mean(loss_fn({**learned, **statics}))

  loss, grads = jax.jit(jax.value_and_grad(fn))(learned)
  return float(loss), params.params_from_jax(
      jax.tree_util.tree_map(np.asarray, grads))


def _port_grads(loss_fn, model):
  model.zero_grad(set_to_none=True)
  loss = loss_fn().mean()
  loss.backward()
  return loss.detach(), {
      k: (torch.zeros_like(p) if p.grad is None else p.grad.detach().clone())
      for k, p in params.flat_params(model).items()}


def _assert_grads_close(got: dict, want: dict):
  assert set(got) == set(want)
  for k, w in want.items():
    np.testing.assert_allclose(got[k].numpy(), w, rtol=TOL, atol=TOL,
                               err_msg=k)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_graphcast_form_loss_and_grads_match_jax(form):
  jmodel, jparams, model, j_data, t_data = _graphcast_both(FORMS[form], 1)
  want_loss, want_grads = _jax_grads(
      lambda p: jmodel.loss(p, None, *j_data)[0], jparams)
  loss, grads = _port_grads(lambda: model.loss(*t_data)[0], model)
  np.testing.assert_allclose(float(loss), want_loss, rtol=TOL)
  _assert_grads_close(grads, want_grads)


# ----- GenCast -----

CHUNKED = dict(fused_aggregation=False, encode_chunks=3, decode_chunks=4)


def _jax_gencast(attention_type, fused=True, hidden_layers=1, **form):
  del fused
  tc = gencast_case
  return jax_gencast.GenCast(
      task_config=jax_configs.TaskConfig(**tc.TINY_TASK),
      denoiser_architecture_config=jax_denoiser.DenoiserArchitectureConfig(
          sparse_transformer_config=tc._st(jax_st, attention_type,
                                           block_kv=64),
          mesh_size=1, latent_size=16, hidden_layers=hidden_layers),
      sampler_config=jax_gencast.SamplerConfig(
          num_noise_levels=tc.NOISE_LEVELS),
      noise_config=jax_gencast.NoiseConfig(),
      noise_encoder_config=jax_denoiser.NoiseEncoderConfig(
          num_frequencies=8, output_sizes=(16, 8)),
      cache_dir="", interpret_attention=True, **form)


def _port_gencast(attention_type, seed=0, hidden_layers=1, **form):
  tc = gencast_case
  return gencast.GenCast(
      configs.TaskConfig(**tc.TINY_TASK),
      denoiser.DenoiserArchitectureConfig(
          sparse_transformer_config=tc._st(sparse_transformer,
                                           attention_type),
          mesh_size=1, latent_size=16, hidden_layers=hidden_layers),
      gencast.SamplerConfig(num_noise_levels=tc.NOISE_LEVELS),
      gencast.NoiseConfig(),
      denoiser.NoiseEncoderConfig(num_frequencies=8, output_sizes=(16, 8)),
      generator=torch.Generator().manual_seed(seed), device="cpu", **form)


@pytest.fixture
def chunked_gencast(monkeypatch):
  """tests/test_torch_gencast.py's model constructors, in the chunked form on
  both sides."""
  monkeypatch.setattr(gencast_case, "_jax_model",
                      functools.partial(_jax_gencast, **CHUNKED))
  monkeypatch.setattr(gencast_case, "_port_model",
                      functools.partial(_port_gencast, **CHUNKED))


def test_chunked_denoiser_matches_jax_at_batch_2(chunked_gencast):
  """Two members at their own noise level, so that each chunk's norm
  conditioning differs per member."""
  jmodel, tree, port = gencast_case._shared_weights("mha")
  (j_in, j_tg, j_fc), (t_in, t_tg, t_fc) = gencast_case._batch(2)
  for sigma in (80.0, 0.03):
    levels = np.array([sigma, sigma / 3], np.float32)
    want = jmodel._denoiser.apply(tree, j_in, j_tg, jnp.asarray(levels),
                                  j_fc)
    with torch.inference_mode():
      got = port.denoise(t_in, t_tg, torch.from_numpy(levels), t_fc)
    for name in want.var_names:
      gencast_case._assert_close(got.data(name).numpy(), want.data(name))
  assert port.architecture._g2m_plan.num_chunks == 3


def test_chunked_gencast_loss_and_grads_match_jax_at_batch_2(
    chunked_gencast, monkeypatch):
  gencast_case._check_loss_and_grads("mha", monkeypatch, batch=2)


def test_gencast_preset_passes_execution_keywords_through():
  """As the JAX preset's ``build`` (zoo.py:84-96 there); the preset here
  is the released architecture cut to the tiny sizes."""
  from graphcast_tpu_torch.models import zoo
  preset = zoo.gencast_custom(30.0, 1, d_model=16, num_layers=1,
                              num_heads=2, latent_size=16)
  model = preset.build(generator=torch.Generator().manual_seed(0),
                       device="cpu", **CHUNKED, cache_dir="")
  arch = model.architecture
  assert (arch._encode_chunks, arch._decode_chunks, arch._fused,
          arch._cache_dir) == (3, 4, False, "")
  with pytest.raises(NotImplementedError, match="interpret_attention"):
    preset.build(generator=torch.Generator(), device="cpu",
                 interpret_attention=True)


# ----- Autoregressive -----

AR_FORMS = {
    "block_2": ({}, dict(loss_scan_block=2)),
    "block_4": ({}, dict(loss_scan_block=4)),
    "carry_offload_block_1": ({}, dict(loss_carry_offload=True)),
    "carry_offload_block_2": ({}, dict(loss_carry_offload=True,
                                       loss_scan_block=2)),
    "carry_offload_block_4": ({}, dict(loss_carry_offload=True,
                                       loss_scan_block=4)),
    "processor_offload": (dict(remat_processor=True),
                          dict(loss_offload_processor_carries=True)),
    "unroll_2": ({}, dict(loss_scan_unroll=2)),
}
AR_STEPS = 4


def _ar_stacks(model_form, loss_form):
  model_form = dict(fused_aggregation=False, **model_form)
  jmodel, jparams, model, j_data, t_data = _graphcast_both(
      model_form, 1, num_target_times=AR_STEPS, model_config=AR_MODEL)
  jstack = JaxAutoregressive(
      JaxInputsAndResiduals(jmodel, *jax_synthetic.make_norm_stats(
          jax_configs.TaskConfig(**TINY_TASK))),
      gradient_checkpointing=True, **loss_form)
  stats = synthetic.make_norm_stats(configs.TaskConfig(**TINY_TASK),
                                    device="cpu")
  inner = InputsAndResiduals(model, *stats)
  return (jstack, jparams, j_data, Autoregressive(
      inner, gradient_checkpointing=True, **loss_form),
          Autoregressive(inner, gradient_checkpointing=True), model, t_data)


@pytest.mark.parametrize("form", sorted(AR_FORMS))
def test_ar_loss_form_matches_jax_and_per_step_checkpoints(form):
  jstack, jparams, j_data, stack, per_step, model, t_data = _ar_stacks(
      *AR_FORMS[form])
  want_loss, want_grads = _jax_grads(
      lambda p: jstack.loss(p, jax.random.PRNGKey(0), *j_data)[0], jparams)
  loss, grads = _port_grads(lambda: stack.loss(*t_data)[0], model)
  np.testing.assert_allclose(float(loss), want_loss, rtol=TOL)
  _assert_grads_close(grads, want_grads)
  ref_loss, ref_grads = _port_grads(lambda: per_step.loss(*t_data)[0], model)
  assert torch.equal(loss, ref_loss)
  for k, g in ref_grads.items():
    assert torch.equal(grads[k], g), k


def test_carry_offload_saves_exactly_the_windows(monkeypatch):
  """With the carry offload, what goes to the host is the carried windows
  (one tensor per time-dependent input a window) and nothing else; the
  processor offload adds the processor's block boundaries (x and e) of
  each step (one boundary in AR_MODEL's two steps), in the forward and
  again in its recompute."""
  packed = []
  pack = remat._pack
  monkeypatch.setattr(remat, "_pack", lambda t: packed.append(
      tuple(t.shape)) or pack(t))
  data = synthetic.make_example_batch(
      configs.TaskConfig(**TINY_TASK), resolution=30.0,
      num_target_times=AR_STEPS, device="cpu")
  window = [f.shape for n, f in data[0].items() if "time" in f.dims]
  stats = synthetic.make_norm_stats(configs.TaskConfig(**TINY_TASK),
                                    device="cpu")
  for model_form, loss_form, expected in [
      ({}, dict(loss_carry_offload=True), AR_STEPS * len(window)),
      ({}, dict(loss_carry_offload=True, loss_scan_block=2),
       (AR_STEPS // 2) * len(window)),
      (dict(remat_processor=True), dict(loss_offload_processor_carries=True),
       2 * AR_STEPS * 2)]:
    model = GraphCast(configs.ModelConfig(**AR_MODEL),
                      configs.TaskConfig(**TINY_TASK), **model_form,
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    stack = Autoregressive(InputsAndResiduals(model, *stats),
                           gradient_checkpointing=True, **loss_form)
    packed.clear()
    stack.loss(*data)[0].mean().backward()
    assert len(packed) == expected, (loss_form, packed)


def _validation_cases():
  ok = dict(gradient_checkpointing=True)
  return {
      "block_below_1": (dict(ok, loss_scan_block=0), None),
      "block_without_checkpointing": (dict(loss_scan_block=2), None),
      "carry_offload_without_checkpointing": (
          dict(loss_carry_offload=True), None),
      "processor_offload_without_checkpointing": (
          dict(loss_offload_processor_carries=True), None),
      "block_not_dividing_steps": (dict(ok, loss_scan_block=3), 4),
      "processor_offload_on_one_step": (
          dict(ok, loss_offload_processor_carries=True), 1),
  }


@pytest.mark.parametrize("case", sorted(_validation_cases()))
def test_ar_validation_errors_match_jax(case):
  kwargs, steps = _validation_cases()[case]
  messages = []
  task = configs.TaskConfig(**TINY_TASK)
  jtask = jax_configs.TaskConfig(**TINY_TASK)
  model = GraphCast(configs.ModelConfig(**TINY_MODEL), task,
                    generator=torch.Generator().manual_seed(0), device="cpu")
  jmodel = JaxGraphCast(jax_configs.ModelConfig(**TINY_MODEL), jtask,
                        cache_dir="", fused_aggregation=False)
  for build, data, run in [
      (lambda: Autoregressive(model, **kwargs),
       lambda: synthetic.make_example_batch(
           task, 30.0, num_target_times=steps, device="cpu"),
       lambda stack, data: stack.loss(*data)),
      (lambda: JaxAutoregressive(jmodel, **kwargs),
       lambda: jax_synthetic.make_example_batch(
           jtask, 30.0, num_target_times=steps),
       lambda stack, data: stack.loss(
           jmodel.init(jax.random.PRNGKey(0), data[0],
                       data[1].isel(time=slice(0, 1)),
                       data[2].isel(time=slice(0, 1))),
           jax.random.PRNGKey(0), *data))]:
    with pytest.raises(ValueError) as error:
      stack = build()
      run(stack, data())
    messages.append(str(error.value))
  assert messages[0] == messages[1]


# ----- the artifact disk cache -----

ARGS = dict(mesh_size=1, radius_query_fraction_edge_length=0.6)


def _coords():
  return synthetic.grid_coords(30.0)


def _assert_artifacts_equal(a, b):
  for field in ("mesh_vertices", "mesh_faces", "mesh_nodes_lat",
                "mesh_nodes_lon", "grid_nodes_lat", "grid_nodes_lon",
                "grid_node_features", "mesh_node_features"):
    np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
  for name in ("grid2mesh", "mesh", "mesh2grid"):
    for part in ("senders", "receivers", "features"):
      np.testing.assert_array_equal(getattr(getattr(a, name), part),
                                    getattr(getattr(b, name), part))


def _no_build(monkeypatch, module):
  def refuse(*args, **kwargs):
    raise AssertionError("built instead of read from the cache")
  monkeypatch.setattr(module, "get_mesh_hierarchy", refuse)


@pytest.mark.parametrize("multimesh", [True, False])
def test_cache_written_by_jax_serves_the_port(tmp_path, monkeypatch,
                                              multimesh):
  lat, lon = _coords()
  kw = dict(ARGS, multimesh=multimesh, permute_banded=not multimesh,
            banded_patch_size=None if multimesh else 64)
  want = jax_artifact.build_artifact(lat, lon, cache_dir=str(tmp_path), **kw)
  files = sorted(tmp_path.iterdir())
  assert len(files) == 1 and files[0].name.startswith("artifact_")
  _no_build(monkeypatch, icosahedron)
  got = artifact.build_artifact(lat, lon, cache_dir=str(tmp_path), **kw)
  _assert_artifacts_equal(got, want)
  assert sorted(tmp_path.iterdir()) == files


@pytest.mark.parametrize("multimesh", [True, False])
def test_cache_written_by_the_port_serves_jax(tmp_path, monkeypatch,
                                              multimesh):
  lat, lon = _coords()
  kw = dict(ARGS, multimesh=multimesh, permute_banded=not multimesh,
            banded_patch_size=None if multimesh else 64)
  want = artifact.build_artifact(lat, lon, cache_dir=str(tmp_path), **kw)
  files = sorted(tmp_path.iterdir())
  assert len(files) == 1 and files[0].name.startswith("artifact_")
  _no_build(monkeypatch, jax_icosahedron)
  got = jax_artifact.build_artifact(lat, lon, cache_dir=str(tmp_path), **kw)
  _assert_artifacts_equal(got, want)


def test_cache_writes_through_a_file_of_its_own(tmp_path, monkeypatch):
  """Processes that build one artifact at once (the ranks of a job) each
  write their own temporary file and rename it into place."""
  written = []
  save = artifact.np.savez_compressed

  def record(file, **arrays):
    written.append(pathlib.Path(file).name)
    save(file, **arrays)

  monkeypatch.setattr(artifact.np, "savez_compressed", record)
  artifact.build_artifact(*_coords(), cache_dir=str(tmp_path), **ARGS)
  assert len(written) == 1 and written[0].endswith(".tmp.npz")
  assert f".{os.getpid()}.{threading.get_ident()}." in written[0]
  files = [p.name for p in tmp_path.iterdir()]
  assert len(files) == 1 and files[0].startswith("artifact_")
  assert not files[0].endswith(".tmp.npz")


def test_empty_cache_dir_writes_nothing(tmp_path, monkeypatch):
  monkeypatch.chdir(tmp_path)
  monkeypatch.setenv("HOME", str(tmp_path))
  monkeypatch.delenv(artifact.CACHE_ENV, raising=False)
  artifact.build_artifact(*_coords(), cache_dir="", **ARGS)
  assert not list(tmp_path.rglob("*"))


def test_cache_default_is_the_variable_else_home(tmp_path, monkeypatch):
  lat, lon = _coords()
  monkeypatch.setenv("HOME", str(tmp_path / "home"))
  monkeypatch.setenv(artifact.CACHE_ENV, str(tmp_path / "env"))
  artifact.build_artifact(lat, lon, **ARGS)
  assert len(list((tmp_path / "env").glob("artifact_*.npz"))) == 1
  monkeypatch.delenv(artifact.CACHE_ENV)
  artifact.build_artifact(lat, lon, **ARGS)
  home = tmp_path / "home" / ".cache" / "graphcast_tpu"
  assert [p.name for p in home.iterdir()] == [
      p.name for p in (tmp_path / "env").iterdir()]


def test_empty_cache_variable_is_a_known_difference(tmp_path, monkeypatch):
  """An empty GRAPHCAST_TPU_CACHE (tests/conftest.py sets one) disables the
  port's cache; the JAX package reads it as the current directory
  (artifact.py:335-346 there). ROADMAP Queue 3 records the difference."""
  monkeypatch.chdir(tmp_path)
  monkeypatch.setenv(artifact.CACHE_ENV, "")
  lat, lon = _coords()
  artifact.build_artifact(lat, lon, **ARGS)
  assert not list(tmp_path.iterdir())
  jax_artifact.build_artifact(lat, lon, **ARGS)
  assert [p.name for p in tmp_path.iterdir()][0].startswith("artifact_")


def test_models_take_their_cache_dir(tmp_path):
  """A model's ``cache_dir`` reaches the disk cache; the in-process cache
  in front of it shares one artifact between models whatever their
  ``cache_dir``."""
  model = GraphCast(configs.ModelConfig(**TINY_MODEL),
                    configs.TaskConfig(**TINY_TASK), cache_dir=str(tmp_path),
                    generator=torch.Generator().manual_seed(0), device="cpu")
  data = synthetic.make_example_batch(configs.TaskConfig(**TINY_TASK), 30.0,
                                      device="cpu")
  other = GraphCast(configs.ModelConfig(**TINY_MODEL),
                    configs.TaskConfig(**TINY_TASK), cache_dir="",
                    generator=torch.Generator().manual_seed(0), device="cpu")
  lat, lon = (np.asarray(data[0].coords[c], np.float32) for c in ("lat",
                                                                   "lon"))
  artifact._ARTIFACTS.clear()
  with torch.inference_mode():
    model(*data)
    other(*data)
  assert len(list(tmp_path.glob("artifact_*.npz"))) == 1
  assert model._artifact is other._artifact
  assert os.path.exists(artifact._cache_path(
      str(tmp_path), lat, lon, 1, 0.6, None,
      (True, False, False, connectivity.resolve_backend())))
