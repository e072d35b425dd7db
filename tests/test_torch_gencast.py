"""The port's GenCast (models/gencast.py, models/denoiser.py, diffusion/,
ops/sht.py, wrappers/nan_cleaning.py) against the JAX package's, at tiny
sizes: mesh 1, latent 16, d_model 16, 2 layers, 2 heads, k-hop 2, 4 noise
levels, a 30° grid.

Weights are the JAX package's init carried into the port by
``params_from_jax``, after the near-zero-initialised ones (every norm
conditioning, ``mha_final``, ``ffw_down``) are overwritten with seeded draws
of stddev 1/sqrt(fan_in) in both packages: otherwise attention and the
noise conditioning would vanish from the outputs and the comparisons would
check neither. The JAX denoiser runs with ``fused_aggregation=True``
(Pallas interpret mode), as tests/test_gencast.py runs it: its batch-1
kernel path, and at batch 2 its general path (K3's counterpart
``BlockedSegmentSum`` where the grid2mesh layout allows it), against the
port's general path with a noise level per member.

The whole-sample test feeds both samplers the same numpy noise: it replaces
``spherical_white_noise_like`` in both packages by draws keyed by (noise
level, initial or churn) and runs the JAX sampler under
``jax.disable_jit()`` so that its ``fori_loop`` is a Python loop.

Both packages build the geometry with the numpy connectivity backend (the
port has no other; the JAX package's native one breaks ties at grid points
on mesh edges differently), so the JAX side's ``build_artifact`` is pinned
to it here.

Tolerance: f32 5e-4 relative to each output's largest element, the port's
standing f32 bound (summation order only); the sample, after 7 denoiser
evaluations on the same noise, too.

Training: ``NaNCleaner(InputsAndResiduals(GenCast)).loss`` with NaNs in SST,
on the same σ and noise in both packages (``rho_inverse_cdf`` and
``spherical_white_noise_like`` replaced by fixed numpy draws), against the
JAX loss with its batch-1 fused backward (the custom VJPs of K4 and K5 in
embed mode and of K7/K8, Pallas interpret mode): loss and diagnostics f32
5e-4, every parameter gradient 2e-3 plus 2e-3 of its largest element, as
tests/test_gencast.py:236-238 holds the JAX fused backward to its plain
path.
"""

import dataclasses
import functools
import json
import pathlib
import sys

import torch

# torch.optim imports torch._dynamo at first use, which calls
# importlib.util.find_spec on optional packages and raises on a module
# without __spec__, such as the fake ``xarray`` that tests/fake_xarray.py
# installs for other test files. Import it now, with any such module set
# aside.
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

from graphcast_tpu import fields as jax_fields
from graphcast_tpu.data import synthetic as jax_synthetic
from graphcast_tpu.diffusion import noise as jax_noise
from graphcast_tpu.geometry import artifact as jax_artifact
from graphcast_tpu.models import configs as jax_configs
from graphcast_tpu.models import denoiser as jax_denoiser
from graphcast_tpu.models import gencast as jax_gencast
from graphcast_tpu.models import sparse_transformer as jax_st
from graphcast_tpu.nn import core as jax_core
from graphcast_tpu.ops import sht as jax_sht
from graphcast_tpu.wrappers import InputsAndResiduals as JaxInputsAndResiduals
from graphcast_tpu.wrappers import NaNCleaner as JaxNaNCleaner
from graphcast_tpu_torch import params, train
from graphcast_tpu_torch.data import synthetic
from graphcast_tpu_torch.diffusion import noise
from graphcast_tpu_torch.models import configs, denoiser, gencast, zoo
from graphcast_tpu_torch.models import sparse_transformer
from graphcast_tpu_torch.nn import core
from graphcast_tpu_torch.ops import sht
from graphcast_tpu_torch.wrappers import InputsAndResiduals, NaNCleaner

TINY_TASK = dict(
    input_variables=("2m_temperature", "temperature",
                     "sea_surface_temperature", "day_progress_sin",
                     "land_sea_mask"),
    target_variables=("2m_temperature", "temperature",
                      "sea_surface_temperature"),
    forcing_variables=("day_progress_sin",),
    pressure_levels=(500, 850),
    input_duration="24h")
NOISE_LEVELS = 4
GOLDENS = pathlib.Path(__file__).parent / "goldens" / "zoo_param_shapes.json"
_DEGENERATE = ("norm_conditioning", "mha_final", "ffw_down")


@pytest.fixture(autouse=True)
def numpy_geometry(monkeypatch):
  monkeypatch.setattr(jax_artifact, "build_artifact", functools.partial(
      jax_artifact.build_artifact, backend="numpy"))


def _st(mod, attention_type, **tiling):
  return mod.SparseTransformerConfig(
      attention_k_hop=2, d_model=16, num_layers=2, num_heads=2,
      attention_type=attention_type, ffw_hidden=32, block_q=64, **tiling)


def _jax_model(attention_type, fused=True):
  return jax_gencast.GenCast(
      task_config=jax_configs.TaskConfig(**TINY_TASK),
      denoiser_architecture_config=jax_denoiser.DenoiserArchitectureConfig(
          sparse_transformer_config=_st(jax_st, attention_type, block_kv=64),
          mesh_size=1, latent_size=16, hidden_layers=1),
      sampler_config=jax_gencast.SamplerConfig(
          num_noise_levels=NOISE_LEVELS),
      noise_config=jax_gencast.NoiseConfig(),
      noise_encoder_config=jax_denoiser.NoiseEncoderConfig(
          num_frequencies=8, output_sizes=(16, 8)),
      cache_dir="", interpret_attention=True, fused_aggregation=fused)


def _port_model(attention_type, seed=0):
  return gencast.GenCast(
      configs.TaskConfig(**TINY_TASK),
      denoiser.DenoiserArchitectureConfig(
          sparse_transformer_config=_st(sparse_transformer, attention_type),
          mesh_size=1, latent_size=16, hidden_layers=1),
      gencast.SamplerConfig(num_noise_levels=NOISE_LEVELS),
      gencast.NoiseConfig(),
      denoiser.NoiseEncoderConfig(num_frequencies=8, output_sizes=(16, 8)),
      generator=torch.Generator().manual_seed(seed), device="cpu")


def _nondegenerate(flat: dict, seed: int) -> dict:
  rng = np.random.RandomState(seed)
  out = dict(flat)
  for key in sorted(flat):
    if any(part in key for part in _DEGENERATE):
      w = flat[key.rsplit("/", 1)[0] + "/w"]
      out[key] = (rng.randn(*flat[key].shape)
                  / np.sqrt(w.shape[0])).astype(np.float32)
  return out


def _nest(flat: dict) -> dict:
  tree: dict = {}
  for key, v in flat.items():
    node = tree
    *path, leaf = key.split("/")
    for part in path:
      node = node.setdefault(part, {})
    node[leaf] = jnp.asarray(v)
  return tree


def _batch(batch=1):
  task = jax_configs.TaskConfig(**TINY_TASK)
  j = jax_synthetic.make_example_batch(task, resolution=30.0, batch=batch,
                                       num_target_times=1,
                                       time_step_hours=12)
  t = synthetic.make_example_batch(configs.TaskConfig(**TINY_TASK), 30.0,
                                   batch=batch, num_target_times=1,
                                   time_step_hours=12, device="cpu")
  return j, t


def _shared_weights(attention_type, seed=1):
  """(JAX model, its params with the shared weights, port model loaded with
  the same weights)."""
  jmodel = _jax_model(attention_type)
  (j_in, j_tg, j_fc), _ = _batch()
  jparams = jmodel.init(jax.random.PRNGKey(0), j_in, j_tg, j_fc)
  flat = _nondegenerate(params.params_from_jax(
      jax.tree_util.tree_map(np.asarray, jparams)), seed)
  tree = _nest(flat)
  tree["architecture"]["graph_statics"] = jparams["architecture"][
      "graph_statics"]
  tree["noise_statics"] = jparams["noise_statics"]
  port = _port_model(attention_type)
  params.load_params(port, flat)
  return jmodel, tree, port


def _assert_close(got, want):
  got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, rtol=5e-4,
                             atol=5e-4 * np.nanmax(np.abs(want)))


def test_fourier_features_mlp_matches_jax():
  cfg = dict(num_frequencies=8, output_sizes=(16, 8))
  jenc = jax_denoiser.FourierFeaturesMLP(
      jax_denoiser.NoiseEncoderConfig(**cfg))
  jp = jenc.init(jax.random.PRNGKey(0))
  enc = denoiser.FourierFeaturesMLP(denoiser.NoiseEncoderConfig(**cfg))
  params.load_params(enc, params.params_from_jax(
      jax.tree_util.tree_map(np.asarray, jp)))
  sigma = np.array([0.03, 0.5, 1.0, 80.0], np.float32)
  want = jenc.apply(jp, jnp.asarray(sigma))
  with torch.inference_mode():
    got = enc(torch.from_numpy(sigma))
  _assert_close(got.numpy(), want)


def test_conditioned_mlp_with_norm_matches_jax():
  spec = jax_core.MLPWithNorm(in_size=12, hidden_size=32,
                              num_hidden_layers=1, out_size=24,
                              use_norm_conditioning=True,
                              norm_conditioning_size=6)
  flat = _nondegenerate(params.params_from_jax(jax.tree_util.tree_map(
      np.asarray, spec.init(jax.random.PRNGKey(1)))), seed=2)
  rng = np.random.RandomState(3)
  x = rng.randn(10, 1, 12).astype(np.float32)
  cond = rng.randn(1, 1, 6).astype(np.float32)
  want = spec.apply(_nest(flat), jnp.asarray(x),
                    global_norm_conditioning=jnp.asarray(cond))
  mlp = core.MLPWithNorm(12, 32, 1, 24, norm_conditioning_size=6)
  params.load_params(mlp, flat)
  with torch.inference_mode():
    got = mlp(torch.from_numpy(x), cond=torch.from_numpy(cond))
  assert sorted(params.flat_params(mlp)) == sorted(flat)
  _assert_close(got.numpy(), want)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("attention_type", ["mha", "splash_mha"])
def test_denoiser_matches_jax(attention_type, batch):
  """One denoiser evaluation at three noise levels: batch 1 (the fused
  path) and batch 2 (the general path, K3's plain version, a noise level
  per member)."""
  jmodel, tree, port = _shared_weights(attention_type)
  (j_in, j_tg, j_fc), (t_in, t_tg, t_fc) = _batch(batch)
  jden = jmodel._denoiser
  for sigma in (80.0, 1.0, 0.03):
    levels = np.array([sigma, sigma / 3][:batch], np.float32)
    want = jden.apply(tree, j_in, j_tg, jnp.asarray(levels), j_fc)
    with torch.inference_mode():
      got = port.denoise(t_in, t_tg, torch.from_numpy(levels), t_fc)
    assert got.var_names == want.var_names
    for name in want.var_names:
      _assert_close(got.data(name).numpy(), want.data(name))


def test_preconditioning_identities():
  sigma = torch.tensor([1e-4], dtype=torch.float64)
  assert abs(float(gencast.GenCast._c_skip(sigma)[0]) - 1.0) < 1e-6
  assert abs(float(gencast.GenCast._c_out(sigma)[0]) - 1e-4) < 1e-7
  assert abs(float(gencast.GenCast._c_in(sigma)[0]) - 1.0) < 1e-6
  sigma = torch.tensor([80.0], dtype=torch.float64)
  assert abs(float(gencast.GenCast._c_in(sigma)[0]) * 80.0 - 1.0) < 1e-3
  for s in (0.03, 1.0, 80.0):
    s = torch.tensor(s, dtype=torch.float64)
    # c_skip + c_out·σ = 1: D(x) = x for F = x / σ ... the EDM identity.
    want = jax_gencast.GenCast
    for fn in ("_c_in", "_c_out", "_c_skip"):
      assert abs(float(getattr(gencast.GenCast, fn)(s))
                 - float(getattr(want, fn)(float(s)))) < 1e-12
    assert abs(float(gencast.GenCast._c_skip(s)
                     + gencast.GenCast._c_out(s) ** 2) - 1.0) < 1e-12


def test_schedules_match_jax():
  for args in ((80.0, 0.03, 20, 7.0), (80.0, 0.002, 30, 7.0)):
    np.testing.assert_allclose(noise.noise_schedule(*args),
                               jax_noise.noise_schedule(*args), rtol=1e-12)
  levels = jax_noise.noise_schedule(80.0, 0.03, 20, 7.0)
  np.testing.assert_array_equal(
      noise.stochastic_churn_rate_schedule(levels, 2.5, 0.75, np.inf),
      jax_noise.stochastic_churn_rate_schedule(levels, 2.5, 0.75, np.inf))


def test_synthesis_matches_jax():
  lat, lon = synthetic.grid_coords(10.0)
  max_l = lon.shape[0] // 2
  rng = np.random.RandomState(4)
  cos_c = rng.randn(3, max_l, max_l).astype(np.float32)
  sin_c = rng.randn(3, max_l, max_l).astype(np.float32)
  want = jax_sht.synthesize_with(
      jax_sht.get_basis(lat, lon, max_l).arrays(), jnp.asarray(cos_c),
      jnp.asarray(sin_c))
  basis = sht.SphericalHarmonicBasis(lat, lon, max_l)
  np.testing.assert_allclose(
      basis.legendre, jax_sht.get_basis(lat, lon, max_l).legendre)
  got = sht.synthesize_with(basis.tensors("cpu"), torch.from_numpy(cos_c),
                            torch.from_numpy(sin_c))
  _assert_close(got.numpy(), want)


def test_white_noise_has_unit_marginal_variance():
  lat, lon = synthetic.grid_coords(30.0)
  template = synthetic.make_example_batch(
      configs.TaskConfig(**TINY_TASK), 30.0, batch=1, device="cpu")[1]
  template = template.select(["2m_temperature"]).map_data(
      lambda x: x.expand(4000, *x.shape[1:]))
  basis = noise.white_noise_basis(lat, lon).tensors("cpu")
  out = noise.spherical_white_noise_like(torch.Generator().manual_seed(0),
                                         template, basis)
  x = out.data("2m_temperature").double()
  assert x.shape == (4000, 1, lat.shape[0], lon.shape[0])
  var = x.var(dim=0)
  assert abs(float(var.mean()) - 1.0) < 0.03
  assert float((var - 1.0).abs().max()) < 0.15


class _NumpyNoise:
  """Seeded numpy noise for both samplers, keyed by (level, kind)."""

  def __init__(self, shapes: dict):
    self.shapes = shapes

  def draw(self, level, kind):
    rng = np.random.RandomState(100 * level + (kind == "churn"))
    return {n: rng.randn(*s).astype(np.float32)
            for n, s in sorted(self.shapes.items())}


def _sample_both(monkeypatch, inputs_nan=False, batch=1):
  jmodel, tree, port = _shared_weights("mha")
  jtask = jax_configs.TaskConfig(**TINY_TASK)
  task = configs.TaskConfig(**TINY_TASK)
  (j_in, j_tg, j_fc), (t_in, t_tg, t_fc) = _batch(batch)
  if inputs_nan:
    sst = np.asarray(j_in.data("sea_surface_temperature")).copy()
    sst[..., :2] = np.nan
    j_in = j_in.replace_data("sea_surface_temperature", sst)
    t_in.data("sea_surface_temperature")[..., :2] = float("nan")
  shapes = {n: tuple(j_tg[n].shape) for n in j_tg.var_names}
  table = _NumpyNoise(shapes)
  jax_calls = []

  def jax_fake(key, template, basis_arrays=None):
    del key, basis_arrays
    k = len(jax_calls)
    jax_calls.append(k)
    draws = table.draw(k // 2, "init" if k % 2 == 0 else "churn")
    return jax_fields.FieldSet(
        {n: jax_fields.Field(jnp.asarray(draws[n], template[n].dtype),
                             template[n].dims) for n in template.var_names},
        coords=template.coords)

  levels = noise.noise_schedule(80.0, 0.03, NOISE_LEVELS, 7.0)
  rates = noise.stochastic_churn_rate_schedule(levels, 2.5, 0.75, np.inf)
  port_keys = [(0, "init")] + [(i, "churn") for i in range(NOISE_LEVELS)
                               if rates[i] > 0]
  port_calls = []

  def port_fake(generator, template, basis):
    del generator, basis
    draws = table.draw(*port_keys[len(port_calls)])
    port_calls.append(1)
    return jax_fields_to_port(draws, template)

  def jax_fields_to_port(draws, template):
    from graphcast_tpu_torch.fields import Field, FieldSet
    return FieldSet({n: Field(torch.from_numpy(draws[n]).to(
        template[n].dtype), template[n].dims) for n in template.var_names},
        coords=template.coords)

  monkeypatch.setattr(jax_noise, "spherical_white_noise_like", jax_fake)
  monkeypatch.setattr(noise, "spherical_white_noise_like", port_fake)
  j_stats = jax_synthetic.make_norm_stats(jtask)
  t_stats = synthetic.make_norm_stats(task, device="cpu")
  jstack = JaxNaNCleaner(JaxInputsAndResiduals(jmodel, *j_stats),
                         var_to_clean="sea_surface_temperature",
                         fill_value=0.0)
  stack = NaNCleaner(InputsAndResiduals(port, *t_stats),
                     var_to_clean="sea_surface_temperature", fill_value=0.0)
  with jax.disable_jit():
    want = jstack(tree, jax.random.PRNGKey(0), j_in, j_tg, j_fc)
  with torch.inference_mode():
    got = stack(t_in, t_tg, t_fc, generator=torch.Generator())
  assert len(jax_calls) == 2 * NOISE_LEVELS
  assert len(port_calls) == len(port_keys)
  return got, want


@pytest.mark.parametrize("batch", [1, 2])
def test_sample_matches_jax(monkeypatch, batch):
  """The whole sample on shared numpy noise; at batch 2 every member draws
  its own noise and runs the general path."""
  got, want = _sample_both(monkeypatch, batch=batch)
  assert got.var_names == want.var_names
  for name in want.var_names:
    assert np.isfinite(np.asarray(want.data(name))).all()
    _assert_close(got.data(name).numpy(), want.data(name))
  if batch > 1:
    t = got.data("temperature")
    assert not torch.allclose(t[0], t[1])


@pytest.mark.parametrize("batch", [1, 2])
def test_nans_in_sst_come_back(monkeypatch, batch):
  got, want = _sample_both(monkeypatch, inputs_nan=True, batch=batch)
  sst = got.data("sea_surface_temperature").numpy()
  assert np.isnan(sst[..., :2]).all() and np.isfinite(sst[..., 2:]).all()
  for name in want.var_names:
    _assert_close(got.data(name).numpy(), want.data(name))


def test_two_generators_give_different_samples():
  port = _port_model("mha")
  _, (t_in, t_tg, t_fc) = _batch()
  with torch.inference_mode():
    a = port(t_in, t_tg, t_fc, generator=torch.Generator().manual_seed(1))
    b = port(t_in, t_tg, t_fc, generator=torch.Generator().manual_seed(2))
    c = port(t_in, t_tg, t_fc, generator=torch.Generator().manual_seed(1))
  assert not torch.allclose(a.data("temperature"), b.data("temperature"))
  assert torch.equal(a.data("temperature"), c.data("temperature"))


@pytest.mark.parametrize("name", sorted(zoo.GENCAST_PRESETS))
def test_param_keys_and_shapes_match_golden(name):
  with open(GOLDENS) as f:
    golden = json.load(f)[name]
  model = zoo.GENCAST_PRESETS[name]().build(
      generator=torch.Generator().manual_seed(0), device="cpu")
  shapes = {k: list(p.shape) for k, p in params.flat_params(model).items()}
  assert shapes == golden


def test_params_from_jax_carries_a_gencast_tree():
  jmodel = _jax_model("mha")
  (j_in, j_tg, j_fc), _ = _batch()
  jparams = jmodel.init(jax.random.PRNGKey(0), j_in, j_tg, j_fc)
  flat = params.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
  assert not any("statics" in k for k in flat)
  port = _port_model("mha", seed=5)
  params.load_params(port, flat)
  back = params.params_to_jax(port)
  assert back.keys() == {"noise_encoder", "architecture"}
  for key, p in params.flat_params(port).items():
    np.testing.assert_array_equal(p.detach().numpy(), flat[key])


def test_unported_forms_raise():
  port = _port_model("mha")
  _, (t_in, t_tg, t_fc) = _batch()
  two = synthetic.make_example_batch(configs.TaskConfig(**TINY_TASK), 30.0,
                                     batch=1, num_target_times=2,
                                     time_step_hours=12, device="cpu")
  with pytest.raises(ValueError, match="one target step"):
    port(two[0], two[1], two[2], generator=torch.Generator())
  with pytest.raises(ValueError, match="generator"):
    port(t_in, t_tg, t_fc)
  bad = dataclasses.replace(_st(sparse_transformer, "mha"),
                            node_ordering="spiral")
  with pytest.raises(ValueError, match="node_ordering"):
    denoiser.DenoiserArchitecture(
        denoiser.DenoiserArchitectureConfig(
            sparse_transformer_config=bad, mesh_size=1, latent_size=16,
            node_output_size=5), configs.TaskConfig(**TINY_TASK), 8)


def _stacks(jmodel, port):
  """NaNCleaner(InputsAndResiduals(·)) around both models."""
  jtask = jax_configs.TaskConfig(**TINY_TASK)
  jstack = JaxNaNCleaner(
      JaxInputsAndResiduals(jmodel, *jax_synthetic.make_norm_stats(jtask)),
      var_to_clean="sea_surface_temperature", fill_value=0.0)
  stack = NaNCleaner(
      InputsAndResiduals(port, *synthetic.make_norm_stats(
          configs.TaskConfig(**TINY_TASK), device="cpu")),
      var_to_clean="sea_surface_temperature", fill_value=0.0)
  return jstack, stack


def _with_sst_nans(j_fs, t_fs):
  sst = np.asarray(j_fs.data("sea_surface_temperature")).copy()
  sst[..., :2] = np.nan
  t_fs.data("sea_surface_temperature")[..., :2] = float("nan")
  return j_fs.replace_data("sea_surface_temperature", sst), t_fs


@pytest.mark.parametrize("attention_type", ["mha", "splash_mha"])
def test_loss_and_grads_match_jax(attention_type, monkeypatch):
  """The wrapper stack's loss, diagnostics and every parameter gradient at
  batch 1, with NaNs in SST, on the same σ and noise."""
  jmodel, tree, port = _shared_weights(attention_type)
  (j_in, j_tg, j_fc), (t_in, t_tg, t_fc) = _batch()
  j_in, t_in = _with_sst_nans(j_in, t_in)
  j_tg, t_tg = _with_sst_nans(j_tg, t_tg)
  sigma = np.array([1.7], np.float32)
  rng = np.random.RandomState(21)
  draws = {n: rng.randn(*j_tg[n].shape).astype(np.float32)
           for n in j_tg.var_names}

  def jax_noise_like(key, template, basis_arrays=None):
    del key, basis_arrays
    return jax_fields.FieldSet(
        {n: jax_fields.Field(jnp.asarray(draws[n], template[n].dtype),
                             template[n].dims) for n in template.var_names},
        coords=template.coords)

  def port_noise_like(generator, template, basis):
    del generator, basis
    from graphcast_tpu_torch.fields import Field, FieldSet
    return FieldSet({n: Field(torch.from_numpy(draws[n]).to(
        template[n].dtype), template[n].dims) for n in template.var_names},
        coords=template.coords)

  monkeypatch.setattr(jax_noise, "rho_inverse_cdf",
                      lambda **kw: jnp.asarray(sigma, kw["cdf"].dtype))
  monkeypatch.setattr(jax_noise, "spherical_white_noise_like",
                      jax_noise_like)
  monkeypatch.setattr(noise, "rho_inverse_cdf",
                      lambda **kw: torch.from_numpy(sigma).to(kw["cdf"]))
  monkeypatch.setattr(noise, "spherical_white_noise_like", port_noise_like)
  jstack, stack = _stacks(jmodel, port)
  flat = {k: jnp.asarray(p.detach().numpy())
          for k, p in params.flat_params(port).items()}

  def jax_loss(flat):
    t = _nest(flat)
    t["architecture"]["graph_statics"] = tree["architecture"]["graph_statics"]
    t["noise_statics"] = tree["noise_statics"]
    loss, diag = jstack.loss(t, jax.random.PRNGKey(0), j_in, j_tg, j_fc)
    return jnp.mean(loss), diag

  (want_loss, want_diag), want_grads = jax.value_and_grad(
      jax_loss, has_aux=True)(flat)
  loss, diag = stack.loss(t_in, t_tg, t_fc, generator=torch.Generator())
  loss.mean().backward()
  assert np.isfinite(float(want_loss))
  np.testing.assert_allclose(float(loss.mean().detach()), float(want_loss),
                             rtol=5e-4)
  assert sorted(diag) == sorted(want_diag)
  for name, w in want_diag.items():
    np.testing.assert_allclose(diag[name].detach().numpy(), np.asarray(w),
                               rtol=5e-4, err_msg=name)
  got_grads = params.flat_params(port)
  assert sorted(got_grads) == sorted(want_grads)
  for key, p in got_grads.items():
    w = np.asarray(want_grads[key], np.float32)
    g = (np.zeros_like(w) if p.grad is None
         else p.grad.detach().numpy())
    np.testing.assert_allclose(g, w, rtol=2e-3,
                               atol=2e-3 * np.abs(w).max(), err_msg=key)


def test_train_step_runs_and_draws_from_its_generator():
  """GenCast ``make_train_step`` on the CPU: finite losses, parameters that
  change (the first step's learning rate is 0, so from the second), and
  two generators that draw two losses."""
  port = _port_model("splash_mha")
  _, (t_in, t_tg, t_fc) = _batch()
  stack = _stacks(_jax_model("mha"), port)[1]
  step = train.make_train_step(
      stack, train.graphcast_optimizer(port.parameters(), peak_lr=1e-3,
                                       warmup_steps=2))
  before = [p.detach().clone() for p in port.parameters()]
  losses = [float(step(t_in, t_tg, t_fc,
                       generator=torch.Generator().manual_seed(s))[0])
            for s in (1, 2, 1)]
  assert all(np.isfinite(losses))
  assert losses[0] != losses[1]
  assert any(not torch.equal(a, p) for a, p in zip(before, port.parameters()))
  with torch.no_grad():
    again = [float(stack.loss(t_in, t_tg, t_fc, generator=torch.Generator(
        ).manual_seed(s))[0].mean()) for s in (3, 3, 4)]
  assert again[0] == again[1] != again[2]
