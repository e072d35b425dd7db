"""GraphCast and GenCast with more than one hidden layer per MLP against
graphcast_tpu, f32, on shared weights and inputs (tests/
test_torch_memory_forms.py's tiny sizes: 30° grid, mesh-1, latent 16, 4
message-passing steps; GenCast as in tests/test_torch_gencast.py).

The kernels compute one hidden layer, so both packages turn their fused
stages off at ``hidden_layers`` > 1 and run the general and chunked forms;
the port's fused entry points are replaced here by ones that raise.

- GraphCast at ``hidden_layers`` 2 and 3: one step in every
  ``fused_aggregation`` value, at batch 1 and 2; the chunked encoder and
  decoder, the processor remat and the 0.25° training form at batch 1 and
  2 (tolerance 5e-4); the loss and every gradient (gradients within 2e-3 of
  each one's largest element).
- GenCast at ``hidden_layers`` 2: the denoiser at batch 1 and 2 and in the
  chunked form, the loss and every gradient, at tests/test_torch_gencast.
  py's tolerances.
- A bundle the JAX package saved at ``hidden_layers`` 2 loads into the
  port bit for bit (``linear_2`` keys among them) and predicts the same;
  the tensor-parallel plan leaves the three-linear MLPs replicated, as the
  JAX package's does.
"""

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_gencast as gencast_case
import test_torch_memory_forms as forms
import test_torch_parallel as parallel_case
from graphcast_tpu import train as jax_train
from graphcast_tpu.compat import haiku_checkpoint as jax_haiku
from graphcast_tpu.data import synthetic as jax_synthetic
from graphcast_tpu.models import configs as jax_configs
from graphcast_tpu.models.graphcast import GraphCast as JaxGraphCast
from graphcast_tpu_torch import params
from graphcast_tpu_torch.compat import haiku_checkpoint
from graphcast_tpu_torch.data import synthetic
from graphcast_tpu_torch.models import configs, denoiser
from graphcast_tpu_torch.models import graphcast as port_graphcast
from graphcast_tpu_torch.nn import deep_gnn
from graphcast_tpu_torch.parallel import sharding

TOL = 5e-4
GRAD_TOL = 2e-3
HIDDEN = (2, 3)
FUSED = {"false": False, "true": True, "processor": "processor",
         "encoder": "encoder"}
MEMORY_FORMS = {
    "chunked": dict(fused_aggregation=True, encode_chunks=3,
                    decode_chunks=4),
    "remat": dict(fused_aggregation=True, remat_processor=True),
    "training_form": forms.TRAINING_FORM,
}


@pytest.fixture(autouse=True)
def no_fused_kernels(monkeypatch):
  """The port's fused stages raise where they are called."""
  def refuse(*args, **kwargs):
    raise AssertionError("a fused stage ran at hidden_layers > 1")

  for module in (port_graphcast, denoiser, deep_gnn):
    monkeypatch.setattr(module, "fused_edge", refuse)
  for module in (port_graphcast, denoiser):
    monkeypatch.setattr(module, "fused_decode", refuse)


def _model_config(hidden_layers):
  return dict(forms.TINY_MODEL, hidden_layers=hidden_layers)


def _assert_outputs_close(got, want):
  assert got.var_names == want.var_names
  for name in want.var_names:
    np.testing.assert_allclose(got.data(name).numpy(),
                               np.asarray(want.data(name)), rtol=TOL,
                               atol=TOL, err_msg=name)


def _one_step(form, batch, hidden_layers):
  jmodel, jparams, model, j_data, t_data = forms._graphcast_both(
      form, batch, model_config=_model_config(hidden_layers))
  want = jmodel(jparams, None, *j_data)
  with torch.inference_mode():
    got = model(*t_data)
  _assert_outputs_close(got, want)
  if batch > 1:
    t = got.data("temperature")
    assert not torch.allclose(t[0], t[1])  # members differ
  return model


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("fused", sorted(FUSED))
@pytest.mark.parametrize("hidden_layers", HIDDEN)
def test_graphcast_one_step_matches_jax(hidden_layers, fused, batch):
  model = _one_step(dict(fused_aggregation=FUSED[fused]), batch,
                    hidden_layers)
  assert len(model.mesh_gnn["processor_0_edges_mesh"].mlp) == (
      hidden_layers + 1)
  assert not (model._fused_processor or model._fused_encoder
              or model._fused_decoder)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("form", sorted(MEMORY_FORMS))
@pytest.mark.parametrize("hidden_layers", HIDDEN)
def test_graphcast_memory_form_matches_jax(hidden_layers, form, batch):
  model = _one_step(MEMORY_FORMS[form], batch, hidden_layers)
  if "encode_chunks" in MEMORY_FORMS[form]:
    assert model._g2m_plan.num_chunks == 3  # the encoder ran chunked
    assert len(model._statics(torch.device("cpu"))["m2g_chunks"]) == 4


@pytest.mark.parametrize("form", ["false", "true", "training_form"])
@pytest.mark.parametrize("hidden_layers", HIDDEN)
def test_graphcast_loss_and_grads_match_jax(hidden_layers, form):
  form = MEMORY_FORMS.get(form) or dict(fused_aggregation=FUSED[form])
  jmodel, jparams, model, j_data, t_data = forms._graphcast_both(
      form, 1, model_config=_model_config(hidden_layers))
  want_loss, want_grads = forms._jax_grads(
      lambda p: jmodel.loss(p, None, *j_data)[0], jparams)
  loss, grads = forms._port_grads(lambda: model.loss(*t_data)[0], model)
  np.testing.assert_allclose(float(loss), want_loss, rtol=TOL)
  assert set(grads) == set(want_grads)
  assert any(k.endswith(f"linear_{hidden_layers}/w") for k in grads)
  for k, w in want_grads.items():
    np.testing.assert_allclose(grads[k].numpy(), w, rtol=GRAD_TOL,
                               atol=GRAD_TOL * np.abs(w).max(), err_msg=k)


# ----- GenCast -----

GENCAST_FORMS = {"default": {}, "chunked": forms.CHUNKED}
# (form, batch): batch 1 runs the general path unchunked, batch 2 both.
GENCAST_CASES = [("default", 1), ("default", 2), ("chunked", 2)]


def _gencast_hidden_2(monkeypatch, form):
  """tests/test_torch_gencast.py's model constructors at hidden_layers=2,
  in ``form`` on both sides."""
  form = GENCAST_FORMS[form]
  monkeypatch.setattr(gencast_case, "_jax_model", functools.partial(
      forms._jax_gencast, hidden_layers=2, **form))
  monkeypatch.setattr(gencast_case, "_port_model", functools.partial(
      forms._port_gencast, hidden_layers=2, **form))
  return form


@pytest.mark.parametrize("form,batch", GENCAST_CASES)
def test_gencast_denoiser_matches_jax(form, batch, monkeypatch):
  form = _gencast_hidden_2(monkeypatch, form)
  jmodel, tree, port = gencast_case._shared_weights("mha")
  (j_in, j_tg, j_fc), (t_in, t_tg, t_fc) = gencast_case._batch(batch)
  arch = port.architecture
  assert len(arch.grid2mesh_gnn["processor_0_edges_grid2mesh"].mlp) == 3
  for sigma in (80.0, 1.0, 0.03):
    levels = np.array([sigma, sigma / 3][:batch], np.float32)
    want = jmodel._denoiser.apply(tree, j_in, j_tg, jnp.asarray(levels),
                                  j_fc)
    with torch.inference_mode():
      got = port.denoise(t_in, t_tg, torch.from_numpy(levels), t_fc)
    for name in want.var_names:
      gencast_case._assert_close(got.data(name).numpy(), want.data(name))
  assert not arch._fused
  assert (arch._g2m_plan is not None) == bool(form)


@pytest.mark.parametrize("form,batch", [("default", 1), ("chunked", 2)])
def test_gencast_loss_and_grads_match_jax(form, batch, monkeypatch):
  _gencast_hidden_2(monkeypatch, form)
  gencast_case._check_loss_and_grads("mha", monkeypatch, batch=batch)


# ----- checkpoints and the tensor-parallel plan -----

def test_jax_bundle_at_hidden_layers_2_loads_and_predicts_the_same():
  mc = jax_configs.ModelConfig(**_model_config(2))
  task = jax_configs.TaskConfig(**forms.TINY_TASK)
  data = jax_synthetic.make_example_batch(task, resolution=30.0, batch=1)
  jmodel = JaxGraphCast(mc, task, cache_dir="", fused_aggregation=False)
  tree = jmodel.init(jax.random.PRNGKey(4), *data)
  buf = io.BytesIO()
  jax_haiku.save_graphcast_checkpoint(buf, tree, mc, task,
                                      description="two hidden layers")
  buf.seek(0)
  port, mc2, task2, _, _ = haiku_checkpoint.load_graphcast_checkpoint(
      buf, device="cpu")
  assert mc2 == configs.ModelConfig(**_model_config(2))
  learned, _ = jax_train.partition_params(tree)
  want_flat = params.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            learned))
  got_flat = params.flat_params(port)
  assert set(got_flat) == set(want_flat)
  assert "mesh_gnn/processor_0_edges_mesh/mlp/linear_2/w" in got_flat
  for key, value in want_flat.items():
    np.testing.assert_array_equal(got_flat[key].detach().numpy(), value,
                                  err_msg=key)
  want = jmodel(tree, None, *data)
  with torch.inference_mode():
    got = port(*synthetic.make_example_batch(task2, resolution=30.0,
                                             device="cpu"))
  for name in want.var_names:
    w = np.asarray(want.data(name))
    np.testing.assert_allclose(got.data(name).numpy(), w, rtol=TOL,
                               atol=TOL * np.abs(w).max(), err_msg=name)


def test_tensor_parallel_plan_leaves_deeper_mlps_replicated():
  """Only two-linear MLPs are paired (graphcast_tpu parallel/
  sharding.py:217): at hidden_layers=2 every graph-net MLP stays whole,
  leaf for leaf as the JAX package's plan."""
  task = jax_configs.TaskConfig(**parallel_case.workers.GC_TASK)
  mc = jax_configs.ModelConfig(**dict(parallel_case.workers.GC_MODEL,
                                      hidden_layers=2))
  jmodel = JaxGraphCast(mc, task, cache_dir="", fused_aggregation=False)
  data = jax_synthetic.make_example_batch(task, resolution=30.0, batch=2,
                                          num_target_times=1)
  jparams = jmodel.init(jax.random.PRNGKey(0), *data)
  want = parallel_case._jax_specs(jparams, 2)
  shapes = {k: v.shape for k, v in params.params_from_jax(
      jax.tree_util.tree_map(np.asarray, jax_train.partition_params(
          jparams)[0])).items()}
  got = {k: tuple(spec) for k, spec in
         sharding.tensor_parallel_plan(shapes, 2).items()}
  got = {k: v[:-1] if v and v[-1] is None else v for k, v in got.items()}
  assert got == want
  assert any(k.endswith("linear_2/w") for k in got)
  assert all(not v for k, v in got.items() if "/mlp/" in k)
