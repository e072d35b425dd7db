"""Checkpoints of the port (checkpoint.py, compat/haiku_checkpoint.py)
against the JAX package's: the pinned copies equal their originals
function by function, and reference-format bundles cross both ways bit for
bit. A bundle the JAX package writes loads into the port's GraphCast, whose
forward then equals JAX's at f32 5e-4 (the port's standing f32 tolerance,
tests/test_torch_graphcast.py); GenCast's parameters cross through the
GenCast Haiku naming. Tiny config: 30° grid, mesh-1, latent 16."""

import inspect
import io

import jax
import numpy as np
import pytest
import torch

from graphcast_tpu import checkpoint as jax_checkpoint
from graphcast_tpu import train as jax_train
from graphcast_tpu.compat import haiku_checkpoint as jax_haiku
from graphcast_tpu.data import synthetic as jax_synthetic
from graphcast_tpu.models import configs as jax_configs
from graphcast_tpu.models.graphcast import GraphCast as JaxGraphCast
from graphcast_tpu_torch import checkpoint, params
from graphcast_tpu_torch.compat import haiku_checkpoint
from graphcast_tpu_torch.data import synthetic
from graphcast_tpu_torch.models import configs
from graphcast_tpu_torch.models.graphcast import GraphCast
from tests.test_torch_graphcast import TINY_MODEL, TINY_TASK


@pytest.mark.parametrize("name", ["_flatten", "dump", "_unflatten",
                                  "_strip_optional", "_convert", "load"])
def test_pinned_checkpoint_copy_equals_original(name):
  assert (inspect.getsource(getattr(checkpoint, name))
          == inspect.getsource(getattr(jax_checkpoint, name)))


@pytest.mark.parametrize("name", [
    "_map_base_name", "_unmap_base_name", "haiku_params_to_native",
    "native_params_to_haiku", "gencast_haiku_params_to_native",
    "native_gencast_params_to_haiku", "_GNN_RE", "_MLP_RE", "_LN_RE",
    "_NC_RE", "_PROC_RE", "_TRANSFORMER_RE", "_BLOCK_RE", "_BLOCK_NC_RE",
    "_FINAL_NC_RE", "_NOISE_ENC_RE"])
def test_pinned_haiku_copy_equals_original(name):
  ours, theirs = getattr(haiku_checkpoint, name), getattr(jax_haiku, name)
  if callable(ours) and not hasattr(ours, "pattern"):
    assert inspect.getsource(ours) == inspect.getsource(theirs)
  else:
    assert ours.pattern == theirs.pattern


def _jax_tiny():
  task = jax_configs.TaskConfig(**TINY_TASK)
  mc = jax_configs.ModelConfig(**TINY_MODEL)
  data = jax_synthetic.make_example_batch(task, resolution=30.0, batch=1)
  model = JaxGraphCast(mc, task, cache_dir="", fused_aggregation=False)
  tree = model.init(jax.random.PRNGKey(4), *data)
  return model, tree, mc, task, data


def _learned_flat(tree):
  learned, _ = jax_train.partition_params(tree)
  return params.params_from_jax(jax.tree_util.tree_map(np.asarray, learned))


def test_jax_bundle_loads_into_port_bit_equal_and_forward_matches():
  model, tree, mc, task, data = _jax_tiny()
  buf = io.BytesIO()
  jax_haiku.save_graphcast_checkpoint(buf, tree, mc, task,
                                      description="tiny", license="mit")
  buf.seek(0)
  port, mc2, task2, desc, lic = haiku_checkpoint.load_graphcast_checkpoint(
      buf, device="cpu")
  assert (desc, lic) == ("tiny", "mit")
  assert mc2 == configs.ModelConfig(**TINY_MODEL)
  assert task2 == configs.TaskConfig(**TINY_TASK)
  want_flat = _learned_flat(tree)
  got_flat = params.flat_params(port)
  assert set(got_flat) == set(want_flat)
  for key, value in want_flat.items():
    np.testing.assert_array_equal(got_flat[key].detach().numpy(), value,
                                  err_msg=key)

  want = model(tree, None, *data)
  with torch.inference_mode():
    got = port(*synthetic.make_example_batch(task2, resolution=30.0,
                                             device="cpu"))
  for name in want.var_names:
    w = np.asarray(want.data(name))
    np.testing.assert_allclose(got.data(name).numpy(), w, rtol=5e-4,
                               atol=5e-4 * np.abs(w).max(), err_msg=name)


def test_port_bundle_loads_into_jax_bit_equal():
  port = GraphCast(configs.ModelConfig(**TINY_MODEL),
                   configs.TaskConfig(**TINY_TASK),
                   generator=torch.Generator().manual_seed(2), device="cpu")
  buf = io.BytesIO()
  haiku_checkpoint.save_graphcast_checkpoint(
      buf, port, configs.ModelConfig(**TINY_MODEL),
      configs.TaskConfig(**TINY_TASK), description="port")
  buf.seek(0)
  native, mc, task, desc, _ = jax_haiku.load_graphcast_checkpoint(buf)
  assert desc == "port"
  assert mc == jax_configs.ModelConfig(**TINY_MODEL)
  assert task == jax_configs.TaskConfig(**TINY_TASK)
  got = params.params_from_jax(native)
  want = {k: p.detach().numpy() for k, p in params.flat_params(port).items()}
  assert set(got) == set(want)
  for key in want:
    np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_port_bundle_round_trips_in_the_port():
  port = GraphCast(configs.ModelConfig(**TINY_MODEL),
                   configs.TaskConfig(**TINY_TASK),
                   generator=torch.Generator().manual_seed(3), device="cpu")
  buf = io.BytesIO()
  haiku_checkpoint.save_graphcast_checkpoint(
      buf, port, configs.ModelConfig(**TINY_MODEL),
      configs.TaskConfig(**TINY_TASK))
  buf.seek(0)
  back, *_ = haiku_checkpoint.load_graphcast_checkpoint(buf, device="cpu")
  for (k, a), (k2, b) in zip(params.flat_params(port).items(),
                             params.flat_params(back).items()):
    assert k == k2 and torch.equal(a, b)


def test_gencast_params_cross_both_ways():
  from tests.test_torch_gencast import _batch, _jax_model, _port_model
  (inputs, targets, forcings), _ = _batch()
  tree = _jax_model("mha", fused=False).init(jax.random.PRNGKey(0), inputs,
                                             targets, forcings)
  learned, _ = jax_train.partition_params(tree)
  learned = jax.tree_util.tree_map(np.asarray, learned)
  haiku = jax_haiku.native_gencast_params_to_haiku(learned)
  model = haiku_checkpoint.load_gencast_params(_port_model("mha", seed=9),
                                               haiku)
  want = params.params_from_jax(learned)
  got = {k: p.detach().numpy() for k, p in params.flat_params(model).items()}
  assert set(got) == set(want)
  for key in want:
    np.testing.assert_array_equal(got[key], want[key], err_msg=key)
  back = params.params_from_jax(jax_haiku.gencast_haiku_params_to_native(
      haiku_checkpoint.gencast_params_to_haiku(model)))
  assert set(back) == set(want)
  for key in want:
    np.testing.assert_array_equal(back[key], want[key], err_msg=key)


def test_unknown_haiku_keys_raise_and_missing_keys_raise():
  port = GraphCast(configs.ModelConfig(**TINY_MODEL),
                   configs.TaskConfig(**TINY_TASK),
                   generator=torch.Generator().manual_seed(3), device="cpu")
  haiku = haiku_checkpoint.native_params_to_haiku(params.params_to_jax(port))
  with pytest.raises(ValueError, match="unrecognized"):
    haiku_checkpoint.haiku_params_to_native(
        {**haiku, "mystery/module": {"w": np.zeros(1)}})
  with pytest.raises(ValueError, match="unrecognized"):
    haiku_checkpoint.haiku_params_to_native(
        {**haiku, "mesh_gnn/~_networks_builder/odd_module":
         {"w": np.zeros(1)}})
  dropped = dict(haiku)
  dropped.pop(next(iter(dropped)))
  with pytest.raises(KeyError):
    params.load_params(port, params.params_from_jax(
        haiku_checkpoint.haiku_params_to_native(dropped)))


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a CPU-only box")
def test_loader_runs_on_the_card_unless_asked():
  port = GraphCast(configs.ModelConfig(**TINY_MODEL),
                   configs.TaskConfig(**TINY_TASK),
                   generator=torch.Generator().manual_seed(3), device="cpu")
  buf = io.BytesIO()
  haiku_checkpoint.save_graphcast_checkpoint(
      buf, port, configs.ModelConfig(**TINY_MODEL),
      configs.TaskConfig(**TINY_TASK))
  buf.seek(0)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    haiku_checkpoint.load_graphcast_checkpoint(buf)
