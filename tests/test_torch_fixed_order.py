"""The general path's sums in a fixed order, on the CPU: at batch 2,
GraphCast's and the GenCast denoiser's general paths gather every node row
through the edge sets' ``RowGather`` pairs (ops/gather.py) and sum every
aggregation, mesh2grid's included, through ``sorted_segment_sum`` (K3's
plain version here, the kernel on the card); the backward holds no
``index_select``, ``index_add_`` or indexing node, whose sums on the card
take no fixed order. Tiny sizes (30° grid, mesh-1, latent 16, 2 message-
passing steps).
"""

import torch

from graphcast_tpu_torch.data import synthetic
from graphcast_tpu_torch.models import configs, denoiser, gencast, zoo
from graphcast_tpu_torch.models import graphcast as graphcast_lib
from graphcast_tpu_torch.models import sparse_transformer
from graphcast_tpu_torch.ops import gather, segment

TASK = configs.TaskConfig(
    input_variables=("2m_temperature", "temperature",
                     "toa_incident_solar_radiation", "land_sea_mask"),
    target_variables=("2m_temperature", "temperature"),
    forcing_variables=("toa_incident_solar_radiation",),
    pressure_levels=(500, 850), input_duration="12h")
GENCAST_TASK = configs.TaskConfig(
    input_variables=("2m_temperature", "temperature",
                     "sea_surface_temperature", "day_progress_sin",
                     "land_sea_mask"),
    target_variables=("2m_temperature", "temperature",
                      "sea_surface_temperature"),
    forcing_variables=("day_progress_sin",),
    pressure_levels=(500, 850), input_duration="24h")
UNORDERED = ("IndexSelectBackward", "IndexAddBackward", "IndexBackward",
             "ScatterAddBackward", "IndexPutBackward")


class _Spy:
  """Counts RowGather calls and the sorted segment sums of the models and
  of the gathers' backward; the plain segment sum must not be reached."""

  def __init__(self, monkeypatch, model_module):
    self.gathers, self.sums, self.backward_sums = [], [], 0
    call = gather.RowGather.__call__
    sums = model_module.sorted_segment_sum
    backward_sums = gather.sorted_segment_sum

    def spy_call(g, table):
      self.gathers.append(g)
      return call(g, table)

    def spy_sum(edges, messages):
      self.sums.append(edges)
      return sums(edges, messages)

    def spy_backward(edges, messages):
      self.backward_sums += 1
      return backward_sums(edges, messages)

    def refuse(*args, **kwargs):
      raise AssertionError("the general path reached the plain segment sum")

    monkeypatch.setattr(gather.RowGather, "__call__", spy_call)
    monkeypatch.setattr(model_module, "sorted_segment_sum", spy_sum)
    monkeypatch.setattr(gather, "sorted_segment_sum", spy_backward)
    monkeypatch.setattr(segment, "segment_sum", refuse)


def _backward_nodes(tensor):
  """Names of every autograd node behind ``tensor``."""
  names, seen, stack = set(), set(), [tensor.grad_fn]
  while stack:
    fn = stack.pop()
    if fn is None or fn in seen:
      continue
    seen.add(fn)
    names.add(type(fn).__name__)
    stack.extend(f for f, _ in fn.next_functions)
  return names


def _check_backward(loss, spy, gathers):
  nodes = _backward_nodes(loss)
  assert not [n for n in nodes if n.startswith(UNORDERED)], nodes
  loss.backward()
  assert spy.backward_sums == gathers


def test_graphcast_general_path_sums_in_a_fixed_order(monkeypatch):
  model = graphcast_lib.GraphCast(
      configs.ModelConfig(resolution=30.0, mesh_size=1, latent_size=16,
                          gnn_msg_steps=2, hidden_layers=1), TASK,
      generator=torch.Generator().manual_seed(0), device="cpu")
  data = synthetic.make_example_batch(TASK, 30.0, batch=2, device="cpu")
  spy = _Spy(monkeypatch, graphcast_lib)
  loss, _ = model.loss(*data)
  st = model._statics(torch.device("cpu"))
  # Two gathers per edge set and step: grid2mesh, 2 mesh steps, mesh2grid.
  assert len(spy.gathers) == 8
  assert {id(g) for g in spy.gathers} == {
      id(g) for name in ("g2m", "mesh", "m2g") for g in st[f"{name}_gathers"]}
  assert [id(e) for e in spy.sums] == [
      id(st["g2m"]), id(st["mesh"]), id(st["mesh"]), id(st["m2g"])]
  _check_backward(loss.mean(), spy, gathers=8)


def test_denoiser_general_path_sums_in_a_fixed_order(monkeypatch):
  preset = zoo.GenCastPreset(
      name="tiny", resolution=30.0, task_config=GENCAST_TASK,
      denoiser_architecture_config=denoiser.DenoiserArchitectureConfig(
          sparse_transformer_config=sparse_transformer.SparseTransformerConfig(
              attention_k_hop=2, d_model=16, num_layers=1, num_heads=2,
              attention_type="splash_mha", ffw_hidden=32, block_q=64),
          mesh_size=1, latent_size=16, hidden_layers=1),
      sampler_config=gencast.SamplerConfig(num_noise_levels=4),
      noise_config=gencast.NoiseConfig(),
      noise_encoder_config=denoiser.NoiseEncoderConfig(
          num_frequencies=8, output_sizes=(16, 8)))
  model = preset.build(generator=torch.Generator().manual_seed(0),
                       device="cpu")
  data = synthetic.make_example_batch(GENCAST_TASK, 30.0, batch=2,
                                      time_step_hours=12, device="cpu")
  spy = _Spy(monkeypatch, denoiser)
  loss, _ = model.loss(*data, generator=torch.Generator().manual_seed(1))
  st = model.architecture._statics(torch.device("cpu"))
  assert len(spy.gathers) == 4
  assert [id(e) for e in spy.sums] == [id(st["g2m"]), id(st["m2g"])]
  _check_backward(loss.mean(), spy, gathers=4)
