"""The plain reference against the port's plain versions on the CPU, at a
tiny size: the graph, GraphCast's one-step residuals and its AR-1 loss and
gradients, all in float32 (the port's Bfloat16Cast off), and GenCast's 12 h
sample from the same noise, in float32."""

import numpy as np
import pytest
import torch

from portbench import data, program
from portbench.reference import geometry
from portbench.reference import gencast as gref
from portbench.reference import graphcast as ref
from portbench.tests.helpers import CPU, tiny_config

SEED = 2**33 + 5


def _port_stack(cfg, weights, stats, bf16=False, **kw):
  model, stack = program.graphcast_stack(cfg, weights, stats, CPU, **kw)
  stack._predictor._predictor._enabled = bf16   # Bfloat16Cast
  return model, stack


def _step_data(cfg, seed):
  gen = data.generator(seed, "test", device=CPU)
  dynamic = [n for n in cfg["input_variables"]
             if n not in cfg["static_variables"]]
  inputs = data.make_fields(cfg, dynamic, 1, ref.input_frames(cfg), gen, CPU)
  inputs.update(data.make_fields(cfg, cfg["static_variables"], 1, 1, gen,
                                 CPU))
  targets = data.make_fields(cfg, cfg["target_variables"], 1, 1, gen, CPU)
  forcings = data.make_fields(cfg, cfg["forcing_variables"], 1, 1, gen, CPU)
  return inputs, targets, forcings


def _fieldsets(cfg, inputs, targets, forcings):
  h = cfg["step_hours"]
  return (program.fieldset(cfg, inputs, h, 1 - ref.input_frames(cfg)),
          program.fieldset(cfg, targets, h, 1),
          program.fieldset(cfg, forcings, h, 1))


def test_graph_equals_the_ports_artifact(monkeypatch):
  from graphcast_tpu_torch.geometry import artifact
  cfg = tiny_config()
  lat = np.arange(-90.0, 90.0 + cfg["resolution"] / 2,
                  cfg["resolution"]).astype(np.float32)
  lon = np.arange(0.0, 360.0, cfg["resolution"]).astype(np.float32)
  g = geometry.build_graph(lat, lon, cfg["mesh_size"], 0.6, multimesh=True,
                           use_cache=False)
  a = artifact.build_artifact(lat, lon, cfg["mesh_size"], cache_dir="")
  for mine, theirs in (("g2m", "grid2mesh"), ("mesh", "mesh"),
                       ("m2g", "mesh2grid")):
    e = getattr(a, theirs)
    s, r, f = getattr(g, mine)
    np.testing.assert_array_equal(s, e.senders)
    np.testing.assert_array_equal(r, e.receivers)
    np.testing.assert_array_equal(f, e.features)
  np.testing.assert_array_equal(g.grid_features, a.grid_node_features)
  np.testing.assert_array_equal(g.mesh_features, a.mesh_node_features)


def test_param_shapes_are_the_ports():
  cfg = tiny_config()
  model, _ = _port_stack(cfg, data.make_weights(ref.param_shapes(cfg), SEED,
                                                CPU),
                         data.make_stats(cfg, SEED, CPU))
  assert {n: tuple(p.shape) for n, p in model.named_parameters()} == (
      ref.param_shapes(cfg))


def test_graphcast_residuals_match_the_port_in_float32():
  cfg = tiny_config()
  weights = data.make_weights(ref.param_shapes(cfg), SEED, CPU)
  stats = data.make_stats(cfg, SEED, CPU)
  _, stack = _port_stack(cfg, weights, stats)
  inputs, targets, forcings = _step_data(cfg, SEED)
  with torch.no_grad():
    pred = stack(*_fieldsets(cfg, inputs, targets, forcings))
    graph = ref.DeviceGraph(cfg, CPU)
    expected = ref.residuals(cfg, weights, graph, stats, inputs, forcings,
                             ref.quantizer("float32"))
  for name in cfg["target_variables"]:
    diffs = stats["diffs_stddev"][name]
    if ref.is_atmospheric(cfg, name):
      diffs = diffs[:, None, None]
    got = (pred[name].data[:, 0] - inputs[name][:, -1]) / diffs
    err = (got - expected[name]).abs().max() / expected[name].abs().max()
    assert err < 1e-4, (name, float(err))


def test_graphcast_loss_and_gradients_match_the_port_in_float32():
  cfg = tiny_config()
  weights = data.make_weights(ref.param_shapes(cfg), SEED, CPU)
  stats = data.make_stats(cfg, SEED, CPU)
  model, stack = _port_stack(cfg, weights, stats,
                             gradient_checkpointing=True)
  inputs, targets, forcings = _step_data(cfg, SEED)
  loss, _ = stack.loss(*_fieldsets(cfg, inputs, targets, forcings))
  loss.mean().backward()
  ref_w = {n: w.clone().requires_grad_() for n, w in weights.items()}
  graph = ref.DeviceGraph(cfg, CPU)
  ref_loss = ref.loss(cfg, ref_w, graph, stats, inputs, targets, forcings,
                      ref.quantizer("float32"))
  ref_loss.backward()
  assert abs(float(loss.mean()) - float(ref_loss)) <= 1e-5 * float(ref_loss)
  for name, p in model.named_parameters():
    g_ref = ref_w[name].grad
    if g_ref is None:   # a leaf that feeds no output
      g_ref = torch.zeros_like(p)
    g = p.grad if p.grad is not None else torch.zeros_like(p)
    scale = max(float(g_ref.abs().max()), 1e-12)
    assert float((g - g_ref).abs().max()) <= 2e-3 * scale, name


def test_float8_control_departs_from_float32():
  cfg = tiny_config()
  weights = data.make_weights(ref.param_shapes(cfg), SEED, CPU)
  stats = data.make_stats(cfg, SEED, CPU)
  inputs, _, forcings = _step_data(cfg, SEED)
  graph = ref.DeviceGraph(cfg, CPU)
  with torch.no_grad():
    exact = ref.residuals(cfg, weights, graph, stats, inputs, forcings,
                          ref.quantizer("float32"))
    low = ref.residuals(cfg, weights, graph, stats, inputs, forcings,
                        ref.quantizer("float8_e4m3"))
  worst = max(float((low[n] - exact[n]).square().mean().sqrt()
                    / exact[n].square().mean().sqrt()) for n in exact)
  assert worst > 0.05


def _gencast_case(members=3):
  """The port's InputsAndResiduals(GenCast) at the tiny size in float32,
  its inputs and ``members`` member generators, and its sample."""
  from graphcast_tpu_torch import rollout
  cfg = tiny_config("gencast_tiny")
  weights = data.make_weights(gref.param_shapes(cfg), SEED, CPU)
  stats = data.make_stats(cfg, SEED, CPU)
  model, stack = program.gencast_stack(cfg, weights, stats, CPU)
  gen = data.generator(SEED, "gencast", device=CPU)
  dynamic = [n for n in cfg["input_variables"]
             if n not in cfg["static_variables"]]
  inputs = data.make_fields(cfg, dynamic, 1, 2, gen, CPU)
  inputs.update(data.make_fields(cfg, cfg["static_variables"], 1, 1, gen,
                                 CPU))
  forcings = data.make_fields(cfg, cfg["forcing_variables"], 1, 1, gen, CPU)
  template = {n: torch.zeros_like(t) for n, t in data.make_fields(
      cfg, cfg["target_variables"], 1, 1, gen, CPU).items()}
  h = cfg["step_hours"]
  base = data.generator(SEED, "members", device=CPU)
  with torch.no_grad():
    pred = stack(
        rollout.tile_batch(program.fieldset(cfg, inputs, h, -1), members),
        rollout.tile_batch(program.fieldset(cfg, template, h, 1), members),
        rollout.tile_batch(program.fieldset(cfg, forcings, h, 1), members),
        generator=rollout.member_generators(base, range(members)))
  return cfg, weights, stats, model, inputs, forcings, pred


def test_gencast_param_shapes_are_the_ports():
  cfg, _, _, model, *_ = _gencast_case(1)
  assert {n: tuple(p.shape) for n, p in model.named_parameters()} == (
      gref.param_shapes(cfg))


@pytest.mark.parametrize("precision,bound", [("float32", 1e-4),
                                             ("float8_e4m3", None)])
def test_gencast_sample_matches_the_port_in_float32(precision, bound):
  """Every member's sample, the same noise replayed from its generator;
  the float8 reference departs from it."""
  members = 3
  cfg, weights, stats, _, inputs, forcings, pred = _gencast_case(members)
  graph = gref.DeviceGraph(cfg, CPU)
  for m in range(members):
    gen = gref.member_generators(
        data.generator(SEED, "members", device=CPU), range(members))[m]
    with torch.no_grad():
      x = gref.sample(cfg, weights, graph, stats, inputs, forcings,
                      gref.NoiseStream(cfg, gen, graph.basis),
                      gref.quantizer(precision))
    worst = 0.0
    for name in cfg["target_variables"]:
      last = (inputs[name][:, -1][:, None]
              if name in cfg["input_variables"] else None)
      got = gref.to_normalized_target(cfg, stats, name,
                                      pred[name].data[m:m + 1], last)
      worst = max(worst, float((got - x[name]).square().mean().sqrt()
                               / x[name].square().mean().sqrt()))
    if bound is None:
      assert worst > 0.05, m
    else:
      assert worst < bound, (m, worst)


def test_gencast_noise_is_unit_variance_white_noise():
  cfg = tiny_config("gencast_tiny")
  graph = gref.DeviceGraph(cfg, CPU)
  stream = gref.NoiseStream(cfg, torch.Generator().manual_seed(3),
                            graph.basis)
  draws = torch.stack([stream.draw()["temperature"] for _ in range(40)])
  assert abs(float(draws.var()) - 1.0) < 0.1


def test_k_hop_mask_reaches_k_edges():
  # A path 0-1-2-3-4: two hops from node 0 reach nodes 0, 1 and 2.
  s, r = np.array([0, 1, 2, 3]), np.array([1, 2, 3, 4])
  mask = geometry.k_hop_mask(np.concatenate([s, r]), np.concatenate([r, s]),
                             5, 2)
  assert mask[0].tolist() == [True, True, True, False, False]
  assert (mask == mask.T).all()
