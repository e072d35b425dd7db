"""The port's multi-step drivers (graphcast_tpu_torch/tools/) on the CPU, at
tiny sizes (30° grid, mesh-1, latent 16, 2 message-passing steps; GenCast
also d_model 16, 2 layers, 4 noise levels; both packages build the
geometry with their default backend, which resolves alike in both).

- ``train_curve``'s loop against a JAX loop (graphcast_tpu.train.
  make_train_step) from the same numpy weights and seeded batches, f32, 5
  steps: losses and parameters at test_torch_train.py::
  test_train_steps_match_jax's tolerances (5e-4; parameters 5e-4 plus 5e-5
  absolute).
- The tiny GraphCast curve descends over 20 fixed-batch steps.
- Stream mode trains on the seeds and scores the held-out batch at the
  steps of tools/train_curve.py.
- The GenCast curve is finite and bit-equal under the same seeds.
- Each driver's metric name and record keys are its JAX script's (besides
  them only the card, its power limit and the peak memory; the rollout
  drops ``vs_baseline``, a ratio to TPU figures); AR steps and
  ``TRAIN_FUSED`` are parsed and refused as the JAX scripts do.
- The memdumps' replay-to-peak summariser on a hand-built snapshot.
- Without a card every driver raises unless given ``--device cpu``.
"""

import ast
import json
import pathlib
import sys

import torch

# torch.optim imports torch._dynamo at first use, whose find_spec scan
# raises on tests/fake_xarray.py's module: import it with that set aside.
_xarray = sys.modules.pop("xarray", None)
try:
  import torch._dynamo  # noqa: F401
finally:
  if _xarray is not None:
    sys.modules["xarray"] = _xarray

import jax
import numpy as np
import pytest

from graphcast_tpu import train as jax_train
from graphcast_tpu.data import synthetic as jax_synthetic
from graphcast_tpu.models import configs as jax_configs
from graphcast_tpu.models.graphcast import GraphCast as JaxGraphCast
from graphcast_tpu.wrappers import (
    Autoregressive as JaxAutoregressive, Bfloat16Cast as JaxBfloat16Cast,
    InputsAndResiduals as JaxInputsAndResiduals)
from graphcast_tpu_torch import params
from graphcast_tpu_torch.models import configs, denoiser, gencast, zoo
from graphcast_tpu_torch.models import sparse_transformer
from graphcast_tpu_torch.models.graphcast import GraphCast
from graphcast_tpu_torch.tools import (
    bench_gencast_rollout, bench_train_025, bench_train_gencast, common,
    memdump_gencast, memdump_train_025, memory_trace, train_curve)

REPO = pathlib.Path(__file__).resolve().parents[1]
TOOLS = REPO / "tools"
TINY_TASK = dict(
    input_variables=("2m_temperature", "temperature",
                     "toa_incident_solar_radiation", "land_sea_mask"),
    target_variables=("2m_temperature", "temperature"),
    forcing_variables=("toa_incident_solar_radiation",),
    pressure_levels=(500, 850),
    input_duration="12h")
TINY_MODEL = dict(resolution=30.0, mesh_size=1, latent_size=16,
                  gnn_msg_steps=2, hidden_layers=1)
GENCAST_TASK = dict(
    input_variables=("2m_temperature", "temperature",
                     "sea_surface_temperature", "day_progress_sin",
                     "land_sea_mask"),
    target_variables=("2m_temperature", "temperature",
                      "sea_surface_temperature"),
    forcing_variables=("day_progress_sin",),
    pressure_levels=(500, 850),
    input_duration="24h")
TOL = 5e-4
LR = 0.05  # CURVE_LR: with the 1,000-step warmup, 5e-5 a step here


def _tiny_curve(model=None):
  return train_curve.graphcast_curve(
      configs.ModelConfig(**TINY_MODEL), configs.TaskConfig(**TINY_TASK),
      30.0, "cpu", model=model, bf16=False)


def test_graphcast_curve_matches_jax_loop():
  """train_curve's loop and form against the JAX package's train step in
  the JAX script's loop, from the same weights and batches (f32)."""
  steps = 5
  jtask = jax_configs.TaskConfig(**TINY_TASK)
  jmodel = JaxGraphCast(jax_configs.ModelConfig(**TINY_MODEL), jtask,
                        cache_dir="", fused_aggregation=False,
                        remat_processor=True)
  stats = jax_synthetic.make_norm_stats(jtask)
  j_stack = JaxAutoregressive(JaxInputsAndResiduals(
      JaxBfloat16Cast(jmodel, enabled=False), stddev_by_level=stats[0],
      mean_by_level=stats[1], diffs_stddev_by_level=stats[2]),
                              gradient_checkpointing=True)
  batch = jax_synthetic.make_example_batch(jtask, resolution=30.0, batch=1,
                                           num_target_times=1, seed=0)
  optimizer = jax_train.graphcast_optimizer(peak_lr=LR)
  rng = jax.random.PRNGKey(0)
  state = jax_train.init_train_state(j_stack, optimizer, rng, *batch)
  learned, _ = jax_train.partition_params(state.params)
  flat = params.params_from_jax(jax.tree_util.tree_map(np.asarray, learned))
  step_fn = jax_train.make_train_step(j_stack, optimizer, donate=False)
  j_losses = []
  for i in range(steps):
    state, loss, _ = step_fn(state, jax.random.fold_in(rng, i), *batch)
    j_losses.append(float(loss))

  model = GraphCast(configs.ModelConfig(**TINY_MODEL),
                    configs.TaskConfig(**TINY_TASK),
                    fused_aggregation="processor", remat_processor=True,
                    generator=torch.Generator().manual_seed(0), device="cpu")
  params.load_params(model, flat)
  run = train_curve.run_curve(_tiny_curve(model), steps, lr=LR,
                              dtype=torch.float32, log=lambda _: None)
  np.testing.assert_allclose(run["losses"], j_losses, rtol=TOL)
  assert run["losses"][-1] < run["losses"][0]
  learned, _ = jax_train.partition_params(state.params)
  want = params.params_from_jax(jax.tree_util.tree_map(np.asarray, learned))
  got = {k: p.detach().numpy() for k, p in params.flat_params(model).items()}
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=5e-5,
                               err_msg=k)


def test_graphcast_curve_descends():
  """20 fixed-batch steps of the tool's form (f32: bf16 products are slow
  on the CPU): the last window's mean below the first's, every loss
  finite."""
  curve = _tiny_curve()
  run = train_curve.run_curve(curve, 20, lr=LR, dtype=torch.float32,
                              log=lambda _: None)
  rec = train_curve.record(curve, run, stream=False, lr=LR,
                           which="graphcast")
  assert rec["last_window_mean"] < rec["first_window_mean"], rec["losses"]
  assert rec["metric"] == "train_loss_descent_graphcast_30p0_20steps"


class _Box:
  """A stand-in FieldSet of one batch: a value and its seed."""

  def __init__(self, seed):
    self.seed = seed

  def astype(self, dtype):
    del dtype
    return self


class _Linear(torch.nn.Module):
  def __init__(self):
    super().__init__()
    self.w = torch.nn.Parameter(torch.ones(1))

  def loss(self, inputs, targets, forcings, **kwargs):
    del targets, forcings, kwargs
    return (self.w * (inputs.seed + 1.0)).reshape(1), {}


def test_stream_mode_takes_the_jax_scripts_seeds_and_eval_steps():
  """CURVE_STREAM=1: step i > 0 trains on seed i + 10, the held-out batch
  is seed 999, scored at every eval_every-th step and the last, as
  tools/train_curve.py does."""
  source = (TOOLS / "train_curve.py").read_text()
  for snippet in ("make_batch(i + 10)", "make_batch(999)", "PRNGKey(7)",
                  "i % eval_every == 0 or i == num_steps - 1",
                  '_env_int("CURVE_EVAL_EVERY", 5)'):
    assert snippet in source, snippet
  assert (train_curve.STREAM_SEED_OFFSET, train_curve.HELDOUT_SEED,
          train_curve.HELDOUT_NOISE_SEED) == (10, 999, 7)
  seeds = []

  def make_batch(seed):
    seeds.append(seed)
    return _Box(seed), _Box(seed), _Box(seed)

  model = _Linear()
  curve = train_curve.Curve(model, model, make_batch, "toy",
                            train_curve._no_kwargs)
  run = train_curve.run_curve(curve, 12, stream=True, eval_every=5,
                              log=lambda _: None)
  assert seeds == [0, 999] + [i + 10 for i in range(1, 12)]
  assert [s for s, _ in run["heldout"]] == [0, 5, 10, 11]
  rec = train_curve.record(curve, run, stream=True, lr=3e-4, which="x")
  assert rec["metric"] == "train_loss_descent_toy_12steps_stream"


def _gencast_preset():
  return zoo.GenCastPreset(
      name="tiny", resolution=30.0,
      task_config=configs.TaskConfig(**GENCAST_TASK),
      denoiser_architecture_config=denoiser.DenoiserArchitectureConfig(
          sparse_transformer_config=sparse_transformer.SparseTransformerConfig(
              attention_k_hop=2, d_model=16, num_layers=2, num_heads=2,
              attention_type="splash_mha", ffw_hidden=32, block_q=64),
          mesh_size=1, latent_size=16, hidden_layers=1),
      sampler_config=gencast.SamplerConfig(num_noise_levels=4),
      noise_config=gencast.NoiseConfig(),
      noise_encoder_config=denoiser.NoiseEncoderConfig(
          num_frequencies=8, output_sizes=(16, 8)))


def test_gencast_curve_finite_and_bit_equal_under_the_same_seeds():
  """The GenCast curve (stream mode, so the held-out loss too) twice from
  the same seeds: every loss finite and both series equal bit for bit."""
  runs = [train_curve.run_curve(
      train_curve.gencast_curve(_gencast_preset(), "cpu"), 2, stream=True,
      eval_every=1, log=lambda _: None) for _ in range(2)]
  assert all(np.isfinite(runs[0]["losses"]))
  assert runs[0]["losses"] == runs[1]["losses"]
  assert runs[0]["heldout"] == runs[1]["heldout"]
  assert len(set(runs[0]["losses"])) > 1


def _jax_record(script, target):
  """(keys, metric expression) of the JAX script's record: the dict
  literal assigned to ``target`` (or passed to json.dump) and its
  ``target[...] =`` assignments."""
  tree = ast.parse((TOOLS / script).read_text())
  keys, metric = set(), None
  for node in ast.walk(tree):
    d = None
    if isinstance(node, ast.Assign) and any(
        isinstance(t, ast.Name) and t.id == target for t in node.targets):
      d = node.value
    elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
          == "dump" and node.args and isinstance(node.args[0], ast.Dict)):
      d = node.args[0]
    if isinstance(d, ast.Dict):
      for k, v in zip(d.keys, d.values):
        keys.add(k.value)
        if k.value == "metric":
          metric = v
    if (target is not None and isinstance(node, ast.Assign)
        and isinstance(node.targets[0], ast.Subscript)
        and getattr(node.targets[0].value, "id", None) == target):
      keys.add(node.targets[0].slice.value)
  return keys, metric


def _jax_metric(expr, **names):
  return eval(compile(ast.Expression(expr), "<metric>", "eval"), {}, names)


EXTRA_KEYS = {"card", "power_limit"}


@pytest.mark.parametrize("stream", [False, True])
def test_train_curve_record_keys_and_metric_match_jax(stream):
  keys, metric = _jax_record("train_curve.py", "record")
  run = {"losses": [3.0, 2.5, 2.0], "heldout": [(0, 4.0), (2, 3.0)],
         "compile_s": 1.0, "s_per_step": 0.1}
  curve = train_curve.Curve(None, None, None, "graphcast_1p0", None)
  rec = train_curve.record(curve, run, stream=stream, lr=3e-4,
                           which="graphcast")
  want = {k for k in keys if stream or not k.startswith("heldout")}
  assert set(rec) == want
  assert rec["metric"] == _jax_metric(metric, tag="graphcast_1p0",
                                      num_steps=3, stream=stream)
  assert rec["drop_pct"] == round((1 - 2.0 / 3.0) * 100, 2)


def _fake_steps(monkeypatch, module):
  monkeypatch.setattr(module, "build_step", lambda *a, **k: (
      train_curve.Curve(None, None, None, "t", lambda i: {}), None, None))
  monkeypatch.setattr(bench_train_025, "time_steps", lambda *a, **k: {
      "first_s": 2.0, "loss0": 1.0, "times": [0.5, 0.4, 0.6],
      "peak_gb": None})


@pytest.mark.parametrize("resolution,levs", [(0.25, 37), (1.0, 13)])
def test_bench_train_025_record_matches_jax(monkeypatch, resolution, levs):
  monkeypatch.setenv("TRAIN_RESOLUTION", str(resolution))
  keys, metric = _jax_record("bench_train_025.py", None)
  _fake_steps(monkeypatch, bench_train_025)
  cfg = bench_train_025.training_config()
  assert cfg["task"].pressure_levels == (configs.TASK if resolution < 0.5
                                         else configs.TASK_13).pressure_levels
  assert (cfg["decode_chunks"], cfg["encode_chunks"]) == (
      (64, 50) if resolution < 0.5 else (1, 1))
  assert cfg["fused"] == "processor"
  rec = bench_train_025.run(3, torch.device("cpu"), cfg)
  assert set(rec) == keys | {"peak_gb"}
  assert rec["metric"] == _jax_metric(metric, resolution=resolution,
                                      levs=levs, ar_steps=3)
  assert rec["value"] == 0.4


def test_bench_train_gencast_record_matches_jax(monkeypatch):
  keys, metric = _jax_record("bench_train_gencast.py", None)
  _fake_steps(monkeypatch, bench_train_gencast)
  rec = bench_train_gencast.run(0.25, 6, torch.device("cpu"))
  assert set(rec) == keys | {"peak_gb"}
  assert rec["metric"] == _jax_metric(metric, resolution=0.25, mesh_size=6)
  args = bench_train_gencast.parse_args([])
  assert (args.resolution, args.mesh_size) == (1.0, 5)


def test_bench_gencast_rollout_record_matches_jax(monkeypatch, capsys):
  keys, metric = _jax_record("bench_gencast_rollout.py", None)
  monkeypatch.setenv("ROLLOUT_STEPS", "3")
  monkeypatch.setattr(bench_gencast_rollout, "build",
                      lambda *a: (None, None, None, None))
  monkeypatch.setattr(bench_gencast_rollout, "rollout", lambda *a: None)
  monkeypatch.setattr(bench_gencast_rollout, "final_mean", lambda p: 1.0)
  rec = bench_gencast_rollout.main(["--device", "cpu"])
  assert set(rec) == (keys - {"vs_baseline"}) | EXTRA_KEYS
  assert rec["metric"] == _jax_metric(metric, resolution=1.0, mesh_size=5,
                                      num_steps=3, members=2)
  assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec


def test_args_and_train_fused_parsed_and_refused_as_jax(monkeypatch):
  """AR steps from argv (an int, else refused); TRAIN_FUSED takes the JAX
  scripts' values and refuses any other."""
  tree = ast.parse((TOOLS / "bench_train_025.py").read_text())
  jax_values = next(
      {k.value for k in n.value.keys} for n in ast.walk(tree)
      if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "")
      == "fused_modes")
  assert set(bench_train_025.FUSED_MODES) == jax_values
  assert bench_train_025.parse_args(["4"]).ar_steps == 4
  assert bench_train_025.parse_args([]).ar_steps == 1
  args = memdump_train_025.parse_args([])
  assert (args.ar_steps, args.resolution, args.mesh_size) == (2, 0.25, 6)
  with pytest.raises(SystemExit):
    bench_train_025.parse_args(["two"])
  with pytest.raises(ValueError):
    int("two")  # the JAX script's int(sys.argv[1])
  for value in ("processor", "encoder", "0", "1"):
    monkeypatch.setenv("TRAIN_FUSED", value)
    assert (bench_train_025.training_config()["fused"]
            == bench_train_025.FUSED_MODES[value])
  monkeypatch.setenv("TRAIN_FUSED", "2")
  with pytest.raises(SystemExit, match="TRAIN_FUSED"):
    bench_train_025.training_config()
  monkeypatch.setenv("CURVE_MODEL", "other")
  with pytest.raises(SystemExit, match="CURVE_MODEL"):
    train_curve.main(["--device", "cpu"])


PORT = memory_trace.PACKAGE


def _alloc(addr, size, filename, line=1):
  return {"action": "alloc", "addr": addr, "size": size,
          "frames": [{"filename": "/x/torch/nn/functional.py", "line": 9,
                      "name": "linear"},
                     {"filename": filename, "line": line, "name": "f"}]}


def _free(addr, size):
  return [{"action": "free_requested", "addr": addr, "size": size},
          {"action": "free_completed", "addr": addr, "size": size}]


def test_memdump_summariser_replays_to_the_peak():
  a = f"{PORT}/models/graphcast.py"
  b = f"{PORT}/nn/core.py"
  trace = ([_alloc(1, 100, a, 10), _alloc(2, 300, b, 20)] + _free(1, 100)
           + [_alloc(3, 50, a, 10), _alloc(4, 60, a, 10),
              {"action": "segment_alloc", "addr": 0, "size": 4096}]
           + _free(2, 300) + [_alloc(5, 200, "/elsewhere/x.py", 3)])
  out = memory_trace.peak_breakdown({"device_traces": [trace]})
  assert out["peak_bytes"] == 410 and out["peak_event"] == 5
  assert out["sites"] == [
      {"site": "graphcast_tpu_torch/nn/core.py:20 f", "bytes": 300,
       "blocks": 1},
      {"site": "graphcast_tpu_torch/models/graphcast.py:10 f", "bytes": 110,
       "blocks": 2}]
  assert out["listed_bytes"] == 410
  summary = memory_trace.summary(out, 410, top=1)
  assert summary["listed_over_measured"] == 1.0
  assert summary["other_sites_gb"] == 110 / 1e9
  assert memory_trace.site([{"filename": "/elsewhere/x.py", "line": 3,
                             "name": "g"}]) == "/elsewhere/x.py:3 g"
  assert memory_trace.site([]) == memory_trace.NO_FRAME


DRIVERS = (train_curve, bench_gencast_rollout, bench_train_025,
           bench_train_gencast, memdump_train_025, memdump_gencast)


@pytest.mark.parametrize("driver", DRIVERS, ids=lambda m: m.__name__)
def test_drivers_raise_without_a_card(monkeypatch, driver):
  """No silent fallback: the default device is the card; without one a
  driver raises before it builds anything, and runs on the CPU only when
  asked (the memdumps, which need the allocator's history, refuse it)."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  assert driver.parse_args([]).device == "cuda"
  assert driver.parse_args([]).out is None
  with pytest.raises(RuntimeError, match="no CUDA device"):
    driver.main([])
  if driver in (memdump_train_025, memdump_gencast):
    with pytest.raises(SystemExit, match="card only"):
      driver.main(["--device", "cpu"])


def test_emit_writes_only_where_asked(tmp_path, capsys):
  out = tmp_path / "record.json"
  rec = common.emit({"metric": "m"}, torch.device("cpu"), str(out))
  assert rec == {"metric": "m", "card": "cpu", "power_limit": None}
  assert json.loads(out.read_text()) == rec
  assert json.loads(capsys.readouterr().out) == rec
  assert list(tmp_path.iterdir()) == [out]
