"""Guards against hidden fallbacks in graphcast_tpu_torch.

- Every module of the port imports, and a tiny model runs one step and one
  training step, and the benchmark mirror runs with the pipelined edge step
  (K1p's path), in a process where ``jax`` and ``graphcast_tpu`` cannot be
  imported.
- Building the CUDA kernels raises (and does not return) when nvcc is
  missing; the kernel wrappers raise instead of falling back to a twin.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from graphcast_tpu_torch.native import build

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_port_imports_and_runs_without_jax():
  code = textwrap.dedent("""
      import importlib, pkgutil, sys
      sys.modules["jax"] = None           # any `import jax` now raises
      sys.modules["graphcast_tpu"] = None
      import graphcast_tpu_torch
      names = [m.name for m in pkgutil.walk_packages(
          graphcast_tpu_torch.__path__, "graphcast_tpu_torch.")]
      for name in names:
        importlib.import_module(name)
      import torch
      from graphcast_tpu_torch.data import synthetic
      from graphcast_tpu_torch.models import configs
      from graphcast_tpu_torch.models.graphcast import GraphCast
      from graphcast_tpu_torch.wrappers import (
          Autoregressive, Bfloat16Cast, InputsAndResiduals)
      task = configs.TaskConfig(
          input_variables=("2m_temperature", "toa_incident_solar_radiation",
                           "land_sea_mask"),
          target_variables=("2m_temperature",),
          forcing_variables=("toa_incident_solar_radiation",),
          pressure_levels=(500,), input_duration="12h")
      model = GraphCast(
          configs.ModelConfig(resolution=30.0, mesh_size=1, latent_size=8,
                              gnn_msg_steps=1),
          task, generator=torch.Generator().manual_seed(0), device="cpu")
      stats = synthetic.make_norm_stats(task, device="cpu")
      stack = Autoregressive(InputsAndResiduals(
          Bfloat16Cast(model), *stats))
      inputs, targets, forcings = synthetic.make_example_batch(
          task, 30.0, num_target_times=2, device="cpu")
      final = stack.rollout_final(inputs, targets, forcings)
      assert torch.isfinite(final.data("2m_temperature")).all()
      # Batch 2: the general message-passing path and K3's plain version.
      batch2 = synthetic.make_example_batch(
          task, 30.0, batch=2, num_target_times=2, device="cpu")
      final = stack.rollout_final(*batch2)
      assert final.data("2m_temperature").shape[0] == 2
      assert torch.isfinite(final.data("2m_temperature")).all()
      assert not any(m == "jax" or m.startswith(("jax.", "graphcast_tpu."))
                     for m in sys.modules if sys.modules[m] is not None)
      print("modules", len(names))
      """)
  env = {**os.environ, "PYTHONPATH": str(REPO)}
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, env=env, cwd=REPO, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert int(proc.stdout.split()[-1]) >= 20, proc.stdout


def test_train_step_runs_without_jax():
  code = textwrap.dedent("""
      import sys
      sys.modules["jax"] = None           # any `import jax` now raises
      sys.modules["graphcast_tpu"] = None
      import torch
      from graphcast_tpu_torch import train
      from graphcast_tpu_torch.data import synthetic
      from graphcast_tpu_torch.models import configs
      from graphcast_tpu_torch.models.graphcast import GraphCast
      from graphcast_tpu_torch.wrappers import (
          Autoregressive, Bfloat16Cast, InputsAndResiduals)
      task = configs.TaskConfig(
          input_variables=("2m_temperature", "toa_incident_solar_radiation",
                           "land_sea_mask"),
          target_variables=("2m_temperature",),
          forcing_variables=("toa_incident_solar_radiation",),
          pressure_levels=(500,), input_duration="12h")
      model = GraphCast(
          configs.ModelConfig(resolution=30.0, mesh_size=1, latent_size=8,
                              gnn_msg_steps=1),
          task, generator=torch.Generator().manual_seed(0), device="cpu")
      stack = Autoregressive(InputsAndResiduals(
          Bfloat16Cast(model),
          *synthetic.make_norm_stats(task, device="cpu")),
          gradient_checkpointing=True)
      before = [p.detach().clone() for p in model.parameters()]
      step = train.make_train_step(
          stack, train.graphcast_optimizer(model.parameters(), peak_lr=1e-3,
                                           warmup_steps=1))
      data = synthetic.make_example_batch(task, 30.0, num_target_times=2,
                                          device="cpu")
      losses = [float(step(*data)[0]) for _ in range(2)]
      assert all(torch.isfinite(torch.tensor(losses)))
      assert any(not torch.equal(a, p) for a, p in zip(before,
                                                      model.parameters()))
      assert not any(m == "jax" or m.startswith(("jax.", "graphcast_tpu."))
                     for m in sys.modules if sys.modules[m] is not None)
      print("losses", *losses)
      """)
  env = {**os.environ, "PYTHONPATH": str(REPO)}
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, env=env, cwd=REPO, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.startswith("losses"), proc.stdout


def test_memory_forms_run_without_jax(tmp_path):
  """The memory forms with jax unimportable: an AR-2 train step of
  GraphCast in the 0.25° training form with both host offloads, a chunked
  unfused GenCast denoiser evaluation at batch 2, and the geometry
  artifact written to and read from the disk cache."""
  code = textwrap.dedent(f"""
      import sys
      sys.modules["jax"] = None           # any `import jax` now raises
      sys.modules["graphcast_tpu"] = None
      import torch
      from graphcast_tpu_torch import train
      from graphcast_tpu_torch.data import synthetic
      from graphcast_tpu_torch.geometry import artifact
      from graphcast_tpu_torch.models import configs, zoo
      from graphcast_tpu_torch.models.graphcast import GraphCast
      from graphcast_tpu_torch.wrappers import (
          Autoregressive, Bfloat16Cast, InputsAndResiduals)
      task = configs.TaskConfig(
          input_variables=("2m_temperature", "toa_incident_solar_radiation",
                           "land_sea_mask"),
          target_variables=("2m_temperature",),
          forcing_variables=("toa_incident_solar_radiation",),
          pressure_levels=(500,), input_duration="12h")
      model = GraphCast(
          configs.ModelConfig(resolution=30.0, mesh_size=1, latent_size=8,
                              gnn_msg_steps=4),
          task, cache_dir={str(tmp_path)!r}, decode_chunks=4,
          encode_chunks=3, fused_aggregation="processor",
          remat_processor=True, generator=torch.Generator().manual_seed(0),
          device="cpu")
      stack = Autoregressive(InputsAndResiduals(
          Bfloat16Cast(model),
          *synthetic.make_norm_stats(task, device="cpu")),
          gradient_checkpointing=True, loss_scan_unroll=4,
          loss_carry_offload=True, loss_offload_processor_carries=True)
      step = train.make_train_step(
          stack, train.graphcast_optimizer(model.parameters(), peak_lr=1e-3,
                                           warmup_steps=1))
      data = synthetic.make_example_batch(task, 30.0, num_target_times=2,
                                          device="cpu")
      losses = [float(step(*data)[0]) for _ in range(2)]
      assert all(torch.isfinite(torch.tensor(losses)))
      lat, lon = synthetic.grid_coords(30.0)
      again = artifact.build_artifact(lat, lon, 1,
                                      cache_dir={str(tmp_path)!r})
      assert (again.grid2mesh.senders == model._artifact.grid2mesh.senders
              ).all()
      preset = zoo.gencast_custom(30.0, 1, d_model=16, num_layers=1,
                                  num_heads=2, latent_size=16)
      gencast = preset.build(generator=torch.Generator().manual_seed(0),
                             device="cpu", encode_chunks=3, decode_chunks=4,
                             fused_aggregation=False, cache_dir="")
      inputs, targets, forcings = synthetic.make_example_batch(
          preset.task_config, 30.0, batch=2, time_step_hours=12,
          device="cpu")
      with torch.inference_mode():
        out = gencast.denoise(inputs, targets, torch.tensor([80.0, 1.0]),
                              forcings)
      assert torch.isfinite(out.data("2m_temperature")).all()
      assert not any(m == "jax" or m.startswith(("jax.", "graphcast_tpu."))
                     for m in sys.modules if sys.modules[m] is not None)
      print("losses", *losses)
      """)
  env = {**os.environ, "PYTHONPATH": str(REPO)}
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, env=env, cwd=REPO, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.startswith("losses"), proc.stdout
  assert len(list(tmp_path.glob("artifact_*.npz"))) == 1


def test_bench_mirror_and_pipelined_step_run_without_jax():
  code = textwrap.dedent("""
      import json, os, sys
      sys.modules["jax"] = None
      sys.modules["graphcast_tpu"] = None
      os.environ.update(BENCH_RESOLUTION="30", BENCH_MESH_SIZE="1",
                        BENCH_LATENT="16", BENCH_MSG_STEPS="2",
                        BENCH_NUM_STEPS="2", BENCH_SKIP_GENCAST="1",
                        GC_PIPELINED_EDGE="1")
      import numpy as np
      import torch
      from graphcast_tpu_torch import bench
      from graphcast_tpu_torch.ops.fused_edge import EdgeIndex, fused_edge
      result = bench.main(device="cpu")
      assert result["metric"] == "graphcast_30.0deg_37lev_mesh1_2step_rollout"
      edges = EdgeIndex(np.array([0, 1, 1]), np.array([0, 0, 1]), 2, 2)
      r = lambda *s: torch.randn(*s)
      out = fused_edge(edges, r(3, 8), r(2, 8), r(2, 8), r(8, 8), r(8),
                       r(8, 8), r(8), r(8), r(8), pipelined=True)
      assert all(torch.isfinite(t).all() for t in out)
      assert not any(m == "jax" or m.startswith(("jax.", "graphcast_tpu."))
                     for m in sys.modules if sys.modules[m] is not None)
      print("mirror", json.dumps(result))
      """)
  env = {**os.environ, "PYTHONPATH": str(REPO)}
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, env=env, cwd=REPO, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.splitlines()[-1].startswith("mirror"), proc.stdout


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
  monkeypatch.setattr(build.shutil, "which", lambda name: None)
  monkeypatch.setenv("CUDA_HOME", str(tmp_path))  # no bin/nvcc in there
  monkeypatch.setattr(build, "_lib", None)
  with pytest.raises(RuntimeError, match="nvcc not found"):
    build.load_library()
  with pytest.raises(RuntimeError, match="nvcc not found"):
    build.find_nvcc()


def test_build_raises_without_cuda_device(monkeypatch, tmp_path):
  fake = tmp_path / "bin" / "nvcc"
  fake.parent.mkdir()
  fake.write_text("#!/bin/sh\nexit 1\n")
  fake.chmod(0o755)
  monkeypatch.setattr(build.shutil, "which", lambda name: None)
  monkeypatch.setenv("CUDA_HOME", str(tmp_path))
  monkeypatch.setattr(build, "_lib", None)
  monkeypatch.setattr(build.torch.cuda, "is_available", lambda: False)
  assert build.find_nvcc() == str(fake)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    build.load_library()


def test_failed_compile_raises_with_compiler_message(monkeypatch, tmp_path):
  fake = tmp_path / "nvcc"
  fake.write_text("#!/bin/sh\necho 'error: fake compiler says no' >&2\n"
                  "exit 2\n")
  fake.chmod(0o755)
  monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
  with pytest.raises(RuntimeError, match="fake compiler says no"):
    build._compile(str(fake))
  assert not list((tmp_path / "build").glob("*.so"))


def test_gencast_samples_without_jax():
  code = textwrap.dedent("""
      import sys
      sys.modules["jax"] = None
      sys.modules["graphcast_tpu"] = None
      import torch
      from graphcast_tpu_torch.data import synthetic
      from graphcast_tpu_torch.models import configs, denoiser, gencast
      from graphcast_tpu_torch.models import sparse_transformer
      from graphcast_tpu_torch.wrappers import InputsAndResiduals, NaNCleaner
      task = configs.TaskConfig(
          input_variables=("2m_temperature", "sea_surface_temperature",
                           "day_progress_sin", "land_sea_mask"),
          target_variables=("2m_temperature", "sea_surface_temperature"),
          forcing_variables=("day_progress_sin",),
          pressure_levels=(500,), input_duration="24h")
      model = gencast.GenCast(
          task, denoiser.DenoiserArchitectureConfig(
              sparse_transformer_config=(
                  sparse_transformer.SparseTransformerConfig(
                      attention_k_hop=2, d_model=8, num_layers=1,
                      num_heads=2, ffw_hidden=16)),
              mesh_size=1, latent_size=8),
          gencast.SamplerConfig(num_noise_levels=3),
          noise_encoder_config=denoiser.NoiseEncoderConfig(
              num_frequencies=4, output_sizes=(8, 4)),
          generator=torch.Generator().manual_seed(0), device="cpu")
      stack = NaNCleaner(InputsAndResiduals(
          model, *synthetic.make_norm_stats(task, device="cpu")),
          var_to_clean="sea_surface_temperature", fill_value=0.0)
      data = synthetic.make_example_batch(task, 30.0, time_step_hours=12,
                                          device="cpu")
      with torch.inference_mode():
        out = stack(*data, generator=torch.Generator().manual_seed(1))
      assert torch.isfinite(out.data("2m_temperature")).all()
      # A 2-member, 2-chunk ensemble: the denoiser's general path.
      from graphcast_tpu_torch import rollout
      inputs, targets, forcings = synthetic.make_example_batch(
          task, 30.0, time_step_hours=12, num_target_times=2, device="cpu")
      ens = rollout.chunked_ensemble_prediction(
          stack, torch.Generator().manual_seed(2), inputs, targets,
          forcings, num_samples=2)
      t = ens.data("2m_temperature")
      assert t.shape[:2] == (2, 2) and torch.isfinite(t).all()
      assert not torch.equal(t[0], t[1])
      assert not any(m == "jax" or m.startswith(("jax.", "graphcast_tpu."))
                     for m in sys.modules if sys.modules[m] is not None)
      print("sampled", tuple(out.data("2m_temperature").shape))
      """)
  env = {**os.environ, "PYTHONPATH": str(REPO)}
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, env=env, cwd=REPO, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.startswith("sampled"), proc.stdout


def test_gencast_train_step_runs_without_jax():
  code = textwrap.dedent("""
      import sys
      sys.modules["jax"] = None
      sys.modules["graphcast_tpu"] = None
      import torch
      from graphcast_tpu_torch import train
      from graphcast_tpu_torch.data import synthetic
      from graphcast_tpu_torch.models import configs, denoiser, gencast
      from graphcast_tpu_torch.models import sparse_transformer
      from graphcast_tpu_torch.wrappers import InputsAndResiduals, NaNCleaner
      task = configs.TaskConfig(
          input_variables=("2m_temperature", "sea_surface_temperature",
                           "day_progress_sin", "land_sea_mask"),
          target_variables=("2m_temperature", "sea_surface_temperature"),
          forcing_variables=("day_progress_sin",),
          pressure_levels=(500,), input_duration="24h")
      model = gencast.GenCast(
          task, denoiser.DenoiserArchitectureConfig(
              sparse_transformer_config=(
                  sparse_transformer.SparseTransformerConfig(
                      attention_k_hop=2, d_model=8, num_layers=1,
                      num_heads=2, ffw_hidden=16)),
              mesh_size=1, latent_size=8),
          noise_config=gencast.NoiseConfig(),
          noise_encoder_config=denoiser.NoiseEncoderConfig(
              num_frequencies=4, output_sizes=(8, 4)),
          generator=torch.Generator().manual_seed(0), device="cpu")
      stack = NaNCleaner(InputsAndResiduals(
          model, *synthetic.make_norm_stats(task, device="cpu")),
          var_to_clean="sea_surface_temperature", fill_value=0.0)
      data = synthetic.make_example_batch(task, 30.0, time_step_hours=12,
                                          device="cpu")
      before = [p.detach().clone() for p in model.parameters()]
      step = train.make_train_step(
          stack, train.graphcast_optimizer(model.parameters(), peak_lr=1e-3,
                                           warmup_steps=1))
      losses = [float(step(*data, generator=torch.Generator().manual_seed(s))[0])
                for s in (1, 2)]
      assert all(torch.isfinite(torch.tensor(losses)))
      assert any(not torch.equal(a, p) for a, p in zip(before,
                                                      model.parameters()))
      assert not any(m == "jax" or m.startswith(("jax.", "graphcast_tpu."))
                     for m in sys.modules if sys.modules[m] is not None)
      print("losses", *losses)
      """)
  env = {**os.environ, "PYTHONPATH": str(REPO)}
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, env=env, cwd=REPO, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.startswith("losses"), proc.stdout


def test_port_sources_name_no_jax_package():
  """No module of the port, nor chip_smoke.py or edge_study.py, imports
  jax or graphcast_tpu (the subprocess tests above prove the imports; this
  finds a lazy import inside a function too)."""
  import re
  pattern = re.compile(
      r"^\s*(import\s+(jax|graphcast_tpu)([.\s,]|$)"
      r"|from\s+(jax|graphcast_tpu)(\.\w+)*\s+import\b)", re.MULTILINE)
  files = sorted((REPO / "graphcast_tpu_torch").rglob("*.py"))
  assert {f.name for f in files if f.parent.name == "tools"} >= {
      "train_curve.py", "bench_gencast_rollout.py", "bench_train_025.py",
      "bench_train_gencast.py", "memdump_train_025.py",
      "memdump_gencast.py"}
  files += [REPO / "chip_smoke.py", REPO / "edge_study.py"]
  offenders = [str(f) for f in files if pattern.search(f.read_text())]
  assert not offenders, offenders


def test_port_tools_write_no_root_records():
  """The TPU's records at the repository's root (TRAINCURVE_*, BENCH_*,
  MULTICHIP_*) are never a port tool's output: a tool writes only the
  path given with --out (none by default), and no string in the tools
  names such a file."""
  import ast
  import importlib
  import re
  root_record = re.compile(r"(TRAINCURVE|BENCH|MULTICHIP)_\w*(\.json)?$")
  tools = REPO / "graphcast_tpu_torch" / "tools"
  drivers = ("train_curve", "bench_gencast_rollout", "bench_train_025",
             "bench_train_gencast", "memdump_train_025", "memdump_gencast")
  for name in drivers:
    module = importlib.import_module(f"graphcast_tpu_torch.tools.{name}")
    assert module.parse_args([]).out is None, name
  for path in sorted(tools.glob("*.py")):
    strings = [n.value for n in ast.walk(ast.parse(path.read_text()))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    named = [v for v in strings if any(
        root_record.match(word) for word in re.split(r"[\s/'\"`]+", v))]
    assert not named, (path.name, named)


def test_demo_path_runs_without_jax_pandas_or_xarray():
  """The demo path (bundle → ERA5-shaped data → derived variables and TISR
  → extraction → forecast → scores) in a process where jax, pandas and
  xarray cannot be imported, as on the card's machine."""
  code = textwrap.dedent("""
      import io, sys
      for name in ("jax", "graphcast_tpu", "pandas", "xarray"):
        sys.modules[name] = None          # any import of them now raises
      import torch
      from graphcast_tpu_torch import evaluation
      from graphcast_tpu_torch.compat import haiku_checkpoint
      from graphcast_tpu_torch.data import era5, synthetic
      from graphcast_tpu_torch.models import configs
      from graphcast_tpu_torch.models.graphcast import GraphCast
      from graphcast_tpu_torch.wrappers import (
          Autoregressive, Bfloat16Cast, InputsAndResiduals)
      task = configs.TaskConfig(
          input_variables=("2m_temperature", "temperature",
                           "toa_incident_solar_radiation",
                           "day_progress_sin", "land_sea_mask"),
          target_variables=("2m_temperature", "temperature"),
          forcing_variables=("toa_incident_solar_radiation",
                             "day_progress_sin"),
          pressure_levels=(500, 850), input_duration="12h")
      mc = configs.ModelConfig(resolution=30.0, mesh_size=1, latent_size=8,
                               gnn_msg_steps=1)
      bundle = io.BytesIO()
      haiku_checkpoint.save_graphcast_checkpoint(
          bundle, GraphCast(mc, task, generator=torch.Generator().manual_seed(0),
                            device="cpu"), mc, task)
      bundle.seek(0)
      model, mc, task, _, _ = haiku_checkpoint.load_graphcast_checkpoint(
          bundle, device="cpu")
      data = synthetic.make_era5_dataset(task, 30.0, num_times=4,
                                         device="cpu")
      data = era5.add_tisr_var(era5.add_derived_vars(data))
      inputs, targets, forcings = era5.extract_inputs_targets_forcings(
          data, input_variables=task.input_variables,
          target_variables=task.target_variables,
          forcing_variables=task.forcing_variables,
          pressure_levels=task.pressure_levels,
          input_duration=task.input_duration,
          target_lead_times=slice("6h", "12h"))
      stats = synthetic.make_norm_stats(task, device="cpu")
      stack = Autoregressive(InputsAndResiduals(Bfloat16Cast(model), *stats))
      preds = stack(inputs, targets, forcings)
      scores = [*evaluation.rmse(preds, targets).values(),
                *evaluation.acc(preds, targets, stats[1]).values()]
      assert all(torch.isfinite(v).all() for v in scores)
      loaded = [m for m in ("jax", "pandas", "xarray", "graphcast_tpu")
                if sys.modules.get(m) is not None]
      assert not loaded, loaded
      print("scores", len(scores))
      """)
  env = {**os.environ, "PYTHONPATH": str(REPO)}
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, env=env, cwd=REPO, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.split() == ["scores", "4"], proc.stdout


@pytest.mark.parametrize("package", ["pandas", "xarray"])
def test_port_sources_import_no_pandas_and_xarray_only_in_the_bridge(
    package):
  """No module of the port, nor chip_smoke.py, imports pandas (the card's
  machine has none); xarray is imported only inside the gated bridge."""
  import re
  pattern = re.compile(rf"^\s*(import\s+{package}([.\s,]|$)"
                       rf"|from\s+{package}(\.\w+)*\s+import\b)",
                       re.MULTILINE)
  files = sorted((REPO / "graphcast_tpu_torch").rglob("*.py"))
  files += [REPO / "chip_smoke.py", REPO / "edge_study.py"]
  allowed = {REPO / "graphcast_tpu_torch" / "xarray_bridge.py"} if (
      package == "xarray") else set()
  offenders = [str(f) for f in files
               if f not in allowed and pattern.search(f.read_text())]
  assert not offenders, offenders


@pytest.mark.parametrize("case", ["splash_head_dim", "splash_dtype",
                                  "splash_backward_cpu",
                                  "edge_embed_features", "edge_embed_ew0",
                                  "edge_pipelined_width",
                                  "decoder_embed_features",
                                  "segment_sum_dtype", "segment_sum_rows",
                                  "segment_sum_channels",
                                  "segment_sum_layout"])
def test_new_kernel_wrappers_refuse_inputs_before_launching(case,
                                                            monkeypatch):
  """K3, K6, K7/K8 and the embed modes check their operands and raise
  before any launch (the library load is made to fail loudly); no path
  falls back to a plain version."""
  import numpy as np
  import torch
  from graphcast_tpu_torch.ops import (
      fused_decoder, fused_edge, segment_sum, splash)

  def no_launch():
    raise AssertionError("a kernel was launched")

  monkeypatch.setattr(build, "load_library", no_launch)
  bf16 = torch.bfloat16
  if case.startswith("segment_sum"):
    edges = fused_edge.EdgeIndex(np.zeros(6, np.int32),
                                 np.array([0, 0, 1, 3, 3, 3], np.int32), 2, 5)
    msgs = {"segment_sum_dtype": torch.zeros(6, 16, dtype=torch.float16),
            "segment_sum_rows": torch.zeros(5, 16, dtype=bf16),
            "segment_sum_channels": torch.zeros(6, 12, dtype=bf16),
            "segment_sum_layout": torch.zeros(16, 6, dtype=bf16).t()}[case]
    with pytest.raises((TypeError, ValueError)):
      segment_sum._launch_segment_sum(edges, msgs)
    with pytest.raises(AssertionError, match="launched"):
      segment_sum._launch_segment_sum(edges, torch.zeros(6, 16, dtype=bf16))
    return
  if case.startswith("splash"):
    mask = __import__("scipy.sparse").sparse.identity(64, format="csr")
    bm = splash.build_block_map(mask)
    if case == "splash_backward_cpu":
      h = torch.zeros(2, 64, 128, dtype=bf16)
      f = torch.zeros(2, 64)
      for kernel in (splash.splash_dq, splash.splash_dkv):
        with pytest.raises(ValueError, match="CUDA"):
          kernel(h, h, h, h, f, f, bm, 1.0)
      return
    d, dtype, err = ((64, bf16, ValueError) if case == "splash_head_dim"
                     else (128, torch.float32, TypeError))
    q = torch.zeros(1, 64, 2, d, dtype=dtype)
    with pytest.raises(err):
      splash._launch_splash(q, q, q, bm, 1.0)
    return
  C = 128
  m = lambda *s: torch.zeros(*s, dtype=bf16)  # noqa: E731
  v = lambda: torch.zeros(C)  # noqa: E731
  if case == "edge_pipelined_width":
    edges = fused_edge.EdgeIndex(np.zeros(4, np.int32),
                                 np.arange(4, dtype=np.int32), 2, 4)
    W = 192  # K1p takes K1's widths, the multiples of 128 up to 512
    mw = lambda *s: torch.zeros(*s, dtype=bf16)  # noqa: E731
    with pytest.raises(ValueError, match="latent width 192"):
      fused_edge._launch_fused_edge(
          edges, mw(4, W), mw(2, W), mw(4, W), mw(W, W), torch.zeros(W),
          mw(W, W), torch.zeros(W), torch.zeros(W), torch.zeros(W), True,
          True)
    return
  if case.startswith("edge"):
    edges = fused_edge.EdgeIndex(np.zeros(4, np.int32),
                                 np.arange(4, dtype=np.int32), 2, 4)
    F = fused_edge.MAX_EMBED_FEATURES + 1 if case == "edge_embed_features" \
        else 4
    ew0 = m(F + 1 if case == "edge_embed_ew0" else F, C)
    with pytest.raises(ValueError):
      fused_edge._launch_fused_edge_embed(
          edges, m(4, F), m(2, C), m(4, C), m(C, C), v(), m(C, C), v(), v(),
          v(), (ew0, v(), m(C, C), v()), False)
    return
  G, F = 4, fused_edge.MAX_EMBED_FEATURES + 1
  edges = fused_edge.EdgeIndex(np.zeros(3 * G, np.int32),
                               np.repeat(np.arange(G, dtype=np.int32), 3),
                               2, G)
  weights = {k: m(C, C) for k in fused_decoder.MATRICES}
  weights.update({k: v() for k in fused_decoder.VECTORS})
  weights.update(ew0=m(F, C), eb0=v(), ew1=m(C, C), eb1=v(), we=m(C, C),
                 b0=v())
  with pytest.raises(ValueError, match="raw"):
    fused_decoder._launch_fused_decode(edges, m(G, C), m(2, C),
                                       m(3 * G, F), weights)


def test_parallel_and_dry_run_run_without_jax(tmp_path):
  """graphcast_tpu_torch.parallel and graft_entry import, and a
  one-process mesh trains a data-parallel GraphCast step, with ``jax`` and
  ``graphcast_tpu`` unimportable."""
  code = textwrap.dedent(f"""
      import sys
      sys.modules["jax"] = None
      sys.modules["graphcast_tpu"] = None
      import torch
      import torch.distributed as dist
      from graphcast_tpu_torch import graft_entry, train
      from graphcast_tpu_torch.parallel import (
          collectives, launch, sharding)
      from graphcast_tpu_torch.data import synthetic
      from graphcast_tpu_torch.models import configs
      from graphcast_tpu_torch.models.graphcast import GraphCast
      assert graft_entry.mesh_axes(8) == {{"batch": 2, "model": 2, "sp": 2}}
      dist.init_process_group("gloo", init_method="file://{tmp_path}/r",
                              world_size=1, rank=0)
      mesh = sharding.make_mesh({{"batch": 1, "model": 1}})
      task = configs.TaskConfig(
          input_variables=("2m_temperature", "toa_incident_solar_radiation",
                           "land_sea_mask"),
          target_variables=("2m_temperature",),
          forcing_variables=("toa_incident_solar_radiation",),
          pressure_levels=(500,), input_duration="12h")
      model = GraphCast(configs.ModelConfig(
          resolution=30.0, mesh_size=1, latent_size=16, gnn_msg_steps=1,
          hidden_layers=1), task, generator=torch.Generator().manual_seed(0),
          device="cpu")
      sharding.shard_params_tensor_parallel(model, mesh)
      data = train.shard_batch(mesh, *synthetic.make_example_batch(
          task, 30.0, device="cpu"))
      step = train.make_train_step(
          model, train.graphcast_optimizer(model.parameters()), mesh)
      loss, _ = step(*data)
      dist.destroy_process_group()
      assert torch.isfinite(loss)
      assert not any(m == "jax" or m.startswith(("jax.", "graphcast_tpu."))
                     for m in sys.modules if sys.modules[m] is not None)
      print("trained", float(loss))
      """)
  env = {**os.environ, "PYTHONPATH": str(REPO)}
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, env=env, cwd=REPO, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.startswith("trained"), proc.stdout


def test_entry_points_default_to_the_card(monkeypatch):
  """Model constructors, the synthetic data and the multi-step drivers
  (graphcast_tpu_torch/tools/) name no device by default: they run on the
  card, and where torch sees none they raise instead of running quietly on
  the CPU."""
  import torch
  from graphcast_tpu_torch import devices
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import configs, zoo
  from graphcast_tpu_torch.models.graphcast import GraphCast
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  assert devices.DEFAULT_DEVICE == "cuda"
  task = configs.TaskConfig(
      input_variables=("2m_temperature",), target_variables=("2m_temperature",),
      forcing_variables=(), pressure_levels=(500,), input_duration="12h")
  calls = [
      lambda: GraphCast(configs.ModelConfig(resolution=30.0, mesh_size=1,
                                            latent_size=8, gnn_msg_steps=1),
                        task, generator=torch.Generator()),
      lambda: zoo.gencast_mini().build(generator=torch.Generator()),
      lambda: synthetic.make_example_batch(task, 30.0),
      lambda: synthetic.make_norm_stats(task),
  ]
  from graphcast_tpu_torch.tools import (
      bench_gencast_rollout, bench_train_025, bench_train_gencast,
      memdump_gencast, memdump_train_025, train_curve)
  calls += [(lambda tool=tool: tool.main([])) for tool in (
      train_curve, bench_gencast_rollout, bench_train_025,
      bench_train_gencast, memdump_train_025, memdump_gencast)]
  for call in calls:
    with pytest.raises(RuntimeError, match="no CUDA device"):
      call()
  assert devices.resolve("cpu") == torch.device("cpu")


def test_spawn_defaults_to_the_card(monkeypatch):
  """parallel/launch.py spawn runs its ranks on the card unless asked for
  the CPU: without a card the default raises before any process starts."""
  import torch
  from graphcast_tpu_torch.parallel import launch
  started = []
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  monkeypatch.setattr(launch.mp, "start_processes",
                      lambda *a, **k: started.append(k))
  with pytest.raises(RuntimeError, match="no CUDA device"):
    launch.spawn(print, 2)
  assert not started
  launch.spawn(print, 2, device="cpu")
  assert started and started[0]["nprocs"] == 2
