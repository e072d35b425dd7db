"""Guards against hidden fallbacks in graphcast_tpu_torch.

- Every module of the port imports, and a tiny model runs one step and one
  training step, in a process where ``jax`` and ``graphcast_tpu`` cannot
  be imported.
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
  """No module of the port, nor chip_smoke.py, imports jax or
  graphcast_tpu (the subprocess tests above prove the imports; this finds
  a lazy import inside a function too)."""
  import re
  pattern = re.compile(
      r"^\s*(import\s+(jax|graphcast_tpu)([.\s,]|$)"
      r"|from\s+(jax|graphcast_tpu)(\.\w+)*\s+import\b)", re.MULTILINE)
  files = sorted((REPO / "graphcast_tpu_torch").rglob("*.py"))
  files.append(REPO / "chip_smoke.py")
  offenders = [str(f) for f in files if pattern.search(f.read_text())]
  assert not offenders, offenders


@pytest.mark.parametrize("case", ["splash_head_dim", "splash_dtype",
                                  "splash_backward_cpu",
                                  "edge_embed_features", "edge_embed_ew0",
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
  if case.startswith("edge"):
    edges = fused_edge.EdgeIndex(np.zeros(4, np.int32),
                                 np.arange(4, dtype=np.int32), 2, 4)
    F = fused_edge.MAX_EMBED_FEATURES + 1 if case == "edge_embed_features" \
        else 4
    ew0 = m(F + 1 if case == "edge_embed_ew0" else F, C)
    with pytest.raises(ValueError):
      fused_edge._launch_fused_edge_embed(
          edges, m(4, F), m(2, C), m(4, C), m(C, C), v(), m(C, C), v(), v(),
          v(), (ew0, v(), m(C, C), v()))
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


def test_ensemble_over_a_device_mesh_is_not_ported():
  from graphcast_tpu_torch import rollout

  def never(**kwargs):
    raise AssertionError("the predictor ran")

  with pytest.raises(NotImplementedError, match="mesh"):
    rollout.chunked_ensemble_prediction(never, None, None, None, None,
                                        num_samples=2, mesh=object())


def test_entry_points_default_to_the_card(monkeypatch):
  """Model constructors and the synthetic data name no device by default:
  they run on the card, and where torch sees none they raise instead of
  running quietly on the CPU."""
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
  for call in calls:
    with pytest.raises(RuntimeError, match="no CUDA device"):
      call()
  assert devices.resolve("cpu") == torch.device("cpu")
