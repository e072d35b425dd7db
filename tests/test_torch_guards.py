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
          task, generator=torch.Generator().manual_seed(0))
      stats = synthetic.make_norm_stats(task)
      stack = Autoregressive(InputsAndResiduals(
          Bfloat16Cast(model), *stats))
      inputs, targets, forcings = synthetic.make_example_batch(
          task, 30.0, num_target_times=2)
      final = stack.rollout_final(inputs, targets, forcings)
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
          task, generator=torch.Generator().manual_seed(0))
      stack = Autoregressive(InputsAndResiduals(
          Bfloat16Cast(model), *synthetic.make_norm_stats(task)),
          gradient_checkpointing=True)
      before = [p.detach().clone() for p in model.parameters()]
      step = train.make_train_step(
          stack, train.graphcast_optimizer(model.parameters(), peak_lr=1e-3,
                                           warmup_steps=1))
      data = synthetic.make_example_batch(task, 30.0, num_target_times=2)
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
