"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: ``graphcast_tpu_torch`` begins with
``graphcast_tpu``), and the reference imports nothing of the program."""

import subprocess
import sys

from portbench.tests.helpers import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "graphcast_tpu")


def _top_level_modules(code: str) -> set:
  out = subprocess.run(
      [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
       "{m.split('.')[0] for m in sys.modules})))"],
      cwd=ROOT, capture_output=True, text=True, check=True,
      env={"PATH": "/usr/bin:/bin", "GRAPHCAST_TPU_CACHE": ""})
  return set(out.stdout.split())


def test_harness_and_its_entries_import_no_jax():
  found = _top_level_modules(
      "import glob, importlib, pathlib\n"
      "from portbench import harness, program\n"
      "for p in sorted(glob.glob('portbench/entries/*.py')) + sorted("
      "glob.glob('portbench/counts/*.py')):\n"
      "  importlib.import_module(p[:-3].replace('/', '.'))\n"
      "for p in sorted(glob.glob('portbench/metrics/*.py')):\n"
      "  harness.reader(pathlib.Path(p).stem)\n")
  assert not found & set(FORBIDDEN)
  assert "graphcast_tpu_torch" in found


def test_reference_imports_nothing_of_the_program_or_jax():
  found = _top_level_modules(
      "import glob, importlib\n"
      "for p in sorted(glob.glob('portbench/reference/*.py')):\n"
      "  importlib.import_module(p[:-3].replace('/', '.'))\n")
  assert not found & (set(FORBIDDEN) | {"graphcast_tpu_torch"})


def test_a_run_loads_no_jax():
  """A whole CPU run of a tiny cell, then the harness's own look."""
  found = _top_level_modules(
      "import time, torch\n"
      "from portbench import harness\n"
      "from portbench.tests.helpers import tiny_bench\n"
      "harness.run_cell(tiny_bench(), 'graphcast_0p25.forecast', 7, 0.5, "
      "False, torch.device('cpu'), time.perf_counter(), log=lambda *a, **k: "
      "None)\n"
      "assert not harness.forbidden_modules()\n")
  assert not found & set(FORBIDDEN)
