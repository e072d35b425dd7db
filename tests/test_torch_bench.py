"""The port's benchmark mirror (graphcast_tpu_torch/bench.py) on the CPU at
a tiny size: its result line's keys, and its metric name against the one
the repository's bench.py (JAX) builds from the same knobs."""

import importlib.util
import json
import pathlib

import pytest

from graphcast_tpu_torch import bench

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = {"BENCH_RESOLUTION": "30", "BENCH_MESH_SIZE": "1",
        "BENCH_LATENT": "16", "BENCH_MSG_STEPS": "2", "BENCH_NUM_STEPS": "2"}


@pytest.fixture
def tiny_knobs(monkeypatch, tmp_path):
  for name, value in TINY.items():
    monkeypatch.setenv(name, value)
  # bench.py's GraphCast caches its geometry artifact here (the JAX
  # package's default directory is this variable).
  monkeypatch.setenv("GRAPHCAST_TPU_CACHE", str(tmp_path))
  monkeypatch.setenv("BENCH_SKIP_GENCAST", "1")
  for name in ("BENCH_GENCAST", "BENCH_FALLBACK_ONLY", "BENCH_FUSED"):
    monkeypatch.delenv(name, raising=False)


def _jax_bench():
  spec = importlib.util.spec_from_file_location("jax_bench",
                                                REPO / "bench.py")
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


@pytest.mark.parametrize("pipelined", ["0", "1"])
def test_north_star_line_and_metric_name(tiny_knobs, monkeypatch, capsys,
                                         pipelined):
  monkeypatch.setenv("GC_PIPELINED_EDGE", pipelined)
  result = bench.main(device="cpu")
  printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
  assert printed == [result]
  assert set(result) == {"metric", "value", "unit", "card", "power_limit"}
  assert result["unit"] == "s" and result["value"] > 0
  assert result["card"] == "cpu" and result["power_limit"] is None
  assert "vs_baseline" not in result
  jax_metric, _, _ = _jax_bench()._bench_north_star(2)
  assert result["metric"] == jax_metric == (
      "graphcast_30.0deg_37lev_mesh1_2step_rollout")


def test_unported_bench_fused_value_raises(tiny_knobs, monkeypatch, capsys):
  """BENCH_FUSED=0 asks bench.py's XLA-only path. The port refused it
  until it had the unfused form (models/graphcast.py); now the mirror
  builds its model with ``fused_aggregation=False`` and prints its line."""
  from graphcast_tpu_torch.models import graphcast
  monkeypatch.setenv("BENCH_FUSED", "0")
  built = []
  init = graphcast.GraphCast.__init__

  def recording(self, *args, **kwargs):
    built.append(kwargs["fused_aggregation"])
    init(self, *args, **kwargs)

  monkeypatch.setattr(graphcast.GraphCast, "__init__", recording)
  result = bench.main(device="cpu")
  assert built == [False]
  assert result["value"] > 0
  assert json.loads(capsys.readouterr().out.splitlines()[-1]) == result


def test_gencast_and_skip_together_are_refused(tiny_knobs, monkeypatch):
  monkeypatch.setenv("BENCH_GENCAST", "1")
  with pytest.raises(SystemExit, match="BENCH_SKIP_GENCAST"):
    bench.main(device="cpu")


def test_bench_gencast_makes_the_gencast_line_the_result(monkeypatch):
  """BENCH_GENCAST=1: the GenCast path's line is the printed result, and
  no GraphCast path runs (the GenCast run itself is held to the JAX package
  in tests/test_torch_gencast.py)."""
  seen = {}

  def fake_bench_gencast(device):
    seen["device"] = device
    return "gencast_30.0deg_mesh1_splash_12h_step_40evals", 1.0, 2.0

  monkeypatch.setattr(bench, "_bench_gencast", fake_bench_gencast)
  for path in ("_bench_north_star", "_bench_fallback"):
    monkeypatch.setattr(bench, path, None)  # calling either would raise
  monkeypatch.setenv("BENCH_GENCAST", "1")
  monkeypatch.delenv("BENCH_SKIP_GENCAST", raising=False)
  result = bench.main(device="cpu")
  assert seen["device"] == "cpu"
  assert result == {"metric": "gencast_30.0deg_mesh1_splash_12h_step_40evals",
                    "value": 1.0, "unit": "s", "card": "cpu",
                    "power_limit": None}
