"""Shared pieces of the benchmark's CPU tests: the tiny configurations, a
BENCHMARK.json whose cells point at them, and the limits of the
comparisons at those sizes (``data/limits/``: the tiny sizes' bf16
readings spread wider than the cells')."""

import json
import pathlib

import torch

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
CPU = torch.device("cpu")
LIMITS = HERE / "data" / "limits"


def tiny_config(name: str = "graphcast_tiny") -> dict:
  return json.loads((HERE / "data" / f"{name}.json").read_text())


def tiny_bench() -> dict:
  """The repository's BENCHMARK.json with every configuration's file
  replaced by its CPU test size."""
  bench = json.loads((ROOT / "BENCHMARK.json").read_text())
  for c in bench["configs"]:
    c["file"] = f"portbench/tests/data/{c['name'].split('_')[0]}_tiny.json"
  return bench
