"""BENCHMARK.json against the benchmark's contract, and every piece it
names loaded by name: configurations, traffic mixes and their entries,
limits, and the per-layer metrics' readers."""

import json
import re

import pytest

from portbench import harness, readers
from portbench.tests.helpers import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_limits():
  assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  assert BENCH["paths"] == ["portbench"]
  assert 1 <= BENCH["run_seconds"] <= 51
  assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
  cells = len(BENCH["workloads"])
  four = sum(c["chips"] == 4 for c in BENCH["workloads"])
  assert four <= max(1, cells // 4)
  # A full check of 24 cells fits its 43200 s.
  assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= (
      43200)


def test_entries_have_just_their_keys_and_valid_names():
  for c in BENCH["configs"]:
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for text in (c["why"], c["source"]):
      assert 1 <= len(text) <= 200 and not set(text) & set("\n\t")
  for w in BENCH["workloads"]:
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert not set(w["why"]) & set("\n\t")
  names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
  assert len(names) == len(set(names))
  for m in BENCH["end_to_end"]:
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                       "source"}
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
  for m in BENCH["per_layer"]:
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                       "layer", "moves"}
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
  for m in BENCH["end_to_end"] + BENCH["per_layer"]:
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
  e2e = {m["name"]: m for m in BENCH["end_to_end"]}
  assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
  for w in BENCH["workloads"]:
    mine = [m["name"] for m in BENCH["end_to_end"]
            if harness.reports(m, w["name"])]
    assert "setup_s" in mine and len(mine) >= 2
    layers = [m for m in BENCH["per_layer"] if harness.reports(m, w["name"])]
    assert layers
    for m in layers:
      assert m["moves"] in mine, (w["name"], m["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_pieces_load_by_name(cell):
  w, cfg, traffic, limits = harness.resolve(BENCH, cell)
  assert cfg["source"]
  assert callable(harness.entry_class(traffic))
  assert limits and all(v > 0 for v in limits.values())
  config = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
  assert config["source"] == cfg["source"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads_and_reads_nothing_without_a_trace(metric):
  module = harness.reader(metric)
  ctx = readers.Context(cell={}, cfg={}, traffic={}, e2e={}, trace=None,
                        sizes={})
  assert module.read(ctx) is None


def _trace():
  """A traced sub-window of two steps in which every kernel the readers
  look for ran once a step for 10 ms, and the device idled a tenth."""
  from portbench.trace import Trace
  names = ["void gc::fused_edge_kernel<true, true, false>(gc::EdgeFwdMaps)",
           "void gc::fused_decoder_kernel<false>(gc::DecoderMaps)",
           "gc::splash_fwd_kernel(CUtensorMap_st, int)",
           "void gc::fused_edge_bwd_kernel<true, false>(gc::EdgeBwdMaps)",
           "void gc::fused_decoder_bwd_kernel<false, 0>(gc::DecoderBwdMaps)",
           "void at::native::multi_tensor_apply_kernel<Adam>()",
           "void at::native::elementwise_kernel<add>()"]
  return Trace(window_s=0.2, busy_s=0.18, steps=2,
               kernel_s={n: 0.02 for n in names},
               kernel_n={n: 2 for n in names}, gaps=[])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_reads_a_trace(metric):
  """Every reader gives a share between 0 and 100 % from a trace of each
  cell that it names, at the cell's configuration."""
  m = {x["name"]: x for x in BENCH["per_layer"]}[metric]
  sizes = {"num_grid": 1000, "num_mesh": 100, "g2m": 1500, "mesh": 600,
           "m2g": 3000, "mask_nnz": 2000, "batch": 2}
  for cell in m["workloads"]:
    _, cfg, traffic, _ = harness.resolve(BENCH, cell)
    ctx = readers.Context(cell={}, cfg=cfg, traffic=traffic,
                          e2e={m["moves"]: 1.0}, trace=_trace(), sizes=sizes)
    value = harness.reader(metric).read(ctx)
    assert value is not None and 0.0 < value <= 100.0, (cell, value)
