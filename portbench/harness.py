"""One run of one benchmark cell: set-up, the measured window, the traced
sub-window (``--trace 1``), the comparison with the plain reference, and
the result line.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``portbench/configs/<config>.json``, its traffic mix in
``portbench/traffic/<traffic>.json`` (whose ``entry`` names the general
entry in ``portbench/entries/``), the limits of its comparison in
``portbench/limits/<cell>.json`` and each per-layer metric's reader in
``portbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / "_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "graphcast_tpu")


def cache_environment() -> dict[str, str]:
  """Fixed cache directories inside the checkout: the program's geometry
  cache and the CUDA driver's cache of compiled code."""
  return {"GRAPHCAST_TPU_CACHE": str(CACHE / "geometry"),
          "CUDA_CACHE_PATH": str(CACHE / "cuda")}


def load_json(path: pathlib.Path):
  with open(path) as f:
    return json.load(f)


def resolve(bench: dict, workload: str, limits_dir=None):
  """(cell, configuration, traffic mix, limits) of a workload by name;
  the limits from ``limits_dir`` (``portbench/limits/`` by default)."""
  cells = {c["name"]: c for c in bench["workloads"]}
  if workload not in cells:
    raise SystemExit(f"unknown workload {workload!r}; one of {sorted(cells)}")
  cell = cells[workload]
  configs = {c["name"]: c for c in bench["configs"]}
  cfg = load_json(ROOT / configs[cell["config"]]["file"])
  traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
  limits = load_json((limits_dir or HERE / "limits") / f"{workload}.json")
  return cell, cfg, traffic, limits


def reports(metric: dict, workload: str) -> bool:
  return "workloads" not in metric or workload in metric["workloads"]


def reader(name: str):
  """The per-layer metric's reader module, loaded from its file."""
  path = HERE / "metrics" / f"{name}.py"
  spec = importlib.util.spec_from_file_location(
      f"portbench.metrics.{name.replace('.', '_')}", path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def entry_class(traffic: dict):
  return importlib.import_module(f"portbench.entries.{traffic['entry']}").Entry


def forbidden_modules() -> list[str]:
  return sorted({m.split(".")[0] for m in list(sys.modules)}
                & set(FORBIDDEN))


def card(device) -> dict:
  import torch
  if device.type != "cuda":
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}
  limit = None
  try:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"], capture_output=True, text=True,
        timeout=30, check=True)
    limit = smi.stdout.strip().splitlines()[0]
  except (OSError, subprocess.SubprocessError, IndexError):
    pass
  return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
          "count": 1,
          "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
          "power_limit": limit}


def synchronize(device):
  import torch
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, t0: float, log=print,
             limits_dir=None, control=None) -> dict:
  """Runs the cell once and returns its result (the line ``main``
  prints); ``t0``: the process's start on the host clock. With
  ``control`` (a precision, such as ``"float8_e4m3"``) the numbers held to
  the limits are the control's: the reference at that precision in the
  program's place, which has to come out not correct."""
  from portbench import readers
  from portbench import trace as trace_lib
  from portbench.entries import common
  cell, cfg, traffic, limits = resolve(bench, workload, limits_dir)
  entry = entry_class(traffic)(cfg, traffic, seed, device)
  started = time.perf_counter()
  entry.setup()
  synchronize(device)
  setup_s = time.perf_counter() - t0
  phases = [("imports", started)] + entry.phases
  log(f"[portbench] {workload} seed {seed}: set-up {setup_s:.3f} s ("
      + ", ".join(f"{name} {t - t0:.3f}" for name, t in phases)
      + " s from the start)", file=sys.stderr)
  # What set-up left behind is never garbage the window's collections need
  # to scan again: a full collection over it stalls the host (0.08 s at the
  # CPU test size), and a stall longer than the device's queue idles it.
  gc.collect()
  gc.freeze()
  collections = common.Collections()
  e2e = entry.window(seconds)
  collections.close()
  log(f"[portbench] window: {entry.attempted} steps, "
      + ", ".join(f"{k} {v:.6f}" for k, v in e2e.items())
      + f"; garbage collector: {collections}", file=sys.stderr)
  traced = trace_lib.profile(entry.traced, device) if trace else None
  gc.unfreeze()
  info = card(device)
  entry.release()
  numbers = entry.control(control) if control else entry.check()
  for name in sorted(set(numbers) - set(limits)):
    log(f"reading {name} = {numbers[name]!r} (not compared)", file=sys.stderr)
  checks = {name: {"value": float(numbers[name]), "limit": float(limit)}
            for name, limit in limits.items()}
  failed = sum(not (math.isfinite(c["value"]) and c["value"] <= c["limit"])
               for c in checks.values())
  e2e = {"setup_s": setup_s, **e2e}
  metrics = {}
  if not trace:
    for m in bench["end_to_end"]:
      if reports(m, workload) and m["name"] in e2e:
        metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
  else:
    ctx = readers.Context(cell=cell, cfg=cfg, traffic=traffic, e2e=e2e,
                          trace=traced, sizes=entry.sizes())
    for m in bench["per_layer"]:
      if not reports(m, workload):
        continue
      value = reader(m["name"]).read(ctx)
      if value is not None:
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info.update(busy_s=traced.busy_s, window_s=traced.window_s)
  result = {"correct": failed == 0 and bool(checks),
            "attempted": entry.attempted, "failed": failed,
            "metrics": metrics, "device": info}
  if traced is not None:
    result["breakdown"] = traced.breakdown()
  result["checks"] = checks
  return result


def parse(argv):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--workload", required=True)
  p.add_argument("--seed", type=int, required=True)
  p.add_argument("--seconds", type=float, required=True)
  p.add_argument("--trace", type=int, choices=(0, 1), default=0)
  p.add_argument("--control", default=None,
                 help="judge the control instead of the program: the "
                 "reference at this precision (float8_e4m3) in the "
                 "program's place; its result must read correct false")
  return p.parse_args(argv)


def main(argv, t0: float) -> int:
  args = parse(argv)
  bench = load_json(ROOT / "BENCHMARK.json")
  cell = resolve(bench, args.workload)[0]
  import torch
  if not torch.cuda.is_available() or (
      torch.cuda.device_count() < cell["chips"]):
    print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
          f"device(s); torch sees "
          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
          file=sys.stderr)
    return 2
  device = torch.device("cuda", 0)
  torch.cuda.set_device(device)
  result = run_cell(bench, args.workload, args.seed, args.seconds,
                    bool(args.trace), device, t0, control=args.control)
  found = forbidden_modules()
  if found:
    print(f"portbench: the process loaded {found}", file=sys.stderr)
    return 3
  for name, c in result["checks"].items():
    print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
          file=sys.stderr)
  print(json.dumps(result))
  return 0


def set_environment():
  for key, value in cache_environment().items():
    os.environ[key] = value
