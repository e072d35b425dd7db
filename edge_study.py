"""Where K1's, K1p's and K4's time goes on one GPU (graphcast_tpu_torch/
csrc/fused_edge*.cu on edge.cuh), by building variants of their sources
and timing each against the unmodified kernels in turns, in one process.

Usage: python3 edge_study.py            (needs one CUDA device and nvcc)

Variants, each its own library of the edge kernels' units, weight_grad.cu
and segment_sum.cu (K4's sender sums), built in parallel:
  cluster4     clusters of 4 blocks (kEdgeCluster = 4: 256 edge rows per
               weight byte read from L2) instead of 2;
  no_gather    the sproj[snd] and rproj[rcv] rows not gathered;
  no_dagg      K4's dagg[rcv] rows not gathered;
  no_walk      no receiver-run sums by the consumers (K1's agg, K1p's in
               encoder mode, K4's dGr);
  no_colsums   K4's column sums not summed (puts and folds empty);
  no_products  the ring streams every weight box, no wgmma is issued.

The variants with parts compiled out compute wrong results; only their
times are read (cluster4 is checked against the twin). Cases at latent 512,
bf16, operands as chip_smoke.py draws them: K1, K1p and K4 in processor
mode on the 0.25° mesh-6 multi-mesh and in encoder mode on the 0.25°
grid2mesh set. Prints the card's name and power limit, then one line per
case and variant: mean ms (K1 and K1p: 5 launches, K4: its per-row
kernel's device time from the profiler over 2 calls), each variant timed
twice, in the order base, variants, variants reversed, base.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import shutil
import subprocess
import sys

import numpy as np

UNITS = ("fused_edge.cu", "fused_edge_encoder.cu", "fused_edge_pipelined.cu",
         "fused_edge_pipelined_encoder.cu", "fused_edge_bwd.cu",
         "fused_edge_bwd_encoder.cu", "weight_grad.cu", "segment_sum.cu")


def _mma_issue(decoder: str) -> str:
  """dec_mma's wgmma issue, fence to wait, for one box (decoder.cuh)."""
  i0 = decoder.index("      fence_operands(acc[q]);\n      wgmma_fence();")
  i1 = decoder.index("      wgmma_wait<1>();\n", i0)
  return decoder[i0:i1 + len("      wgmma_wait<1>();\n")]


def _colsums(decoder: str) -> list:
  """DecColSums' fold loop (decoder.cuh), emptied."""
  f0 = decoder.index("    for (int s = 0; s < slots; ++s) {")
  f1 = decoder.index("    dec_sync();\n  }\n};", f0)
  return [("decoder.cuh", decoder[f0:f1], "")]


def _substitutions(csrc: pathlib.Path) -> dict:
  """{variant: [(file, anchor, replacement)]}."""
  dec = (csrc / "decoder.cuh").read_text()
  edge = (csrc / "edge.cuh").read_text()
  p0 = edge.index("  const bool b1 = th.lane & 16")
  p1 = edge.index("  cs.colred[(slot * 4 + th.wl) * kDecWidth + col] = y;\n}")
  return {
      "cluster4": [("edge.cuh", "constexpr int kEdgeCluster = 2;",
                    "constexpr int kEdgeCluster = 4;")],
      "no_gather": [
          ("edge.cuh", "ldg_raw2(sproj + (size_t)t.snd[h] * C + cc)", "0u"),
          ("edge.cuh", "ldg_raw2(rproj + (size_t)t.rcv[h] * C + cc)", "0u")],
      "no_dagg": [("fused_edge_bwd.cu",
                   "ldg2(a.dagg + (size_t)t.rcv[h] * C + cc)",
                   "make_float2(0.f, 0.f)")],
      "no_walk": [
          ("edge.cuh",
           "      edge_run_sums(sh.a, idx, t.rows, C, a.agg,\n"
           "                    a.bnd + (size_t)(t.row0 / kEdgeRows) * 2 * C,\n"
           "                    2 * th.ctid);\n", ""),
          ("fused_edge_bwd.cu",
           "    edge_run_sums(sh.a, sh.idx, t.rows, C, a.dgr,\n"
           "                  a.bnd + (size_t)(t.row0 / kEdgeRows) * 2 * C,"
           " 2 * th.ctid);\n", "")],
      "no_colsums": _colsums(dec) + [
          ("edge.cuh", edge[p0:p1], "  const float y = 0.f;\n  const int col = 0;\n"),
          ("edge.cuh", "  cs.colred[(slot * 4 + th.wl) * kDecWidth + col] = y;\n}",
           "  (void)y; (void)col; (void)q; (void)half; (void)v; (void)slot;\n}")],
      "no_products": [("decoder.cuh", _mma_issue(dec), "")],
  }


def _build(build, csrc: pathlib.Path, out: pathlib.Path) -> dict:
  """{variant: ctypes library} for "base" and every variant."""
  subs = {"base": [], **_substitutions(csrc)}
  shutil.rmtree(out, ignore_errors=True)
  nvcc = build.find_nvcc()

  def one(name):
    d = out / name
    d.mkdir(parents=True)
    for f in csrc.iterdir():
      if f.suffix == ".cuh" or f.name in UNITS:
        text = f.read_text()
        for ff, anchor, new in subs[name]:
          if ff == f.name:
            if text.count(anchor) != 1:
              raise RuntimeError(f"{name}: anchor not found once: {anchor!r}")
            text = text.replace(anchor, new)
        (d / f.name).write_text(text)
    procs = [subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-c", "-o", str(d / f"{u}.o"), str(d / u)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for u in UNITS]
    for u, proc in zip(UNITS, procs):
      log = proc.communicate()[0]
      if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} {u}:\n{log}")
    subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-o", str(d / "lib.so"), *(str(d / f"{u}.o") for u in UNITS)],
                   check=True)
    return name, d / "lib.so"

  libs = {}
  with concurrent.futures.ThreadPoolExecutor(len(subs)) as pool:
    for name, path in pool.map(one, subs):
      lib = ctypes.CDLL(str(path))
      _declare(build, lib)
      libs[name] = lib
  return libs


def _declare(build, lib):
  """The package's declarations of the entry points this library has."""
  class Present:
    def __getattr__(self, name):
      try:
        return getattr(lib, name)
      except AttributeError:  # an entry point of another unit
        return ctypes.CFUNCTYPE(None)()
  build._declare(Present())


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print("edge_study: no CUDA device", file=sys.stderr)
    return 2
  import chip_smoke as cs
  from graphcast_tpu_torch.native import build
  from graphcast_tpu_torch.ops.fused_edge import (
      EdgeIndex, fused_edge, fused_edge_backward, fused_edge_reference)
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
  print(smi.stdout.strip(), flush=True)
  libs = _build(build, build.CSRC, build.BUILD_DIR / "edge_study")
  art = cs._geometry(0.25, 6)
  g, m = art.num_grid_nodes, art.num_mesh_nodes
  cases = {"processor": EdgeIndex(art.mesh.senders, art.mesh.receivers, m,
                                  m, "cuda"),
           "encoder": EdgeIndex(art.grid2mesh.senders,
                                art.grid2mesh.receivers, g, m, "cuda")}
  gen = torch.Generator(device="cuda").manual_seed(1)
  order = list(libs) + list(reversed(libs))
  try:
    for mode, edges in cases.items():
      write = mode == "processor"
      args = cs._edge_case(torch, gen, edges, 512, encoder=not write)
      if write:
        args["we"] = args["we"].to(torch.bfloat16)
      det = {k: v for k, v in args.items() if k != "offset"}
      d_agg = cs._randn(torch, gen, (edges.num_receivers, 512))
      d_eout = (cs._randn(torch, gen, (edges.num_edges, 512), 1.0,
                          torch.bfloat16) if write else None)
      with torch.inference_mode():
        want = fused_edge_reference(edges, write_edges=write, **args)
        build._lib = libs["cluster4"]
        for pipelined in (False, True):
          got = fused_edge(edges, write_edges=write, pipelined=pipelined,
                           **args)
          torch.cuda.synchronize()
          for a, b in ((got, want),) if not write else zip(got, want):
            cs._check_close(f"cluster4 {mode} pipelined={pipelined}", a, b)
          del got
        del want
      k1, k1p, k4 = {}, {}, {}
      for name in order:
        build._lib = libs[name]
        with torch.inference_mode():
          k1.setdefault(name, []).append(cs._time_ms(
              torch, lambda: fused_edge(edges, write_edges=write,
                                        pipelined=False, **args), reps=5))
          k1p.setdefault(name, []).append(cs._time_ms(
              torch, lambda: fused_edge(edges, write_edges=write,
                                        pipelined=True, **args), reps=5))
        k4.setdefault(name, []).append(cs._device_ms(
            torch, lambda: fused_edge_backward(edges, d_eout=d_eout,
                                               d_agg=d_agg, **det),
            ("fused_edge_bwd_kernel",), reps=2)["fused_edge_bwd_kernel"])
      for name in libs:
        print(f"[{mode}] {name}: k1_ms={np.mean(k1[name]):.3f} "
              f"k1p_ms={np.mean(k1p[name]):.3f} "
              f"k4_kernel_ms={np.mean(k4[name]):.3f} (turns "
              f"{'/'.join(f'{x:.3f}' for x in k1[name])}; "
              f"{'/'.join(f'{x:.3f}' for x in k1p[name])}; "
              f"{'/'.join(f'{x:.3f}' for x in k4[name])})", flush=True)
      del args, det, d_agg, d_eout
      torch.cuda.empty_cache()
  finally:
    build._lib = None
  return 0


if __name__ == "__main__":
  sys.exit(main())
