"""Where K1p's time goes on one GPU (graphcast_tpu_torch/csrc/
fused_edge_pipelined.cu), by building variants of its source and timing
each against K1 and the unmodified K1p in turns, in one process.

Usage: python3 k1p_study.py            (needs one CUDA device and nvcc)

Two sets of variants:
  rings  other weight-ring shapes (output columns a pass, K rows a tile,
         stages) that fit the block's shared memory;
  parts  the kernel with parts of its work compiled out: the products, the
         LayerNorm + e' + run sums, the head's elementwise pass, the
         prefetch, all but the products, all of it (the loop's skeleton).

The variants compute wrong results where parts are compiled out; only
their times are read. Each variant's nvcc runs in parallel; its library
holds K1p's two entry points, the rest comes from the package's library.
Cases: processor mode on the 0.25° mesh-6 multi-mesh, encoder mode on the
0.25° grid2mesh set, embed mode on the 1.0° GenCast grid2mesh set, latent
512, bf16, operands as chip_smoke.py's k1p phase draws them. Prints the
card's name and power limit, then one line per case: mean ms of 10
launches, each variant timed twice (in the order K1, variants, variants
reversed, K1).
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import numpy as np

RINGS = {"nc128_kt32_s3": (128, 32, 3), "nc256_kt16_s3": (256, 16, 3),
         "nc512_kt16_s2": (512, 16, 2)}
# Guards inserted around parts of the kernel: (anchor, guarded anchor).
GUARDS = {
    "MM": [("block_mm_pipe<kPipeTM>(Es, lda, we",
            "if (!SKIP_MM) block_mm_pipe<kPipeTM>(Es, lda, we"),
           ("block_mm_pipe<kPipeTM>(A, lda, w1",
            "if (!SKIP_MM) block_mm_pipe<kPipeTM>(A, lda, w1")],
    "TAIL": [("    ln_rows_pipe<true>(X,",
              "    if (!SKIP_TAIL) ln_rows_pipe<true>(X,"),
             ("    if (kWriteE) {", "    if (kWriteE && !SKIP_TAIL) {"),
             ("    for (int c = threadIdx.x; c < C; c += kThreads) {",
              "    for (int c = threadIdx.x; !SKIP_TAIL && c < C;"
              " c += kThreads) {")],
    "HEAD": [("      for (int r = threadIdx.x / c8n; r < kPipeTM;",
              "      for (int r = threadIdx.x / c8n;"
              " !SKIP_HEAD && r < kPipeTM;")],
    "PF": [("if (prefetcher && g + 1 < t_end) prefetch(g + 1);",
            "if (!SKIP_PF && prefetcher && g + 1 < t_end)"
            " prefetch(g + 1);")],
}
PARTS = {"no_products": ("MM",), "no_ln_e_sums": ("TAIL",),
         "no_head_pass": ("HEAD",), "no_prefetch": ("PF",),
         "products_only": ("TAIL", "HEAD", "PF"), "skeleton": tuple(GUARDS)}


def _sources(src: str) -> dict:
  """{variant name: source text}."""
  out = {}
  for name, (nc, kt, stages) in RINGS.items():
    s = re.sub(r"kPipeNC = \d+", f"kPipeNC = {nc}", src)
    s = re.sub(r"kPipeKT = \d+", f"kPipeKT = {kt}", s)
    out[name] = re.sub(r"kPipeStages = \d+", f"kPipeStages = {stages}", s)
  guarded = src
  for pairs in GUARDS.values():
    for anchor, replacement in pairs:
      if guarded.count(anchor) != 1:
        raise RuntimeError(f"anchor not found once in the source: {anchor!r}")
      guarded = guarded.replace(anchor, replacement)
  for name, skipped in PARTS.items():
    defines = "".join(f"#define SKIP_{k} {int(k in skipped)}\n"
                      for k in GUARDS)
    out[name] = defines + guarded
  return out


def _build(build, sources: dict) -> dict:
  """{variant name: ctypes library}, one nvcc each, all started together."""
  out_dir = build.BUILD_DIR / "k1p_study"
  out_dir.mkdir(parents=True, exist_ok=True)
  procs = {}
  for name, text in sources.items():
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    procs[name] = subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-I",
         str(build.CSRC), "-o", str(out_dir / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  libs = {}
  for name, proc in procs.items():
    log = proc.communicate()[0]
    if proc.returncode != 0:
      raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gc_fused_edge_pipelined.restype = i
    lib.gc_fused_edge_pipelined.argtypes = [p] * 13 + [i] * 4 + [p]
    lib.gc_fused_edge_embed_pipelined.restype = i
    lib.gc_fused_edge_embed_pipelined.argtypes = [p] * 16 + [i] * 3 + [p]
    libs[name] = lib
  return libs


class _WithVariant:
  """The package's library with K1p's entry points taken from a variant."""

  def __init__(self, main, variant):
    self._main, self._variant = main, variant

  def __getattr__(self, name):
    return getattr(self._variant if "pipelined" in name else self._main, name)


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print("k1p_study: no CUDA device", file=sys.stderr)
    return 2
  import chip_smoke as cs
  from graphcast_tpu_torch.native import build
  from graphcast_tpu_torch.ops.fused_edge import EdgeIndex, fused_edge
  card = cs.phase_build(torch)
  main_lib = build.load_library()
  libs = _build(build, _sources(
      (build.CSRC / "fused_edge_pipelined.cu").read_text()))
  art, art1 = cs._geometry(0.25, 6), cs._gencast_artifact(1.0, 5)
  g, m = art.num_grid_nodes, art.num_mesh_nodes
  cases = {
      "processor": EdgeIndex(art.mesh.senders, art.mesh.receivers, m, m,
                             "cuda"),
      "encoder": EdgeIndex(art.grid2mesh.senders, art.grid2mesh.receivers,
                           g, m, "cuda"),
      "embed": EdgeIndex(art1.grid2mesh.senders, art1.grid2mesh.receivers,
                         art1.num_grid_nodes, art1.num_mesh_nodes, "cuda")}
  gen = torch.Generator(device="cuda").manual_seed(22)
  libraries = {"k1": main_lib, "k1p": main_lib,
               **{k: _WithVariant(main_lib, v) for k, v in libs.items()}}
  order = list(libraries) + list(reversed(libraries))
  try:
    for mode, edges in cases.items():
      args = cs._edge_case(torch, gen, edges, 512, encoder=mode == "encoder")
      args["write_edges"] = mode == "processor"
      if mode == "embed":
        args["e"] = torch.as_tensor(art1.grid2mesh.features, device="cuda")
        args["we"] = args["we"].to(torch.bfloat16)
        args["embed_weights"] = cs._embed_weights(torch, gen, 512)
      times = {}
      with torch.inference_mode():
        for name in order:
          build._lib = libraries[name]
          times.setdefault(name, []).append(cs._time_ms(
              torch, lambda: fused_edge(edges, pipelined=name != "k1",
                                        **args), reps=10))
      print(f"[{mode}] edges={edges.num_edges} " + " ".join(
          f"{k}={np.mean(v):.3f}" for k, v in times.items()), flush=True)
      del args
      torch.cuda.empty_cache()
  finally:
    build._lib = main_lib
  print(card)
  return 0


if __name__ == "__main__":
  sys.exit(main())
