"""Builds and loads the port's Hopper kernels (graphcast_tpu_torch/csrc).

At first use, ``load_library()`` compiles every ``csrc/*.cu`` with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC -c

one ``nvcc`` per source, all started together, and links the objects into
one shared library with a plain C interface, under
``graphcast_tpu_torch/_build/`` (ignored by git; the file name carries a
hash of the sources, so an edited source is rebuilt), and loads it with
ctypes. Everything that stops it raises: no ``nvcc``, no CUDA device, a
failed build (with the compiler's message).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
_build_log = ""


def find_nvcc() -> str:
  """Path of nvcc: on PATH, else $CUDA_HOME/bin (default /usr/local/cuda)."""
  cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
  for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
    if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
      return cand
  raise RuntimeError(
      "nvcc not found on PATH or in $CUDA_HOME/bin (default /usr/local/cuda):"
      " the CUDA kernels of graphcast_tpu_torch cannot be built")


def _sources() -> list[pathlib.Path]:
  return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _compile(nvcc: str) -> pathlib.Path:
  global _build_log
  digest = hashlib.sha256()
  for src in _sources():
    digest.update(src.name.encode())
    digest.update(src.read_bytes())
  digest.update(" ".join(NVCC_FLAGS).encode())
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  lib_path = BUILD_DIR / f"libgraphcast_kernels_{digest.hexdigest()[:16]}.so"
  if lib_path.exists():
    return lib_path
  tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
  cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(BUILD_DIR / f"{src.stem}.{tag}.o"),
           str(src)] for src in sorted(CSRC.glob("*.cu"))]
  procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True) for cmd in cmds]
  logs = [proc.communicate()[0] for proc in procs]
  _build_log = "".join(logs)
  objs = [cmd[cmd.index("-o") + 1] for cmd in cmds]
  try:
    for cmd, proc, log in zip(cmds, procs, logs):
      if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}")
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o",
           str(tmp), *objs]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
      raise RuntimeError(f"nvcc link failed (exit {proc.returncode}): "
                         f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
  finally:
    for obj in objs:
      pathlib.Path(obj).unlink(missing_ok=True)
  return lib_path


def _declare(lib: ctypes.CDLL):
  p, i = ctypes.c_void_p, ctypes.c_int
  lib.gc_fused_edge.restype = i
  lib.gc_fused_edge.argtypes = [p] * 13 + [i] * 4 + [p]
  lib.gc_fused_edge_pipelined.restype = i
  lib.gc_fused_edge_pipelined.argtypes = [p] * 13 + [i] * 4 + [p]
  lib.gc_fused_decoder.restype = i
  lib.gc_fused_decoder.argtypes = [p] * 21 + [i] * 4 + [p]
  lib.gc_fused_edge_bwd.restype = i
  lib.gc_fused_edge_bwd.argtypes = [p] * 20 + [i] * 3 + [p]
  lib.gc_fused_decoder_bwd.restype = i
  lib.gc_fused_decoder_bwd.argtypes = [p] * 30 + [i] * 4 + [p]
  lib.gc_weight_grad.restype = i
  lib.gc_weight_grad.argtypes = [p, i, p, i, p, i, i, i, p, i, i, i, p, p]
  lib.gc_weight_grad_smem.restype = i
  lib.gc_weight_grad_smem.argtypes = [i]
  lib.gc_fused_edge_embed.restype = i
  lib.gc_fused_edge_embed.argtypes = [p] * 16 + [i] * 3 + [p]
  lib.gc_fused_edge_embed_pipelined.restype = i
  lib.gc_fused_edge_embed_pipelined.argtypes = [p] * 16 + [i] * 3 + [p]
  lib.gc_fused_decoder_embed.restype = i
  lib.gc_fused_decoder_embed.argtypes = [p] * 27 + [i] * 5 + [p]
  lib.gc_splash_fwd.restype = i
  lib.gc_splash_fwd.argtypes = [p] * 11 + [ctypes.c_float] + [i] * 4 + [p]
  lib.gc_splash_fwd_smem.restype = i
  lib.gc_splash_fwd_smem.argtypes = []
  lib.gc_fused_decoder_bwd_embed.restype = i
  lib.gc_fused_decoder_bwd_embed.argtypes = [p] * 39 + [i] * 5 + [p]
  lib.gc_fused_edge_bwd_embed.restype = i
  lib.gc_fused_edge_bwd_embed.argtypes = [p] * 28 + [i] * 3 + [p]
  lib.gc_feature_grad.restype = i
  lib.gc_feature_grad.argtypes = [p, i, p, i, p, p, p, i, i, p]
  lib.gc_splash_dq.restype = i
  lib.gc_splash_dq.argtypes = [p] * 11 + [ctypes.c_float] + [i] * 3 + [p]
  lib.gc_splash_dkv.restype = i
  lib.gc_splash_dkv.argtypes = [p] * 12 + [ctypes.c_float] + [i] * 3 + [p]
  lib.gc_segment_sum.restype = i
  lib.gc_segment_sum.argtypes = [p, p, i, p, i, p, p, i, i, p]
  lib.gc_error_string.restype = ctypes.c_char_p
  lib.gc_error_string.argtypes = [i]


def load_library() -> ctypes.CDLL:
  """The kernels' shared library, built on first call (see module doc)."""
  global _lib
  with _lock:
    if _lib is None:
      nvcc = find_nvcc()
      if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the CUDA kernels cannot run")
      lib = ctypes.CDLL(str(_compile(nvcc)))
      _declare(lib)
      _lib = lib
    return _lib


def build_log() -> str:
  """The compiler's output of the build this process ran ("" if the
  library was already built)."""
  return _build_log


def check(lib: ctypes.CDLL, code: int, what: str):
  """Raises if a kernel launch returned a CUDA error."""
  if code != 0:
    raise RuntimeError(
        f"{what}: CUDA error {code}: {lib.gc_error_string(code).decode()}")
