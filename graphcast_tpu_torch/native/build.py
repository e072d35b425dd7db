"""Builds and loads the port's Hopper kernels (graphcast_tpu_torch/csrc).

At first use, ``load_library()`` compiles every ``csrc/*.cu`` with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

into one shared library with a plain C interface, under
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
  tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
  cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
         *(str(s) for s in sorted(CSRC.glob("*.cu")))]
  proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
  _build_log = proc.stdout + proc.stderr
  if proc.returncode != 0:
    raise RuntimeError(
        f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{_build_log}")
  os.replace(tmp, lib_path)
  return lib_path


def _declare(lib: ctypes.CDLL):
  p, i = ctypes.c_void_p, ctypes.c_int
  lib.gc_fused_edge.restype = i
  lib.gc_fused_edge.argtypes = [p] * 13 + [i] * 4 + [p]
  lib.gc_fused_decoder.restype = i
  lib.gc_fused_decoder.argtypes = [p] * 21 + [i] * 4 + [p]
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
