"""Builds and binds the native geometry library (``geometry_kernels.cc``).

At first use, ``load_library()`` compiles the port's copy of the C++
geometry kernels with

    g++ -O3 -march=native -shared -fPIC

the JAX package's flags (graphcast_tpu/native/build.py), so that on one
machine both libraries resolve triangle-containment ties the same way, into
``graphcast_tpu_torch/_build/`` (ignored by git) under a name that carries a
hash of the source, the compiler, the flags and the target options that
``-march=native`` resolves to (a library built for one CPU is not loaded
on another), and binds it with ctypes. It is host code, kept apart from
``native/build.py``, the CUDA build.

``available()`` says whether the library builds; ``load_library()`` raises
when it does not, with the compiler's message. As in the JAX package, a set
``GRAPHCAST_TPU_NO_NATIVE`` turns the library off. ``geometry/
connectivity.py`` ``resolve_backend`` picks it for the ``"auto"`` backend
whenever it builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Union

import numpy as np

CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
SOURCE = pathlib.Path(__file__).with_name("geometry_kernels.cc")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
NO_NATIVE_ENV = "GRAPHCAST_TPU_NO_NATIVE"
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
# compiler -> the bound library, or why it did not build.
_libraries: dict[str, Union[ctypes.CDLL, str]] = {}


def _run(cmd: list[str]) -> str:
  """``cmd``'s output; raises RuntimeError with the compiler's message."""
  try:
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S, check=False)
  except (OSError, subprocess.SubprocessError) as e:
    raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
  if proc.returncode != 0:
    raise RuntimeError(f"{' '.join(cmd)} failed (exit {proc.returncode}):\n"
                       f"{proc.stdout}{proc.stderr}")
  return proc.stdout


def _compile(cxx: str) -> pathlib.Path:
  """The library's path, compiled first where it is missing; raises
  RuntimeError with the compiler's message."""
  h = hashlib.sha256(SOURCE.read_bytes())
  h.update(repr((cxx, CXX_FLAGS)).encode())
  h.update(_run([cxx, "-march=native", "-Q", "--help=target"]).encode())
  lib_path = BUILD_DIR / f"geometry_kernels_{h.hexdigest()[:16]}.so"
  if lib_path.exists():
    return lib_path
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
  try:
    _run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)])
  except RuntimeError:
    tmp.unlink(missing_ok=True)
    raise
  os.replace(tmp, lib_path)
  return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
  d, i64, i32 = ctypes.c_double, ctypes.c_int64, ctypes.c_int32
  lib.radius_query.restype = i64
  lib.radius_query.argtypes = [
      ctypes.POINTER(d), i64, ctypes.POINTER(d), i64, d,
      ctypes.POINTER(i32), ctypes.POINTER(i32), i64]
  lib.containing_triangles.restype = None
  lib.containing_triangles.argtypes = [
      ctypes.POINTER(d), i64, ctypes.POINTER(d), i64,
      ctypes.POINTER(i32), i64, ctypes.POINTER(i32)]
  return lib


def load_library() -> ctypes.CDLL:
  """The bound library, built at the first call (module doc). Raises
  RuntimeError when it cannot be built or loaded, or is turned off."""
  if os.environ.get(NO_NATIVE_ENV):
    raise RuntimeError(f"the native geometry library is turned off "
                       f"({NO_NATIVE_ENV} is set)")
  cxx = CXX
  with _lock:
    if cxx not in _libraries:
      try:
        _libraries[cxx] = _bind(ctypes.CDLL(str(_compile(cxx))))
      except (RuntimeError, OSError) as e:
        _libraries[cxx] = f"the native geometry library did not build: {e}"
    lib = _libraries[cxx]
  if isinstance(lib, str):
    raise RuntimeError(lib)
  return lib


def available() -> bool:
  """Whether ``load_library()`` gives a library."""
  try:
    load_library()
  except RuntimeError:
    return False
  return True


def _ptr(a: np.ndarray, ctype):
  return a.ctypes.data_as(ctypes.POINTER(ctype))


def radius_query(grid_pos: np.ndarray, mesh_pos: np.ndarray,
                 radius: float) -> tuple[np.ndarray, np.ndarray]:
  """Every (grid, mesh) pair within ``radius`` in R3, as int32 (grid
  indices, mesh indices), in the library's order."""
  lib = load_library()
  grid_pos = np.ascontiguousarray(grid_pos, dtype=np.float64)
  mesh_pos = np.ascontiguousarray(mesh_pos, dtype=np.float64)
  args = (_ptr(grid_pos, ctypes.c_double), grid_pos.shape[0],
          _ptr(mesh_pos, ctypes.c_double), mesh_pos.shape[0], float(radius))
  count = lib.radius_query(*args, None, None, 0)
  out_grid = np.empty(count, dtype=np.int32)
  out_mesh = np.empty(count, dtype=np.int32)
  filled = lib.radius_query(*args, _ptr(out_grid, ctypes.c_int32),
                            _ptr(out_mesh, ctypes.c_int32), count)
  if filled != count:
    raise RuntimeError(f"radius_query filled {filled} of {count} pairs")
  return out_grid, out_mesh


def containing_triangles(points: np.ndarray, vertices: np.ndarray,
                         faces: np.ndarray) -> np.ndarray:
  """int32 [num_points]: the face whose spherical triangle contains each
  unit-norm point."""
  lib = load_library()
  points = np.ascontiguousarray(points, dtype=np.float64)
  vertices = np.ascontiguousarray(vertices, dtype=np.float64)
  faces = np.ascontiguousarray(faces, dtype=np.int32)
  out = np.empty(points.shape[0], dtype=np.int32)
  lib.containing_triangles(
      _ptr(points, ctypes.c_double), points.shape[0],
      _ptr(vertices, ctypes.c_double), vertices.shape[0],
      _ptr(faces, ctypes.c_int32), faces.shape[0],
      _ptr(out, ctypes.c_int32))
  return out
