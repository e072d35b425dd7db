"""Real spherical-harmonic synthesis (inverse transform) on lat/lon grids.

Port of graphcast_tpu/ops/sht.py, which samples isotropic Gaussian-process
noise on the sphere:

  g[..., m, lat] = Σ_l  a[..., l, m] · P̃_l^m(sin lat)        (Legendre stage)
  f[..., lat, lon] = Σ_m g[..., m, lat] · {cos,sin}(m·lon)    (Fourier stage)

P̃ are the fully normalised associated Legendre functions, computed on the
host (numpy, float64, then float32) with the three-term recurrence; the two
stages are dense float32 einsums, outside any kernel. On the card they must
run in true float32: ``synthesize_with`` turns TF32 matrix products off
while it runs (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's
default) and restores the caller's setting.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def normalized_legendre(max_l: int, x: np.ndarray) -> np.ndarray:
  """P̃_l^m(x) for 0 ≤ m ≤ l < max_l, orthonormal over the sphere.

  Returns [len(x), max_l, max_l] indexed [x, l, m]; entries with m > l are
  zero. The real forms' √2 for m > 0 is applied at synthesis.
  """
  x = np.asarray(x, dtype=np.float64)
  n = x.shape[0]
  p = np.zeros((n, max_l, max_l), dtype=np.float64)
  somx2 = np.sqrt(np.maximum(0.0, 1.0 - x * x))
  pmm = np.full(n, np.sqrt(1.0 / (4.0 * np.pi)))
  p[:, 0, 0] = pmm
  for m in range(1, max_l):
    pmm = -np.sqrt((2.0 * m + 1.0) / (2.0 * m)) * somx2 * pmm
    p[:, m, m] = pmm
  for m in range(0, max_l - 1):
    p[:, m + 1, m] = np.sqrt(2.0 * m + 3.0) * x * p[:, m, m]
  for m in range(0, max_l):
    for l in range(m + 2, max_l):
      a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
      b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
      p[:, l, m] = a * (x * p[:, l - 1, m] - b * p[:, l - 2, m])
  return p


class SphericalHarmonicBasis:
  """Synthesis matrices (numpy float32) for a fixed (lat, lon, max_l)."""

  def __init__(self, lat_deg: np.ndarray, lon_deg: np.ndarray, max_l: int):
    self.max_l = max_l
    x = np.sin(np.deg2rad(np.asarray(lat_deg, np.float64)))
    self.legendre = normalized_legendre(max_l, x).astype(np.float32)
    phi = np.deg2rad(np.asarray(lon_deg, np.float64))
    m = np.arange(max_l)[:, None]
    self.cos_mat = np.cos(m * phi[None, :]).astype(np.float32)  # [m, lon]
    self.sin_mat = np.sin(m * phi[None, :]).astype(np.float32)
    self.m_scale = np.where(np.arange(max_l) == 0, 1.0,
                            np.sqrt(2.0)).astype(np.float32)

  def arrays(self) -> dict[str, np.ndarray]:
    """The synthesis tensors, keyed as graphcast_tpu's basis arrays."""
    sin_mask = (np.arange(self.max_l) > 0).astype(np.float32)
    return {
        "legendre": self.legendre,
        "cos_mat": self.cos_mat,
        "sin_mat": self.sin_mat,
        "m_scale": self.m_scale[:, None],
        "sin_mask": (sin_mask * self.m_scale)[:, None],
    }

  def tensors(self, device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device)
            for k, v in self.arrays().items()}


@contextlib.contextmanager
def _true_f32_matmul():
  saved = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = saved


def synthesize_with(basis: dict, cos_coeffs: torch.Tensor,
                    sin_coeffs: torch.Tensor) -> torch.Tensor:
  """Inverse transform of real SH coefficients [..., l, m] (the m = 0
  column of sin_coeffs is ignored) with the tensors of
  ``SphericalHarmonicBasis.tensors``; returns [..., lat, lon] float32."""
  leg = basis["legendre"]
  with _true_f32_matmul():
    g_c = torch.einsum("...lm,plm->...mp", cos_coeffs.float(), leg)
    g_s = torch.einsum("...lm,plm->...mp", sin_coeffs.float(), leg)
    g_c = g_c * basis["m_scale"]
    g_s = g_s * basis["sin_mask"]
    return (torch.einsum("...mp,mq->...pq", g_c, basis["cos_mat"])
            + torch.einsum("...mp,mq->...pq", g_s, basis["sin_mat"]))
