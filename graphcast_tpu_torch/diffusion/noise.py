"""Spherical noise sampling and the EDM noise-level schedules.

Port of graphcast_tpu/diffusion/noise.py (reference: samplers_utils.py):
isotropic Gaussian-process noise on the sphere from spherical-harmonic
synthesis (ops/sht.py), unit-variance spherical white noise, the Karras/EDM
rho-distribution quantiles, the descending noise schedule with an appended
σ = 0, and stochastic churn. Coefficients are drawn from an explicit
``torch.Generator`` (on its own device, then moved to the data's); the JAX
package's jax.random draws are not reproduced, so tests feed both packages
the same numpy noise.
"""

from __future__ import annotations

import numpy as np
import torch

from graphcast_tpu_torch.fields import Field, FieldSet
from graphcast_tpu_torch.ops import sht


def white_noise_basis(lat: np.ndarray, lon: np.ndarray
                      ) -> sht.SphericalHarmonicBasis:
  """Synthesis basis for white noise on this grid (max_l = n_lon // 2)."""
  return sht.SphericalHarmonicBasis(lat, lon, np.shape(lon)[0] // 2)


def sample_spherical_noise(generator,
                           power_spectrum: np.ndarray,
                           batch_shape: tuple[int, ...], basis: dict,
                           dtype=torch.float32) -> torch.Tensor:
  """GP noise on the sphere with the given power spectrum, [*batch_shape,
  lat, lon]; its pointwise variance is sum(power_spectrum). ``basis``:
  ``SphericalHarmonicBasis.tensors`` on the data's device; ``generator``
  a torch.Generator or one per batch entry (``randn``)."""
  max_l = int(np.shape(power_spectrum)[0])
  # Coefficient variance 4π·power[l]/(2l+1), split over the 2l+1 real
  # harmonics of wavenumber l (reference: samplers_utils.py:296-313).
  ls = np.arange(max_l)
  per_coeff_std = np.sqrt(4.0 * np.pi * np.asarray(power_spectrum)
                          / (2.0 * ls + 1.0))
  tri_mask = np.arange(max_l)[None, :] <= ls[:, None]
  device = basis["legendre"].device
  scale = torch.as_tensor((per_coeff_std[:, None] * tri_mask).astype(
      np.float32), device=device)
  shape = tuple(batch_shape) + (max_l, max_l)
  cos_coeffs = randn(generator, shape).to(device) * scale
  sin_coeffs = randn(generator, shape).to(device) * scale
  return sht.synthesize_with(basis, cos_coeffs, sin_coeffs).to(dtype)


def randn(generator, shape: tuple[int, ...]) -> torch.Tensor:
  """Standard normal draws of ``shape`` on the generator's device. A
  sequence of generators, one per entry of the leading (batch) dim, draws
  each entry from its own: an ensemble member's noise then depends on its
  stream alone, not on which members share a batch or a rank
  (rollout.member_generators)."""
  if isinstance(generator, torch.Generator):
    return torch.randn(shape, generator=generator, device=generator.device)
  if len(generator) != shape[0]:
    raise ValueError(f"{len(generator)} generators for a batch of "
                     f"{shape[0]}")
  return torch.stack([torch.randn(shape[1:], generator=g, device=g.device)
                      for g in generator])


def spherical_white_noise_like(generator: torch.Generator,
                               template: FieldSet, basis: dict) -> FieldSet:
  """Unit marginal-variance isotropic white noise shaped like ``template``
  (flat power spectrum over n_lon // 2 wavenumbers; reference:
  samplers_utils.py:319-331), one draw per variable in name order."""
  num_wavenumbers = basis["cos_mat"].shape[0]
  power = np.full(num_wavenumbers, 1.0 / num_wavenumbers)
  fields = {}
  for name in template.var_names:
    f = template[name]
    if f.dims[-2:] != ("lat", "lon"):
      raise ValueError(
          f"{name}: expected trailing (lat, lon) dims, got {f.dims}")
    fields[name] = Field(sample_spherical_noise(
        generator, power, f.shape[:-2], basis, dtype=f.dtype), f.dims)
  return FieldSet(fields, coords=template.coords)


def rho_inverse_cdf(min_value: float, max_value: float, rho: float, cdf):
  """Quantiles of the EDM rho distribution (Karras et al. eq. 5)."""
  return (min_value ** (1 / rho)
          + cdf * (max_value ** (1 / rho) - min_value ** (1 / rho))) ** rho


def noise_schedule(max_noise_level: float = 80.0,
                   min_noise_level: float = 0.002,
                   num_noise_levels: int = 30,
                   rho: float = 7.0) -> np.ndarray:
  """Descending σ schedule with a final appended 0."""
  levels = rho_inverse_cdf(min_noise_level, max_noise_level, rho,
                           np.linspace(1, 0, num_noise_levels))
  return np.append(levels, 0.0)


def stochastic_churn_rate_schedule(
    noise_levels: np.ndarray,
    stochastic_churn_rate: float = 0.0,
    churn_min_noise_level: float = 0.05,
    churn_max_noise_level: float = 50.0) -> np.ndarray:
  """Per-level churn rate, clamped to √2 − 1."""
  num = len(noise_levels) - 1
  per_step = min(stochastic_churn_rate / num, np.sqrt(2) - 1)
  active = ((churn_min_noise_level <= noise_levels[:-1])
            & (noise_levels[:-1] <= churn_max_noise_level))
  return active * per_step


def apply_stochastic_churn(generator: torch.Generator, x: FieldSet,
                           noise_level: torch.Tensor,
                           stochastic_churn_rate: torch.Tensor,
                           noise_level_inflation_factor: float,
                           basis: dict) -> tuple[FieldSet, torch.Tensor]:
  """Renoises x to a slightly higher noise level (reference:
  samplers_utils.py:418-435). Scalars are 0-d tensors in x's dtype."""
  new_noise_level = noise_level * (1.0 + stochastic_churn_rate)
  noise_diff = torch.clamp(new_noise_level ** 2 - noise_level ** 2, min=0.0)
  extra_stddev = torch.sqrt(noise_diff) * noise_level_inflation_factor
  noise = spherical_white_noise_like(generator, x, basis)
  updated = FieldSet(
      {n: Field(x[n].data + noise[n].data.to(x[n].dtype)
                * extra_stddev.to(x[n].dtype), x[n].dims)
       for n in x.var_names}, coords=x.coords)
  return updated, new_noise_level
