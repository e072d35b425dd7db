"""DPM-Solver++ 2S with stochastic churn.

Port of graphcast_tpu/diffusion/samplers.py (reference:
dpm_solver_plus_plus_2s.py:28-187): the second-order single-step solver
with EDM σ(t) = t, s(t) = 1 and the geometric midpoint, run as a Python
loop over the descending noise schedule, two denoiser evaluations a level.

The σ schedule, the midpoint σ and the step ratios are rounded to the
state's dtype, as the JAX package rounds them. Two differences in the work
done, none in the result:

- the JAX loop evaluates the denoiser at the midpoint of the last level too,
  where σ_mid = sqrt(σ·0) = 0 (log 0 in the noise encoder, so NaN), and
  ``tree_where`` throws that result away; the port skips that evaluation,
  so a schedule of L levels costs 2L − 1 evaluations;
- the JAX loop draws initial noise at every level and multiplies it by 0
  past the first, and churn noise at levels whose churn rate is 0; the port
  draws neither.
"""

from __future__ import annotations

from typing import Callable

import torch

from graphcast_tpu_torch.diffusion import noise as noise_lib
from graphcast_tpu_torch.fields import Field, FieldSet
from graphcast_tpu_torch.wrappers.casting import infer_floating_dtype

# denoiser_fn(inputs=, noisy_targets=, noise_levels=[batch], forcings=)
DenoiserFn = Callable[..., FieldSet]


def _lerp(x: FieldSet, y: FieldSet, ratio: torch.Tensor) -> FieldSet:
  """x·ratio + y·(1 − ratio) per variable."""
  return FieldSet({n: Field(x[n].data * ratio + y[n].data * (1 - ratio),
                            x[n].dims) for n in x.var_names},
                  coords=x.coords)


class DPMSolverPlusPlus2S:
  """DPM-Solver++ 2S (reference: dpm_solver_plus_plus_2s.py:28-187)."""

  def __init__(self, denoiser_fn: DenoiserFn,
               max_noise_level: float = 80.0,
               min_noise_level: float = 0.03,
               num_noise_levels: int = 20,
               rho: float = 7.0,
               stochastic_churn_rate: float = 2.5,
               churn_min_noise_level: float = 0.75,
               churn_max_noise_level: float = float("inf"),
               noise_level_inflation_factor: float = 1.05):
    self._denoiser_fn = denoiser_fn
    self._noise_levels = noise_lib.noise_schedule(
        max_noise_level, min_noise_level, num_noise_levels, rho)
    self._stochastic_churn = stochastic_churn_rate > 0
    self._per_step_churn_rates = noise_lib.stochastic_churn_rate_schedule(
        self._noise_levels, stochastic_churn_rate, churn_min_noise_level,
        churn_max_noise_level)
    self._noise_level_inflation_factor = noise_level_inflation_factor

  def __call__(self, generator: torch.Generator, inputs: FieldSet,
               targets_template: FieldSet, forcings: FieldSet,
               basis: dict) -> FieldSet:
    """One sample shaped like ``targets_template``. ``basis``: the SHT
    synthesis tensors (``SphericalHarmonicBasis.tensors``) on the data's
    device."""
    dtype = infer_floating_dtype(targets_template)
    device = basis["legendre"].device
    noise_levels = torch.as_tensor(self._noise_levels, device=device).to(
        dtype)
    churn_rates = torch.as_tensor(self._per_step_churn_rates,
                                  device=device).to(dtype)
    batch = targets_template.sizes["batch"]

    def denoise(noise_level, x):
      return self._denoiser_fn(inputs=inputs, noisy_targets=x,
                               noise_levels=noise_level.expand(batch),
                               forcings=forcings)

    x = targets_template.map_data(torch.zeros_like)
    init = noise_lib.spherical_white_noise_like(generator, x, basis)
    x = FieldSet({n: Field(x[n].data + init[n].data * noise_levels[0],
                           x[n].dims) for n in x.var_names},
                 coords=x.coords)
    for i in range(len(self._noise_levels) - 1):
      noise_level = noise_levels[i]
      if self._stochastic_churn and self._per_step_churn_rates[i] > 0:
        x, noise_level = noise_lib.apply_stochastic_churn(
            generator, x, noise_level, churn_rates[i],
            self._noise_level_inflation_factor, basis)
      next_noise_level = noise_levels[i + 1]
      x_denoised = denoise(noise_level, x)
      if self._noise_levels[i + 1] == 0:
        # Final step to σ = 0: Euler, i.e. the denoised value (reference:
        # dpm_solver_plus_plus_2s.py:172-181); no midpoint evaluation.
        x = x_denoised
        break
      mid_noise_level = torch.sqrt(noise_level * next_noise_level)
      mid_over_current = (mid_noise_level / noise_level).to(dtype)
      x_mid = _lerp(x, x_denoised, mid_over_current)
      next_over_current = (next_noise_level / noise_level).to(dtype)
      x_mid_denoised = denoise(mid_noise_level, x_mid)
      x = _lerp(x, x_mid_denoised, next_over_current)
    return x
