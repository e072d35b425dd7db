"""GenCast: the diffusion-based probabilistic weather predictor.

Port of graphcast_tpu/models/gencast.py (reference: graphcast/gencast.py):
the norm-conditioned denoiser (models/denoiser.py), preconditioned with the
EDM c_in / c_out / c_skip scalings, sampled with DPM-Solver++ 2S and
stochastic churn on spherical noise (diffusion/), and trained with the
λ(σ)-weighted denoising loss (``loss``). One call predicts one 12 h step;
at batch > 1 (an ensemble's members, rollout.chunked_ensemble_prediction)
every member draws its own noise and takes its own σ. The randomness of
sampling and of the loss's σ and noise comes from the ``generator``
keyword argument, a ``torch.Generator`` on the data's device.

The spherical-harmonic synthesis basis of the targets' grid lives on the
module as non-trainable float32 buffers (``noise_basis_*``), built at the
first call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from graphcast_tpu_torch import devices, losses
from graphcast_tpu_torch.diffusion import noise as noise_lib
from graphcast_tpu_torch.diffusion.samplers import DPMSolverPlusPlus2S
from graphcast_tpu_torch.fields import Field, FieldSet, align_for_broadcast
from graphcast_tpu_torch.models import configs
from graphcast_tpu_torch.models.base import Predictor
from graphcast_tpu_torch.models.denoiser import (
    Denoiser, DenoiserArchitectureConfig, NoiseEncoderConfig)
from graphcast_tpu_torch.nn import core

# GenCast variable vocabularies (reference: gencast.py:40-71).
TARGET_SURFACE_VARS = (
    "2m_temperature",
    "mean_sea_level_pressure",
    "10m_v_component_of_wind",
    "10m_u_component_of_wind",
    "total_precipitation_12hr",
    "sea_surface_temperature",
)
TARGET_SURFACE_NO_PRECIP_VARS = (
    "2m_temperature",
    "mean_sea_level_pressure",
    "10m_v_component_of_wind",
    "10m_u_component_of_wind",
    "sea_surface_temperature",
)

TASK = configs.TaskConfig(
    input_variables=(
        TARGET_SURFACE_NO_PRECIP_VARS + configs.TARGET_ATMOSPHERIC_VARS
        + configs.GENERATED_FORCING_VARS + configs.STATIC_VARS),
    target_variables=TARGET_SURFACE_VARS + configs.TARGET_ATMOSPHERIC_VARS,
    forcing_variables=configs.GENERATED_FORCING_VARS,
    pressure_levels=configs.PRESSURE_LEVELS_WEATHERBENCH_13,
    input_duration="24h",
)

GENCAST_LOSS_WEIGHTS = {
    "2m_temperature": 1.0,
    "10m_u_component_of_wind": 0.1,
    "10m_v_component_of_wind": 0.1,
    "mean_sea_level_pressure": 0.1,
    "sea_surface_temperature": 0.1,
    "total_precipitation_12hr": 0.1,
}

_BASIS_KEYS = ("legendre", "cos_mat", "sin_mat", "m_scale", "sin_mask")


@dataclasses.dataclass(frozen=True, eq=True)
class SamplerConfig:
  """Reference: gencast.py:74-109."""
  max_noise_level: float = 80.0
  min_noise_level: float = 0.03
  num_noise_levels: int = 20
  rho: float = 7.0
  stochastic_churn_rate: float = 2.5
  churn_min_noise_level: float = 0.75
  churn_max_noise_level: float = float("inf")
  noise_level_inflation_factor: float = 1.05


@dataclasses.dataclass(frozen=True, eq=True)
class NoiseConfig:
  """Reference: gencast.py:111-115: the rho distribution of the training
  noise levels σ."""
  training_noise_level_rho: float = 7.0
  training_max_noise_level: float = 88.0
  training_min_noise_level: float = 0.02


def _scale_by(fs: FieldSet, scale_batch: torch.Tensor) -> FieldSet:
  """Multiplies every variable by a per-batch scalar, in its dtype."""
  def fn(name, f):
    s = align_for_broadcast(Field(scale_batch.to(f.dtype), ("batch",)), f)
    return Field(f.data * s, f.dims)
  return fs.map(fn)


def _add(a: FieldSet, b: FieldSet) -> FieldSet:
  return FieldSet({n: Field(a[n].data + b[n].data, a[n].dims)
                   for n in a.var_names}, coords=a.coords)


class GenCast(Denoiser, Predictor):
  """Conditional EDM diffusion predictor (reference: gencast.py:130-284).

  A denoiser (``denoise``) whose ``forward`` samples: its parameters are the
  denoiser's, under the JAX package's keys ``noise_encoder/…`` and
  ``architecture/…``.
  """

  def __init__(self, task_config: configs.TaskConfig,
               denoiser_architecture_config: DenoiserArchitectureConfig,
               sampler_config: Optional[SamplerConfig] = None,
               noise_config: Optional[NoiseConfig] = None,
               noise_encoder_config: Optional[NoiseEncoderConfig] = None,
               cache_dir: Optional[str] = None,
               interpret_attention: Optional[bool] = None,
               decode_chunks: int = 1,
               encode_chunks: int = 1,
               fused_aggregation: Optional[bool] = None,
               sequence_parallel: Optional[tuple] = None, *,
               generator: torch.Generator,
               device: torch.device | str = devices.DEFAULT_DEVICE):
    """Parameters are drawn on the CPU from ``generator`` (a CPU generator),
    then moved to ``device`` (the card unless the caller asks for "cpu");
    or loaded later with params.load_params. The keywords between are the
    JAX package's: ``cache_dir``, ``decode_chunks``, ``encode_chunks`` and
    ``fused_aggregation`` go to the denoiser (models/denoiser.py);
    ``interpret_attention``, the JAX package's Pallas interpret-mode
    switch, is not ported (the tensors' device picks the kernel or its
    plain version), and asking for it raises NotImplementedError.
    ``sequence_parallel``, a (parallel.sharding mesh, axis name) pair,
    splits the transformer's node axis over that axis
    (sparse_transformer.Transformer.enable_sequence_parallel; every rank of
    the axis runs the same call)."""
    if interpret_attention is not None:
      raise NotImplementedError(
          f"GenCast: interpret_attention={interpret_attention!r} (Pallas "
          "interpret mode) is not ported")
    device = devices.resolve(device)
    super().__init__(noise_encoder_config, dataclasses.replace(
        denoiser_architecture_config,
        node_output_size=configs.num_output_channels(task_config)),
                     task_config, cache_dir=cache_dir,
                     decode_chunks=decode_chunks,
                     encode_chunks=encode_chunks,
                     fused_aggregation=fused_aggregation)
    self._sampler_config = sampler_config
    self._noise_config = noise_config
    self._task_config = task_config
    core.reset_parameters(self, generator)
    if sequence_parallel is not None:
      self.architecture.mesh_transformer.enable_sequence_parallel(
          *sequence_parallel)
    self.to(device)

  # --- EDM preconditioning (reference: gencast.py:177-208) ---

  @staticmethod
  def _c_in(sigma):
    return (sigma ** 2 + 1) ** -0.5

  @staticmethod
  def _c_out(sigma):
    return sigma * (sigma ** 2 + 1) ** -0.5

  @staticmethod
  def _c_skip(sigma):
    return 1 / (sigma ** 2 + 1)

  def _loss_weighting(self, sigma):
    """λ(σ) = c_out(σ)⁻² (EDM eq. 8)."""
    return self._c_out(sigma) ** -2

  def _preconditioned_denoiser(self, inputs, noisy_targets, noise_levels,
                               forcings):
    """D(x; σ) = c_skip·x + c_out·F(c_in·x; σ) (EDM eq. 7)."""
    raw = self.denoise(inputs, _scale_by(noisy_targets,
                                         self._c_in(noise_levels)),
                       noise_levels, forcings)
    return _add(_scale_by(raw, self._c_out(noise_levels)),
                _scale_by(noisy_targets, self._c_skip(noise_levels)))

  def noise_basis(self, targets_template: FieldSet) -> dict:
    """The SHT synthesis tensors of the targets' grid (f32 buffers on the
    targets' device, built at the first call)."""
    device = targets_template[targets_template.var_names[0]].data.device
    with torch.inference_mode(False):  # usable under autograd later
      if not hasattr(self, "noise_basis_legendre"):
        coords = targets_template.coords
        arrays = noise_lib.white_noise_basis(coords["lat"],
                                             coords["lon"]).arrays()
        for k in _BASIS_KEYS:
          self.register_buffer(f"noise_basis_{k}",
                               torch.as_tensor(arrays[k]), persistent=False)
      if self.noise_basis_legendre.device != device:
        for k in _BASIS_KEYS:
          setattr(self, f"noise_basis_{k}",
                  getattr(self, f"noise_basis_{k}").to(device))
    return {k: getattr(self, f"noise_basis_{k}") for k in _BASIS_KEYS}

  def forward(self, inputs: FieldSet, targets_template: FieldSet,
              forcings: FieldSet,
              generator: Optional[torch.Generator] = None) -> FieldSet:
    if self._sampler_config is None:
      raise ValueError("sampler config required for inference")
    if generator is None:
      raise ValueError("GenCast samples: pass generator=torch.Generator")
    if targets_template.sizes.get("time", 1) != 1:
      # The denoiser appends every noisy-target frame as feature channels:
      # GenCast is a one-step (12 h) predictor (reference: gencast.py:186).
      raise ValueError(
          "GenCast predicts exactly one target step per call; got a "
          f"targets_template with {targets_template.sizes['time']} time "
          "steps")
    sampler = DPMSolverPlusPlus2S(self._preconditioned_denoiser,
                                  **dataclasses.asdict(self._sampler_config))
    return sampler(generator, inputs, targets_template, forcings,
                   self.noise_basis(targets_template))

  # --- training (reference: gencast.py:207-239) ---

  def _draw_noise(self, targets: FieldSet, generator: torch.Generator):
    """σ [batch] from the rho distribution (a uniform draw in the targets'
    dtype) and unit spherical white noise shaped like ``targets``."""
    if self._noise_config is None:
      raise ValueError("noise config required for training")
    nc = self._noise_config
    dtypes = {f.dtype for f in targets.values()}
    dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32
    device = targets[targets.var_names[0]].data.device
    uniform = torch.rand(targets.sizes["batch"], generator=generator,
                         device=generator.device, dtype=dtype).to(device)
    sigma = noise_lib.rho_inverse_cdf(
        min_value=nc.training_min_noise_level,
        max_value=nc.training_max_noise_level,
        rho=nc.training_noise_level_rho, cdf=uniform)
    noise = noise_lib.spherical_white_noise_like(
        generator, targets, self.noise_basis(targets))
    return sigma, noise

  def _loss_at(self, inputs: FieldSet, targets: FieldSet, forcings: FieldSet,
               sigma: torch.Tensor, noise: FieldSet):
    """The λ(σ)-weighted MSE of the denoised targets + σ·noise."""
    noisy = _add(targets, _scale_by(noise, sigma))
    denoised = self._preconditioned_denoiser(inputs, noisy, sigma, forcings)
    weights = {k: v for k, v in GENCAST_LOSS_WEIGHTS.items()
               if k in targets.var_names}
    loss, diagnostics = losses.weighted_mse_per_level(
        denoised, targets, per_variable_weights=weights)
    return loss * self._loss_weighting(sigma).to(loss.dtype), diagnostics

  def loss(self, inputs: FieldSet, targets: FieldSet, forcings: FieldSet, *,
           generator: torch.Generator) -> losses.LossAndDiagnostics:
    """Denoising score-matching loss: σ and spherical noise drawn from
    ``generator``, one preconditioned denoiser evaluation on targets +
    σ·noise, the GenCast-weighted MSE scaled by λ(σ). Returns (loss
    [batch], {var: [batch]})."""
    return self._loss_at(inputs, targets, forcings,
                         *self._draw_noise(targets, generator))

  def loss_and_predictions(self, inputs: FieldSet, targets: FieldSet,
                           forcings: FieldSet, *,
                           generator: torch.Generator):
    """The loss and a sample for the targets' times, both from
    ``generator`` (reference: gencast.py:207-211)."""
    loss = self.loss(inputs, targets, forcings, generator=generator)
    return loss, self(inputs, targets, forcings, generator=generator)
