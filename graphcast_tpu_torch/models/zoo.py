"""Released-model presets, as constructors.

Copy of graphcast_tpu/models/zoo.py. Checkpoint-name ↔ preset:

- "GraphCast - ERA5 1979-2017 - resolution 0.25 - pressure levels 37 -
  mesh 2to6 - precipitation input and output" → :func:`graphcast`
- "GraphCast_small - ERA5 1979-2015 - resolution 1.0 - pressure levels 13 -
  mesh 2to5 - precipitation input and output" → :func:`graphcast_small`
- "GraphCast_operational - ERA5-HRES 1979-2021 - resolution 0.25 -
  pressure levels 13 - mesh 2to6 - precipitation output only"
  → :func:`graphcast_operational`
- "GenCast 0p25deg <2019" / "GenCast 0p25deg Operational <2022" (mesh-6)
  → :func:`gencast_0p25deg`
- "GenCast 1p0deg <2019" (mesh-5) → :func:`gencast_1p0deg`
- "GenCast 1p0deg Mini <2019" (mesh-4) → :func:`gencast_mini`
"""

from __future__ import annotations

import dataclasses

import torch

from graphcast_tpu_torch import devices
from graphcast_tpu_torch.models import configs


@dataclasses.dataclass(frozen=True)
class GraphCastPreset:
  name: str
  model_config: configs.ModelConfig
  task_config: configs.TaskConfig


def graphcast() -> GraphCastPreset:
  """The GraphCast-paper model: 0.25°, 37 levels, mesh 2-6."""
  return GraphCastPreset(
      name="GraphCast",
      model_config=configs.ModelConfig(resolution=0.25, mesh_size=6),
      task_config=configs.TASK)


def graphcast_small() -> GraphCastPreset:
  """Low-resource variant: 1.0°, 13 levels, mesh 2-5."""
  return GraphCastPreset(
      name="GraphCast_small",
      model_config=configs.ModelConfig(resolution=1.0, mesh_size=5),
      task_config=configs.TASK_13)


def graphcast_operational() -> GraphCastPreset:
  """HRES-initialisable variant: 0.25°, 13 levels, mesh 2-6, precipitation
  output only."""
  return GraphCastPreset(
      name="GraphCast_operational",
      model_config=configs.ModelConfig(resolution=0.25, mesh_size=6),
      task_config=configs.TASK_13_PRECIP_OUT)


GRAPHCAST_PRESETS = {
    "GraphCast": graphcast,
    "GraphCast_small": graphcast_small,
    "GraphCast_operational": graphcast_operational,
}


@dataclasses.dataclass(frozen=True)
class GenCastPreset:
  name: str
  resolution: float
  task_config: configs.TaskConfig
  denoiser_architecture_config: "object"
  sampler_config: "object"
  noise_config: "object"
  noise_encoder_config: "object"

  def build(self, *, generator: torch.Generator,
            device: torch.device | str = devices.DEFAULT_DEVICE,
            **gencast_kwargs):
    """The GenCast predictor of this preset, parameters drawn from
    ``generator`` (CPU) and moved to ``device``. Other keywords pass through
    to ``gencast.GenCast``, as the JAX preset's do (``decode_chunks``,
    ``encode_chunks``, ``fused_aggregation``, ``cache_dir``,
    ``sequence_parallel``): execution forms that do not change the
    architecture."""
    from graphcast_tpu_torch.models import gencast
    return gencast.GenCast(
        task_config=self.task_config,
        denoiser_architecture_config=self.denoiser_architecture_config,
        sampler_config=self.sampler_config,
        noise_config=self.noise_config,
        noise_encoder_config=self.noise_encoder_config,
        generator=generator, device=device, **gencast_kwargs)


def gencast_custom(resolution: float, mesh_size: int, d_model: int = 512,
                   num_layers: int = 16, num_heads: int = 4,
                   latent_size: int = 512,
                   name: str = "GenCast (custom)") -> GenCastPreset:
  """The released GenCast architecture (arXiv 2312.15796 §A) at any
  resolution and mesh size: 512-latent GNN encoder/decoder, 16-layer,
  4-head, k-hop-16 sparse transformer on the mesh."""
  from graphcast_tpu_torch.models import gencast
  from graphcast_tpu_torch.models.denoiser import (
      DenoiserArchitectureConfig, NoiseEncoderConfig)
  from graphcast_tpu_torch.models.sparse_transformer import (
      SparseTransformerConfig)
  st_cfg = SparseTransformerConfig(
      attention_k_hop=16, d_model=d_model, num_layers=num_layers,
      num_heads=num_heads, attention_type="splash_mha")
  arch = DenoiserArchitectureConfig(
      sparse_transformer_config=st_cfg, mesh_size=mesh_size,
      latent_size=latent_size, hidden_layers=1)
  return GenCastPreset(
      name=name, resolution=resolution, task_config=gencast.TASK,
      denoiser_architecture_config=arch,
      sampler_config=gencast.SamplerConfig(),
      noise_config=gencast.NoiseConfig(),
      noise_encoder_config=NoiseEncoderConfig())


def gencast_0p25deg() -> GenCastPreset:
  """GenCast 0p25deg (and the Operational <2022 fine-tune): 13 levels,
  mesh-6."""
  return gencast_custom(0.25, 6, name="GenCast 0p25deg")


def gencast_1p0deg() -> GenCastPreset:
  """GenCast 1p0deg <2019: 13 levels, mesh-5."""
  return gencast_custom(1.0, 5, name="GenCast 1p0deg")


def gencast_mini() -> GenCastPreset:
  """GenCast 1p0deg Mini <2019: 13 levels, mesh-4."""
  return gencast_custom(1.0, 4, name="GenCast 1p0deg Mini")


GENCAST_PRESETS = {
    "GenCast 0p25deg": gencast_0p25deg,
    "GenCast 1p0deg": gencast_1p0deg,
    "GenCast 1p0deg Mini": gencast_mini,
}
