"""Released GraphCast presets, as constructors.

Copy of the three GraphCast presets of graphcast_tpu/models/zoo.py (the
GenCast presets wait for the GenCast port). Checkpoint-name ↔ preset:

- "GraphCast - ERA5 1979-2017 - resolution 0.25 - pressure levels 37 -
  mesh 2to6 - precipitation input and output" → :func:`graphcast`
- "GraphCast_small - ERA5 1979-2015 - resolution 1.0 - pressure levels 13 -
  mesh 2to5 - precipitation input and output" → :func:`graphcast_small`
- "GraphCast_operational - ERA5-HRES 1979-2021 - resolution 0.25 -
  pressure levels 13 - mesh 2to6 - precipitation output only"
  → :func:`graphcast_operational`
"""

from __future__ import annotations

import dataclasses

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
