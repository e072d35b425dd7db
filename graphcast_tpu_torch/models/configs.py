"""Task / model configuration dataclasses and ERA5 variable vocabularies.

Pinned copy of graphcast_tpu/models/configs.py (that package imports jax at
its root); tests/test_torch_params.py asserts that the two agree.

The variable name vocabularies, pressure-level sets, and canned task configs
are data facts shared with the reference (graphcast.py:50-210) — they name
ERA5/HRES quantities and the published model setups.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

PRESSURE_LEVELS_ERA5_37 = (
    1, 2, 3, 5, 7, 10, 20, 30, 50, 70, 100, 125, 150, 175, 200, 225, 250, 300,
    350, 400, 450, 500, 550, 600, 650, 700, 750, 775, 800, 825, 850, 875, 900,
    925, 950, 975, 1000)

PRESSURE_LEVELS_HRES_25 = (
    1, 2, 3, 5, 7, 10, 20, 30, 50, 70, 100, 150, 200, 250, 300, 400, 500, 600,
    700, 800, 850, 900, 925, 950, 1000)

PRESSURE_LEVELS_WEATHERBENCH_13 = (
    50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000)

PRESSURE_LEVELS = {
    13: PRESSURE_LEVELS_WEATHERBENCH_13,
    25: PRESSURE_LEVELS_HRES_25,
    37: PRESSURE_LEVELS_ERA5_37,
}

ALL_ATMOSPHERIC_VARS = (
    "potential_vorticity",
    "specific_rain_water_content",
    "specific_snow_water_content",
    "geopotential",
    "temperature",
    "u_component_of_wind",
    "v_component_of_wind",
    "specific_humidity",
    "vertical_velocity",
    "vorticity",
    "divergence",
    "relative_humidity",
    "ozone_mass_mixing_ratio",
    "specific_cloud_liquid_water_content",
    "specific_cloud_ice_water_content",
    "fraction_of_cloud_cover",
)

TARGET_SURFACE_VARS = (
    "2m_temperature",
    "mean_sea_level_pressure",
    "10m_v_component_of_wind",
    "10m_u_component_of_wind",
    "total_precipitation_6hr",
)
TARGET_SURFACE_NO_PRECIP_VARS = (
    "2m_temperature",
    "mean_sea_level_pressure",
    "10m_v_component_of_wind",
    "10m_u_component_of_wind",
)
TARGET_ATMOSPHERIC_VARS = (
    "temperature",
    "geopotential",
    "u_component_of_wind",
    "v_component_of_wind",
    "vertical_velocity",
    "specific_humidity",
)
TARGET_ATMOSPHERIC_NO_W_VARS = (
    "temperature",
    "geopotential",
    "u_component_of_wind",
    "v_component_of_wind",
    "specific_humidity",
)
EXTERNAL_FORCING_VARS = (
    "toa_incident_solar_radiation",
)
GENERATED_FORCING_VARS = (
    "year_progress_sin",
    "year_progress_cos",
    "day_progress_sin",
    "day_progress_cos",
)
FORCING_VARS = EXTERNAL_FORCING_VARS + GENERATED_FORCING_VARS
STATIC_VARS = (
    "geopotential_at_surface",
    "land_sea_mask",
)

# Per-variable loss weights for surface variables
# (reference: graphcast.py:401-415).
GRAPHCAST_LOSS_WEIGHTS = {
    "2m_temperature": 1.0,
    "10m_u_component_of_wind": 0.1,
    "10m_v_component_of_wind": 0.1,
    "mean_sea_level_pressure": 0.1,
    "total_precipitation_6hr": 0.1,
}


@dataclasses.dataclass(frozen=True, eq=True)
class TaskConfig:
  """What the model consumes and predicts (reference: graphcast.py:135-143)."""
  input_variables: tuple[str, ...]
  target_variables: tuple[str, ...]
  forcing_variables: tuple[str, ...]
  pressure_levels: tuple[int, ...]
  input_duration: str  # e.g. "12h": two 6h input frames


TASK = TaskConfig(
    input_variables=(
        TARGET_SURFACE_VARS + TARGET_ATMOSPHERIC_VARS + FORCING_VARS
        + STATIC_VARS),
    target_variables=TARGET_SURFACE_VARS + TARGET_ATMOSPHERIC_VARS,
    forcing_variables=FORCING_VARS,
    pressure_levels=PRESSURE_LEVELS_ERA5_37,
    input_duration="12h",
)
TASK_13 = dataclasses.replace(
    TASK, pressure_levels=PRESSURE_LEVELS_WEATHERBENCH_13)
TASK_13_PRECIP_OUT = dataclasses.replace(
    TASK_13,
    input_variables=(
        TARGET_SURFACE_NO_PRECIP_VARS + TARGET_ATMOSPHERIC_VARS + FORCING_VARS
        + STATIC_VARS))


@dataclasses.dataclass(frozen=True, eq=True)
class ModelConfig:
  """GraphCast architecture config (reference: graphcast.py:174-201)."""
  resolution: float
  mesh_size: int
  latent_size: int = 512
  gnn_msg_steps: int = 16
  hidden_layers: int = 1
  radius_query_fraction_edge_length: float = 0.6
  mesh2grid_edge_normalization_factor: Optional[float] = None


@dataclasses.dataclass(frozen=True, eq=True)
class CheckPoint:
  """Checkpoint bundle schema (reference: graphcast.py:204-210)."""
  params: dict[str, Any]
  model_config: ModelConfig
  task_config: TaskConfig
  description: str
  license: str


def num_output_channels(task_config: TaskConfig) -> int:
  """Surface targets + levels × atmospheric targets
  (reference: graphcast.py:298-303)."""
  surface = len(set(task_config.target_variables) - set(ALL_ATMOSPHERIC_VARS))
  atmos = len(set(task_config.target_variables) & set(ALL_ATMOSPHERIC_VARS))
  return surface + len(task_config.pressure_levels) * atmos
