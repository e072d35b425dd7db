"""The system under test, graphcast_tpu_torch, as the benchmark builds and
feeds it: the predictor stacks of a configuration's file, the weights and
statistics of ``data.py`` loaded into them, and FieldSets of the fields
``data.py`` draws. Only its public entries are used."""

from __future__ import annotations

import numpy as np
import torch

from graphcast_tpu_torch.fields import Field, FieldSet
from graphcast_tpu_torch.models import configs
from graphcast_tpu_torch.models.graphcast import GraphCast
from graphcast_tpu_torch.wrappers import (
    Autoregressive, Bfloat16Cast, InputsAndResiduals)


def task_config(cfg) -> configs.TaskConfig:
  return configs.TaskConfig(
      input_variables=tuple(cfg["input_variables"]),
      target_variables=tuple(cfg["target_variables"]),
      forcing_variables=tuple(cfg["forcing_variables"]),
      pressure_levels=tuple(cfg["pressure_levels"]),
      input_duration=cfg["input_duration"])


def graphcast_stack(cfg, weights: dict, stats: dict, device,
                    gradient_checkpointing: bool = False):
  """(GraphCast, Autoregressive(InputsAndResiduals(Bfloat16Cast(it)))) at
  the file's sizes, holding ``weights``; the geometry comes from the
  program's disk cache (``GRAPHCAST_TPU_CACHE``)."""
  model = GraphCast(
      configs.ModelConfig(
          resolution=cfg["resolution"], mesh_size=cfg["mesh_size"],
          latent_size=cfg["latent_size"], gnn_msg_steps=cfg["gnn_msg_steps"],
          hidden_layers=cfg["hidden_layers"],
          radius_query_fraction_edge_length=cfg[
              "radius_query_fraction_edge_length"]),
      task_config(cfg), generator=torch.Generator().manual_seed(0),
      device=device)
  load_weights(model, weights)
  stddev, mean, diffs = (stats_fieldset(cfg, stats[k])
                         for k in ("stddev", "mean", "diffs_stddev"))
  stack = Autoregressive(
      InputsAndResiduals(Bfloat16Cast(model), stddev_by_level=stddev,
                         mean_by_level=mean, diffs_stddev_by_level=diffs),
      gradient_checkpointing=gradient_checkpointing)
  return model, stack


def gencast_stack(cfg, weights: dict, stats: dict, device):
  """(GenCast, InputsAndResiduals(it)) at the file's sizes, holding
  ``weights``: the block-sparse attention (K6), the geometry from the
  program's disk cache (``GRAPHCAST_TPU_CACHE``)."""
  from graphcast_tpu_torch.models import gencast
  from graphcast_tpu_torch.models.denoiser import (
      DenoiserArchitectureConfig, NoiseEncoderConfig)
  from graphcast_tpu_torch.models.sparse_transformer import (
      SparseTransformerConfig)
  t, s, ne = cfg["transformer"], cfg["sampler"], cfg["noise_encoder"]
  arch = DenoiserArchitectureConfig(
      sparse_transformer_config=SparseTransformerConfig(
          attention_k_hop=t["attention_k_hop"], d_model=t["d_model"],
          num_layers=t["num_layers"], num_heads=t["num_heads"],
          ffw_hidden=t["ffw_hidden"], activation=t["activation"],
          attention_type="splash_mha"),
      mesh_size=cfg["mesh_size"], latent_size=cfg["latent_size"],
      hidden_layers=cfg["hidden_layers"],
      radius_query_fraction_edge_length=cfg[
          "radius_query_fraction_edge_length"])
  churn_max = s["churn_max_noise_level"]
  model = gencast.GenCast(
      task_config(cfg), arch,
      sampler_config=gencast.SamplerConfig(
          max_noise_level=s["max_noise_level"],
          min_noise_level=s["min_noise_level"],
          num_noise_levels=s["num_noise_levels"], rho=s["rho"],
          stochastic_churn_rate=s["stochastic_churn_rate"],
          churn_min_noise_level=s["churn_min_noise_level"],
          churn_max_noise_level=(float("inf") if churn_max is None
                                 else churn_max),
          noise_level_inflation_factor=s["noise_level_inflation_factor"]),
      noise_encoder_config=NoiseEncoderConfig(
          apply_log_first=ne["apply_log_first"],
          base_period=ne["base_period"],
          num_frequencies=ne["num_frequencies"],
          output_sizes=tuple(ne["output_sizes"])),
      generator=torch.Generator().manual_seed(0), device=device)
  load_weights(model, weights)
  stddev, mean, diffs = (stats_fieldset(cfg, stats[k])
                         for k in ("stddev", "mean", "diffs_stddev"))
  return model, InputsAndResiduals(model, stddev_by_level=stddev,
                                   mean_by_level=mean,
                                   diffs_stddev_by_level=diffs)


def load_weights(model: torch.nn.Module, weights: dict):
  """Copies ``weights`` into the model's parameters; the two name sets
  and shapes must agree."""
  params = dict(model.named_parameters())
  if set(params) != set(weights):
    raise ValueError(
        f"the program's parameters differ from the benchmark's: only in the "
        f"program {sorted(set(params) - set(weights))[:5]}, only in the "
        f"benchmark {sorted(set(weights) - set(params))[:5]}")
  with torch.no_grad():
    for name, p in params.items():
      if tuple(p.shape) != tuple(weights[name].shape):
        raise ValueError(f"{name}: program shape {tuple(p.shape)}, "
                         f"benchmark shape {tuple(weights[name].shape)}")
      p.copy_(weights[name])


def stats_fieldset(cfg, stats: dict) -> FieldSet:
  return FieldSet(
      {name: Field(t, ("level",) if t.ndim else ())
       for name, t in stats.items()},
      coords={"level": np.asarray(cfg["pressure_levels"], np.int32)})


def dims_of(cfg, name: str) -> tuple[str, ...]:
  if name in cfg["static_variables"]:
    return ("lat", "lon")
  if name in cfg["atmospheric_variables"]:
    return ("batch", "time", "level", "lat", "lon")
  return ("batch", "time", "lat", "lon")


def fieldset(cfg, fields: dict, step_hours: int, first_step: int
             ) -> FieldSet:
  """A FieldSet of ``fields`` (data.make_fields' layout) whose time
  coordinates are steps ``first_step``, ``first_step`` + 1, ... of
  ``step_hours``."""
  res = cfg["resolution"]
  times = next((t.shape[1] for n, t in fields.items()
                if n not in cfg["static_variables"]), 1)
  time = ((np.arange(times) + first_step) * np.timedelta64(step_hours, "h")
          ).astype("timedelta64[ns]")
  return FieldSet(
      {n: Field(t, dims_of(cfg, n)) for n, t in fields.items()},
      coords={"lat": np.arange(-90.0, 90.0 + res / 2, res).astype(np.float32),
              "lon": np.arange(0.0, 360.0, res).astype(np.float32),
              "level": np.asarray(cfg["pressure_levels"], np.int32),
              "time": time})
