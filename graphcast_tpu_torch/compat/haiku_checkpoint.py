"""Loading reference (Haiku) checkpoints into the port.

Pinned copy of graphcast_tpu/compat/haiku_checkpoint.py (numpy only, in a
package whose root imports jax): the regular expressions and the four
conversions between the flat Haiku naming and the nested native tree are
the original's, and tests/test_torch_checkpoint.py holds them equal to it.
The published GraphCast/GenCast checkpoints store Haiku parameter dicts
with flat module-path keys like

  grid2mesh_gnn/~_networks_builder/encoder_edges_grid2mesh_mlp/~/linear_0
  mesh_gnn/~_networks_builder/processor_edges_3_mesh_layer_norm

(reference: deep_typed_graph_net.py:198-321 for the module structure).

The port's own part is the bridge at the end: the native tree flattened
with "/" is exactly the port's flat parameter keys (params.py), so a bundle
loads into a ``GraphCast`` (or a GenCast's parameters) by renaming alone,
and a module's parameters write back out the same way. Unknown Haiku keys
raise, and so do missing or extra flat keys (params.load_params).
"""

from __future__ import annotations

import re
from typing import Any, BinaryIO, Union

import numpy as np
import torch
from torch import nn

from graphcast_tpu_torch import checkpoint as checkpoint_lib
from graphcast_tpu_torch import devices, params
from graphcast_tpu_torch.models import configs

_GNN_RE = re.compile(
    r"^(?P<gnn>[a-z0-9_]+)/~_networks_builder/(?P<rest>.+)$")
_MLP_RE = re.compile(r"^(?P<base>.+)_mlp/~/(?P<linear>linear_\d+)$")
_LN_RE = re.compile(r"^(?P<base>.+)_layer_norm$")
_NC_RE = re.compile(r"^(?P<base>.+)_norm_conditioning(/linear)?$")
# Reference processor prefixes are "processor_{edges|nodes}_{step}_{type}";
# ours are "processor_{step}_{edges|nodes}_{type}".
_PROC_RE = re.compile(r"^processor_(?P<kind>edges|nodes)_(?P<step>\d+)_"
                      r"(?P<type>.+)$")


def _map_base_name(base: str) -> str:
  m = _PROC_RE.match(base)
  if m:
    return f"processor_{m.group('step')}_{m.group('kind')}_{m.group('type')}"
  return base


def _unmap_base_name(base: str) -> str:
  m = re.match(r"^processor_(?P<step>\d+)_(?P<kind>edges|nodes)_(?P<type>.+)$",
               base)
  if m:
    return f"processor_{m.group('kind')}_{m.group('step')}_{m.group('type')}"
  return base


def haiku_params_to_native(haiku_params: dict[str, dict[str, np.ndarray]]
                           ) -> dict[str, Any]:
  """Flat Haiku param dict → this framework's nested GNN param tree."""
  out: dict[str, Any] = {}
  for key, value in haiku_params.items():
    gnn_match = _GNN_RE.match(key)
    if not gnn_match:
      raise ValueError(f"unrecognized haiku param key: {key!r}")
    gnn = gnn_match.group("gnn")
    rest = gnn_match.group("rest")
    dest = out.setdefault(gnn, {})

    mlp_match = _MLP_RE.match(rest)
    ln_match = _LN_RE.match(rest)
    nc_match = _NC_RE.match(rest)
    if mlp_match:
      base = _map_base_name(mlp_match.group("base"))
      dest.setdefault(base, {}).setdefault("mlp", {})[
          mlp_match.group("linear")] = {
              "w": np.asarray(value["w"]), "b": np.asarray(value["b"])}
    elif ln_match:
      base = _map_base_name(ln_match.group("base"))
      dest.setdefault(base, {})["layer_norm"] = {
          k: np.asarray(v) for k, v in value.items()}
    elif nc_match:
      base = _map_base_name(nc_match.group("base"))
      dest.setdefault(base, {})["norm_conditioning"] = {
          "w": np.asarray(value["w"]), "b": np.asarray(value["b"])}
    else:
      raise ValueError(f"unrecognized haiku module name: {rest!r}")
  return out


def native_params_to_haiku(native: dict[str, Any]
                           ) -> dict[str, dict[str, np.ndarray]]:
  """Inverse of haiku_params_to_native (for writing reference-format
  checkpoints)."""
  out: dict[str, dict[str, np.ndarray]] = {}
  for gnn, modules in native.items():
    if gnn == "graph_statics":
      # Derived graph data, not parameters — never serialized to the
      # reference format (the reference rebuilds graphs from configs).
      continue
    for base, parts in modules.items():
      ref_base = _unmap_base_name(base)
      for part_name, part in parts.items():
        if part_name == "mlp":
          for linear_name, lp in part.items():
            key = f"{gnn}/~_networks_builder/{ref_base}_mlp/~/{linear_name}"
            out[key] = {"w": np.asarray(lp["w"]), "b": np.asarray(lp["b"])}
        elif part_name == "layer_norm":
          key = f"{gnn}/~_networks_builder/{ref_base}_layer_norm"
          out[key] = {k: np.asarray(v) for k, v in part.items()}
        elif part_name == "norm_conditioning":
          key = (f"{gnn}/~_networks_builder/{ref_base}_norm_conditioning"
                 "/linear")
          out[key] = {"w": np.asarray(part["w"]), "b": np.asarray(part["b"])}
        else:
          raise ValueError(f"unknown param part {part_name!r}")
  return out


# --- GenCast (denoiser) conversion -----------------------------------------
# Haiku paths (verified against real dm-haiku init of the reference's own
# modules in tests/test_reference_parity.py):
#   mesh_transformer/~/transformer/block_{i:02d}/{mha_proj_*,mha_final,
#       ffw_up,ffw_down}
#   mesh_transformer/~/transformer/block_{i:02d}/
#       block_{i:02d}_norm_conditioning{,_1}/linear
#     (two UNSHARED norm-conditioning modules per block: attn pre-norm and
#      ffw pre-norm; haiku uniquifies the second instance with "_1")
#   mesh_transformer/~/transformer/transformer_final_norm_conditioning/linear
#   fourier_features_mlp/~/mlp/~/linear_{i}           (noise-level encoder)
#   {grid2mesh_gnn,mesh2grid_gnn}/~_networks_builder/...
# The "/~/" after mesh_transformer comes from the reference's
# @hk.name_like('__init__') lazy transformer construction
# (transformer.py:81-92).

_TRANSFORMER_RE = re.compile(
    r"^mesh_transformer/~/transformer/(?P<rest>.+)$")
_BLOCK_RE = re.compile(
    r"^(?P<block>block_\d+)/(?P<leaf>mha_proj_[qkv]|mha_final|ffw_up"
    r"|ffw_down)$")
_BLOCK_NC_RE = re.compile(
    r"^(?P<block>block_\d+)/(?P=block)_norm_conditioning(?P<suffix>_1)?"
    r"/linear$")
_FINAL_NC_RE = re.compile(
    r"^transformer_final_norm_conditioning/linear$")
_NOISE_ENC_RE = re.compile(
    r"^fourier_features_mlp/~/mlp/~/(?P<linear>linear_\d+)$")


def gencast_haiku_params_to_native(haiku_params) -> dict[str, Any]:
  """Flat Haiku GenCast params → our nested Denoiser param tree."""
  arch: dict[str, Any] = {}
  noise_encoder: dict[str, Any] = {}
  gnn_params = {}
  for key, value in haiku_params.items():
    tm = _TRANSFORMER_RE.match(key)
    nm = _NOISE_ENC_RE.match(key)
    if tm:
      rest = tm.group("rest")
      mesh_t = arch.setdefault("mesh_transformer", {})
      bm = _BLOCK_RE.match(rest)
      bnc = _BLOCK_NC_RE.match(rest)
      if bm:
        mesh_t.setdefault(bm.group("block"), {})[bm.group("leaf")] = {
            k: np.asarray(v) for k, v in value.items()}
      elif bnc:
        native_name = "norm_conditioning" + (bnc.group("suffix") or "")
        mesh_t.setdefault(bnc.group("block"), {})[native_name] = {
            "w": np.asarray(value["w"]), "b": np.asarray(value["b"])}
      elif _FINAL_NC_RE.match(rest):
        mesh_t["final_norm_conditioning"] = {
            "w": np.asarray(value["w"]), "b": np.asarray(value["b"])}
      else:
        raise ValueError(f"unrecognized transformer param: {rest!r}")
    elif nm:
      noise_encoder[nm.group("linear")] = {
          "w": np.asarray(value["w"]), "b": np.asarray(value["b"])}
    else:
      gnn_params[key] = value
  arch.update(haiku_params_to_native(gnn_params))
  return {"noise_encoder": noise_encoder, "architecture": arch}


def native_gencast_params_to_haiku(native) -> dict[str, Any]:
  """Inverse of gencast_haiku_params_to_native."""
  out: dict[str, Any] = {}
  native = {k: v for k, v in native.items()
            if k not in ("noise_statics", "graph_statics")}
  for linear, p in native.get("noise_encoder", {}).items():
    out[f"fourier_features_mlp/~/mlp/~/{linear}"] = {
        "w": np.asarray(p["w"]), "b": np.asarray(p["b"])}
  arch = native.get("architecture", {})
  gnns = {}
  for name, sub in arch.items():
    if name == "graph_statics":
      continue
    if name == "mesh_transformer":
      for block, parts in sub.items():
        if block == "final_norm_conditioning":
          out["mesh_transformer/~/transformer/"
              "transformer_final_norm_conditioning/linear"] = {
                  "w": np.asarray(parts["w"]), "b": np.asarray(parts["b"])}
          continue
        for leaf, p in parts.items():
          if leaf in ("norm_conditioning", "norm_conditioning_1"):
            suffix = leaf[len("norm_conditioning"):]
            key = (f"mesh_transformer/~/transformer/{block}/"
                   f"{block}_norm_conditioning{suffix}/linear")
          else:
            key = f"mesh_transformer/~/transformer/{block}/{leaf}"
          out[key] = {k: np.asarray(v) for k, v in p.items()}
    else:
      gnns[name] = sub
  out.update(native_params_to_haiku(gnns))
  return out


def load_graphcast_checkpoint(
    source: Union[str, BinaryIO], *,
    device: torch.device | str = devices.DEFAULT_DEVICE):
  """Loads a reference-format GraphCast checkpoint bundle into the port.

  Returns (model, model_config, task_config, description, license): a
  ``GraphCast`` built from the bundle's configs on ``device`` (the card
  unless the caller asks for "cpu") with the bundle's weights loaded bit
  for bit (reference schema: graphcast.py:204-210).
  """
  from graphcast_tpu_torch.models.graphcast import GraphCast
  device = devices.resolve(device)
  ckpt = checkpoint_lib.load(source, configs.CheckPoint)
  model = GraphCast(ckpt.model_config, ckpt.task_config,
                    generator=torch.Generator().manual_seed(0),
                    device="cpu")
  params.load_params(model, params.params_from_jax(
      haiku_params_to_native(ckpt.params)))
  return (model.to(device), ckpt.model_config,
          ckpt.task_config, ckpt.description, ckpt.license)


def save_graphcast_checkpoint(dest: Union[str, BinaryIO], model: nn.Module,
                              model_config: configs.ModelConfig,
                              task_config: configs.TaskConfig,
                              description: str = "",
                              license: str = ""):
  """Writes a ``GraphCast``'s parameters as a reference-format bundle."""
  ckpt = configs.CheckPoint(
      params=native_params_to_haiku(params.params_to_jax(model)),
      model_config=model_config,
      task_config=task_config,
      description=description,
      license=license)
  checkpoint_lib.dump(dest, ckpt)


def load_gencast_params(model: nn.Module, haiku_params) -> nn.Module:
  """Copies flat Haiku GenCast parameters into a port ``GenCast``."""
  params.load_params(model, params.params_from_jax(
      gencast_haiku_params_to_native(haiku_params)))
  return model


def gencast_params_to_haiku(model: nn.Module) -> dict[str, Any]:
  """A port ``GenCast``'s parameters as flat Haiku GenCast parameters."""
  return native_gencast_params_to_haiku(params.params_to_jax(model))
