"""Device meshes over torch.distributed: data, ensemble, tensor and sequence
parallelism (port of graphcast_tpu/parallel/sharding.py).

The JAX package builds a ``jax.sharding.Mesh``, annotates how each array
is laid out over it and lets XLA's SPMD partitioner insert the collectives.
Here a mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of a
process group (one process per card, or ``gloo`` processes on the CPU),
with named axes: ``batch`` (data and ensemble parallelism), ``model``
(tensor parallelism) and ``sp`` (sequence parallelism of the transformer's
node axis). Each rank holds its part of each array, and the collectives
the partitioner would insert are inserted by the port (collectives.py):

- ``make_mesh`` / ``make_hybrid_mesh``: the ranks arranged over named axes;
  the hybrid form keeps the JAX package's dcn-major arrangement (device
  index along an axis = dcn_coord × ici_size + ici_coord). On GPUs "dcn"
  is the network between nodes, "ici" NVLink within a node;
- ``shard_fieldsets`` gives a rank its slice of each named dim,
  ``gather_fieldsets`` puts the whole FieldSet back on every rank;
- ``replicate`` broadcasts a module's parameters and buffers from the
  mesh's first rank;
- ``shard_params_tensor_parallel`` splits the parameters Megatron-style,
  with the JAX package's pairing rules leaf for leaf
  (``tensor_parallel_plan``), and attaches each split Linear's
  collectives.

Every rank calls every function here in the same order, as collectives
require.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from graphcast_tpu_torch.fields import Field, FieldSet
from graphcast_tpu_torch.nn import core
from graphcast_tpu_torch.params import flat_params
from graphcast_tpu_torch.parallel import collectives


def _device_type() -> str:
  """The device type of a mesh over the default group: "cuda" under nccl,
  else "cpu" (gloo; its collectives also take CUDA tensors)."""
  return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _ranks(ranks: Optional[Sequence[int]]) -> np.ndarray:
  return np.arange(dist.get_world_size()) if ranks is None else (
      np.asarray(ranks))


def make_mesh(axis_sizes: Optional[dict[str, int]] = None,
              ranks: Optional[Sequence[int]] = None) -> DeviceMesh:
  """Builds a mesh; default: every rank on one "batch" axis. ``ranks``
  (default: all of the default group's, in order) play the JAX package's
  ``devices``."""
  ranks = _ranks(ranks)
  if axis_sizes is None:
    axis_sizes = {"batch": len(ranks)}
  names = tuple(axis_sizes)
  sizes = tuple(axis_sizes.values())
  if int(np.prod(sizes)) != len(ranks):
    raise ValueError(f"mesh {axis_sizes} needs {np.prod(sizes)} devices, "
                     f"have {len(ranks)}")
  return DeviceMesh(_device_type(), torch.as_tensor(ranks.reshape(sizes)),
                    mesh_dim_names=names)


def hybrid_rank_array(axis_sizes: dict[str, int],
                      dcn_axes: Optional[dict[str, int]],
                      ranks: Sequence[int]) -> np.ndarray:
  """The ranks of ``make_hybrid_mesh`` arranged over the axes: the JAX
  package's emulation of ``mesh_utils.create_hybrid_device_mesh`` with
  contiguous rank chunks as granules (one granule per node)."""
  dcn_axes = dict(dcn_axes or {})
  if unknown := set(dcn_axes) - set(axis_sizes):
    raise ValueError(f"dcn_axes {unknown} not in axis_sizes {set(axis_sizes)}")
  names = tuple(axis_sizes)
  dcn_shape = tuple(dcn_axes.get(n, 1) for n in names)
  ici_shape = []
  for n in names:
    total, dcn = axis_sizes[n], dcn_axes.get(n, 1)
    if total % dcn:
      raise ValueError(f"axis {n}: size {total} not divisible by DCN "
                       f"factor {dcn}")
    ici_shape.append(total // dcn)
  ici_shape = tuple(ici_shape)
  n_dcn = int(np.prod(dcn_shape))
  n_ici = int(np.prod(ici_shape))
  ranks = np.asarray(ranks)
  if n_dcn * n_ici != len(ranks):
    raise ValueError(f"mesh {axis_sizes} needs {n_dcn * n_ici} devices, "
                     f"have {len(ranks)}")
  granules = [ranks[i * n_ici:(i + 1) * n_ici].reshape(ici_shape)
              for i in range(n_dcn)]
  granule_mesh = np.arange(n_dcn).reshape(dcn_shape)
  blocks = np.vectorize(lambda i: granules[i], otypes=[object])(granule_mesh)
  return np.block(blocks.tolist())


def make_hybrid_mesh(axis_sizes: dict[str, int],
                     dcn_axes: Optional[dict[str, int]] = None,
                     ranks: Optional[Sequence[int]] = None) -> DeviceMesh:
  """Multi-node mesh: per-axis ICI×DCN factors (graphcast_tpu/parallel/
  sharding.py:39-99).

  ``axis_sizes`` gives each axis's TOTAL size; ``dcn_axes`` the factor of
  it carried between nodes, the rest within a node. Only weak-scaling axes
  (data, ensemble: one gradient all-reduce per step) belong between nodes;
  keep ``model`` and ``sp`` within a node. Ranks of one node are
  contiguous (as torchrun numbers them); where ``LOCAL_WORLD_SIZE`` says
  how many a node holds, the DCN factors must multiply to the node count,
  else an axis meant for NVLink would cross nodes.
  """
  ranks = _ranks(ranks)
  arr = hybrid_rank_array(axis_sizes, dcn_axes, ranks)
  local = int(os.environ.get("LOCAL_WORLD_SIZE", "0"))
  n_dcn = int(np.prod([v for v in (dcn_axes or {}).values()]))
  if local and len(ranks) // local > 1 and len(ranks) // local != n_dcn:
    raise ValueError(
        f"ranks span {len(ranks) // local} nodes but dcn_axes {dcn_axes} "
        f"give a total DCN factor of {n_dcn}; set dcn_axes so their "
        "product equals the node count (ICI axes must not cross nodes)")
  return DeviceMesh(_device_type(), torch.as_tensor(arr),
                    mesh_dim_names=tuple(axis_sizes))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
  return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
  return mesh.get_local_rank(axis)


def fieldset_sharding(fs: FieldSet, mesh: DeviceMesh,
                      dim_to_axis: Optional[dict[str, str]] = None
                      ) -> dict[str, tuple]:
  """{variable: the mesh axis (or None) of each of its dims}: the
  PartitionSpecs of the JAX package's NamedShardings. Each named dim in
  ``dim_to_axis`` (default {"batch": "batch"}) is split over its axis;
  all else is replicated."""
  del mesh
  if dim_to_axis is None:
    dim_to_axis = {"batch": "batch"}
  return {name: tuple(dim_to_axis.get(d) for d in fs[name].dims)
          for name in fs.var_names}


def shard_fieldsets(mesh: DeviceMesh, *fieldsets: FieldSet,
                    dim_to_axis: Optional[dict[str, str]] = None):
  """Each FieldSet's slice for this rank (``fieldset_sharding``: equal
  parts along each split dim)."""
  out = []
  for fs in fieldsets:
    specs = fieldset_sharding(fs, mesh, dim_to_axis)

    def part(name, f, specs=specs):
      data = f.data
      for dim, axis in enumerate(specs[name]):
        if axis is not None:
          size = axis_size(mesh, axis)
          if data.shape[dim] % size:
            raise ValueError(f"{name}: dim {f.dims[dim]} of size "
                             f"{data.shape[dim]} does not split over "
                             f"{size} ranks of axis {axis!r}")
          data = data.chunk(size, dim)[axis_rank(mesh, axis)]
      return Field(data, f.dims)

    out.append(fs.map(part))
  return out if len(out) > 1 else out[0]


def gather_fieldsets(mesh: DeviceMesh, *fieldsets: FieldSet,
                     dim_to_axis: Optional[dict[str, str]] = None):
  """The inverse of ``shard_fieldsets``: every rank's slices put back
  together, the whole FieldSet on every rank."""
  out = []
  for fs in fieldsets:
    specs = fieldset_sharding(fs, mesh, dim_to_axis)

    def whole(name, f, specs=specs):
      data = f.data
      for dim, axis in enumerate(specs[name]):
        if axis is not None:
          data = collectives.gather(data, dim, mesh.get_group(axis))
      return Field(data, f.dims)

    out.append(fs.map(whole))
  return out if len(out) > 1 else out[0]


@torch.no_grad()
def replicate(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
  """Broadcasts every parameter and buffer of ``module`` from the mesh's
  first rank to all its ranks (in place): every replica starts equal."""
  src = int(mesh.mesh.flatten()[0])
  for t in list(module.parameters()) + list(module.buffers()):
    dist.broadcast(t.data, src=src)
  return module


COL_NAMES = ("ffw_up", "mha_proj_q", "mha_proj_k", "mha_proj_v")
ROW_NAMES = ("ffw_down", "mha_final")


def tensor_parallel_plan(shapes: Mapping[str, Sequence[int]], size: int,
                         model_axis: str = "model") -> dict[str, tuple]:
  """{flat key: spec} of the JAX package's ``shard_params_tensor_parallel``
  (sharding.py:134-206), rule for rule on the port's flat keys: within a
  dict of exactly two ``linear_*`` layers whose hidden width n (the first
  weight's columns, the second's rows) passes ``hidden_ok(n) = n % size
  == 0 and n >= 8 * size``, the first is column-parallel (w: (None,
  axis), b: (axis,)) and the second row-parallel (w: (axis, None), b
  replicated); ``ffw_up`` and ``mha_proj_{q,k,v}`` are column-parallel
  and ``ffw_down`` and ``mha_final`` row-parallel where their split width
  passes; all else is replicated, ()."""
  tree: dict = {}
  for key, shape in shapes.items():
    node = tree
    *path, leaf = key.split("/")
    for part in path:
      node = node.setdefault(part, {})
    node[leaf] = tuple(shape)

  col, row, vec, rep = (None, model_axis), (model_axis, None), (
      model_axis,), ()

  def hidden_ok(n: int) -> bool:
    return n % size == 0 and n >= size * 8

  def is_linear(v) -> bool:
    return isinstance(v, dict) and "w" in v and len(v["w"]) == 2

  def shard_linear(linear: dict, mode: str) -> dict:
    return {name: (col if mode == "col" and name == "w" else
                   vec if mode == "col" and name == "b" else
                   row if mode == "row" and name == "w" else rep)
            for name in linear}

  def assign(node: dict) -> dict:
    linears = sorted((k for k in node if k.startswith("linear_")
                      and isinstance(node[k], dict) and "w" in node[k]),
                     key=lambda s: int(s.split("_")[-1]))
    pair = None
    if len(linears) == 2:
      w0, w1 = node[linears[0]]["w"], node[linears[1]]["w"]
      if (len(w0) == 2 and len(w1) == 2 and w0[-1] == w1[0]
          and hidden_ok(w0[-1])):
        pair = tuple(linears)
    out = {}
    for k, v in node.items():
      if pair and k == pair[0]:
        out[k] = shard_linear(v, "col")
      elif pair and k == pair[1]:
        out[k] = shard_linear(v, "row")
      elif k in COL_NAMES and is_linear(v) and hidden_ok(v["w"][-1]):
        out[k] = shard_linear(v, "col")
      elif k in ROW_NAMES and is_linear(v) and hidden_ok(v["w"][0]):
        out[k] = shard_linear(v, "row")
      elif isinstance(v, dict):
        out[k] = assign(v)
      else:
        out[k] = rep
    return out

  flat = {}

  def walk(node, prefix):
    for k, v in node.items():
      key = f"{prefix}/{k}" if prefix else k
      if isinstance(v, dict):
        walk(v, key)
      else:
        flat[key] = v

  walk(assign(tree), "")
  return flat


def shard_params_tensor_parallel(module: nn.Module, mesh: DeviceMesh,
                                 model_axis: str = "model"
                                 ) -> dict[str, tuple]:
  """Splits ``module``'s parameters over the mesh's ``model_axis`` by
  ``tensor_parallel_plan`` (in place; returns the plan): each split
  Linear keeps this rank's columns or rows and runs its product with the
  collectives of collectives.LinearSharding, so every MLP's output, and
  every node table the edge gathers read, stays whole on every rank. Make
  the optimizer after this call: it replaces the split parameters."""
  size = axis_size(mesh, model_axis)
  rank = axis_rank(mesh, model_axis)
  group = mesh.get_group(model_axis)
  plan = tensor_parallel_plan(
      {k: tuple(p.shape) for k, p in flat_params(module).items()}, size,
      model_axis)
  col, row = (None, model_axis), (model_axis, None)
  with torch.no_grad():
    for name, sub in module.named_modules():
      if not isinstance(sub, core.Linear):
        continue
      spec = plan[f"{name.replace('.', '/')}/w"]
      if spec not in (col, row):
        continue
      mode = "col" if spec == col else "row"
      sub.w = nn.Parameter(
          sub.w.chunk(size, 1 if mode == "col" else 0)[rank].clone())
      if mode == "col" and sub.b is not None:
        sub.b = nn.Parameter(sub.b.chunk(size)[rank].clone())
      grad_group = sub.parallel.grad_group if sub.parallel else None
      sub.parallel = collectives.LinearSharding(mode, group, grad_group)
  return plan


def tensor_parallel_parameters(module: nn.Module) -> tuple[list, object]:
  """(the parameters of ``module`` split over a model group, that group;
  or None): what the global gradient norm sums over the group."""
  params, group = [], None
  for sub in module.modules():
    par = getattr(sub, "parallel", None)
    if isinstance(sub, core.Linear) and par is not None and par.mode in (
        "col", "row"):
      group = par.group
      params.append(sub.w)
      if par.mode == "col" and sub.b is not None:
        params.append(sub.b)
  return params, group
