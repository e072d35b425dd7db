"""Rank functions of the port's multi-process tests (test_torch_parallel.py,
test_torch_splash.py), run by graphcast_tpu_torch.parallel.launch.spawn as
gloo processes on the CPU.

They import no jax: the test process computes the JAX side and hands the
weights and data over through .npz files in ``out_dir``, where each rank
writes what it computed. The configurations here are those of the tests'
JAX models.
"""

import os

import numpy as np
import scipy.sparse as sp
import torch

from graphcast_tpu_torch import params, rollout, train
from graphcast_tpu_torch.data import synthetic
from graphcast_tpu_torch.diffusion import noise
from graphcast_tpu_torch.fields import Field, FieldSet
from graphcast_tpu_torch.models import configs, denoiser, gencast
from graphcast_tpu_torch.models.graphcast import GraphCast
from graphcast_tpu_torch.models.sparse_transformer import (
    SparseTransformerConfig)
from graphcast_tpu_torch.ops import splash
from graphcast_tpu_torch.parallel import collectives, sharding
from graphcast_tpu_torch.wrappers import (
    Autoregressive, Bfloat16Cast, InputsAndResiduals, NaNCleaner)

GC_TASK = dict(
    input_variables=("2m_temperature", "temperature",
                     "toa_incident_solar_radiation", "land_sea_mask"),
    target_variables=("2m_temperature", "temperature"),
    forcing_variables=("toa_incident_solar_radiation",),
    pressure_levels=(500, 850),
    input_duration="12h")
GC_MODEL = dict(resolution=30.0, mesh_size=1, latent_size=32,
                gnn_msg_steps=2, hidden_layers=1)
GEN_TASK = dict(
    input_variables=("2m_temperature", "temperature",
                     "sea_surface_temperature", "day_progress_sin",
                     "land_sea_mask"),
    target_variables=("2m_temperature", "temperature",
                      "sea_surface_temperature"),
    forcing_variables=("day_progress_sin",),
    pressure_levels=(500, 850),
    input_duration="24h")
NOISE_LEVELS = 3
ENSEMBLE_SEED = 11
ENSEMBLE_STEPS = 2  # chunks of one 12 h step: the carry crosses a chunk
OPTIMIZER = dict(peak_lr=1e-4, warmup_steps=1, total_steps=10)


def save(out_dir, name, **arrays):
  np.savez(os.path.join(out_dir, f"{name}.npz"), **arrays)


def load(out_dir, name) -> dict:
  with np.load(os.path.join(out_dir, f"{name}.npz")) as f:
    return {k: f[k] for k in f.files}


def _numpy(tensors: dict) -> dict:
  return {k: t.detach().float().numpy() for k, t in tensors.items()}


# ----- GraphCast: data and tensor parallelism -----

def graphcast_stack(out_dir):
  """(model, f32 AR-1 stack) on the test's weights (weights.npz)."""
  task = configs.TaskConfig(**GC_TASK)
  model = GraphCast(configs.ModelConfig(**GC_MODEL), task,
                    generator=torch.Generator().manual_seed(0), device="cpu")
  params.load_params(model, load(out_dir, "weights"))
  stats = synthetic.make_norm_stats(task, device="cpu")
  return model, Autoregressive(InputsAndResiduals(
      Bfloat16Cast(model, enabled=False), stddev_by_level=stats[0],
      mean_by_level=stats[1], diffs_stddev_by_level=stats[2]))


def graphcast_data(batch):
  return synthetic.make_example_batch(configs.TaskConfig(**GC_TASK), 30.0,
                                      batch=batch, num_target_times=1,
                                      device="cpu")


def dp_train(rank, out_dir, batch):
  """Two data-parallel train steps over {"batch": world}: losses and
  parameters."""
  mesh = sharding.make_mesh()
  model, stack = graphcast_stack(out_dir)
  local = train.shard_batch(mesh, *graphcast_data(batch))
  step = train.make_train_step(
      stack, train.graphcast_optimizer(model.parameters(), **OPTIMIZER),
      mesh)
  losses = [float(step(*local)[0]) for _ in range(2)]
  save(out_dir, f"dp{rank}", losses=np.array(losses),
       **_numpy(params.flat_params(model)))


def tensor_parallel(rank, out_dir, axes, batch):
  """The forward, loss and gradients with the weights split over "model"
  and the batch over "batch": this rank's prediction slice, the loss, and
  its parameter (shard) gradients averaged over "batch"."""
  mesh = sharding.make_mesh(axes)
  model, stack = graphcast_stack(out_dir)
  local = train.shard_batch(mesh, *graphcast_data(batch))
  sharding.shard_params_tensor_parallel(stack, mesh)
  with torch.no_grad():
    pred = stack(local[0], local[1], local[2])
  loss = stack.loss(*local)[0].mean()
  loss.backward()
  for p in model.parameters():
    if p.grad is None:
      p.grad = torch.zeros_like(p)
  grads = [p.grad for p in model.parameters()]
  if axes["batch"] > 1:
    collectives.all_reduce_mean_(grads, mesh.get_group("batch"))
    loss = loss.detach().clone()
    torch.distributed.all_reduce(loss, group=mesh.get_group("batch"))
    loss /= axes["batch"]
  save(out_dir, f"tp{rank}", loss=np.array(float(loss)),
       **{f"pred/{n}": pred.data(n).numpy() for n in pred.var_names},
       **{f"grad/{k}": p.grad.numpy()
          for k, p in params.flat_params(model).items()})


# ----- GenCast: ensemble and sequence parallelism -----

def gencast_model(attention_type, mesh_size, sequence_parallel=None):
  st = SparseTransformerConfig(
      attention_k_hop=2, d_model=16, num_layers=2, num_heads=2,
      attention_type=attention_type, ffw_hidden=32, block_q=64)
  return gencast.GenCast(
      configs.TaskConfig(**GEN_TASK),
      denoiser.DenoiserArchitectureConfig(
          sparse_transformer_config=st, mesh_size=mesh_size, latent_size=16,
          hidden_layers=1),
      gencast.SamplerConfig(num_noise_levels=NOISE_LEVELS),
      gencast.NoiseConfig(),
      denoiser.NoiseEncoderConfig(num_frequencies=8, output_sizes=(16, 8)),
      sequence_parallel=sequence_parallel,
      generator=torch.Generator().manual_seed(0), device="cpu")


def gencast_stack(model):
  stats = synthetic.make_norm_stats(configs.TaskConfig(**GEN_TASK),
                                    device="cpu")
  return NaNCleaner(InputsAndResiduals(model, *stats),
                    var_to_clean="sea_surface_temperature", fill_value=0.0)


def gencast_data(batch=1, num_target_times=1):
  return synthetic.make_example_batch(configs.TaskConfig(**GEN_TASK), 30.0,
                                      batch=batch,
                                      num_target_times=num_target_times,
                                      time_step_hours=12, device="cpu")


def member_noise(shapes: dict, level: int, kind: str, member: int) -> dict:
  """One member's numpy noise draw for (noise level, "init" or "churn"),
  {variable: array of the member's shape}: what both packages' samplers
  take in the tests in place of their generators' draws."""
  rng = np.random.RandomState(
      (level * 2 + (kind == "churn")) * 1000 + member)
  return {n: rng.randn(*shape).astype(np.float32)
          for n, shape in sorted(shapes.items())}


def port_noise_keys():
  """The sampler's draws in order: the initial noise, then a churn where
  the level's churn rate is positive (diffusion/samplers.py)."""
  levels = noise.noise_schedule(80.0, 0.03, NOISE_LEVELS, 7.0)
  rates = noise.stochastic_churn_rate_schedule(levels, 2.5, 0.75, np.inf)
  return [(0, "init")] + [(i, "churn") for i in range(NOISE_LEVELS)
                          if rates[i] > 0]


def install_member_noise(num_members):
  """Replaces the port's noise draws by ``member_noise``, each member's
  taken by its index, found from its generator's seed
  (rollout.member_generators of a generator seeded with ENSEMBLE_SEED)."""
  seeds = {g.initial_seed(): m for m, g in enumerate(
      rollout.member_generators(torch.Generator().manual_seed(ENSEMBLE_SEED),
                                range(num_members)))}
  keys, calls = port_noise_keys(), []

  def fake(generator, template, basis):
    del basis
    key = keys[len(calls)]
    calls.append(key)
    members = [seeds[g.initial_seed()] for g in generator]
    shapes = {n: template[n].shape[1:] for n in template.var_names}
    draws = [member_noise(shapes, *key, m) for m in members]
    return FieldSet({n: Field(torch.from_numpy(np.stack(
        [d[n] for d in draws])).to(template[n].dtype), template[n].dims)
                     for n in template.var_names}, coords=template.coords)

  noise.spherical_white_noise_like = fake
  return calls


def ensemble(rank, out_dir, members):
  """The members split over {"batch": world}, ENSEMBLE_STEPS chunks; rank
  0 also runs them all in one process."""
  mesh = sharding.make_mesh()
  calls = install_member_noise(members)
  model = gencast_model("mha", 1)
  params.load_params(model, load(out_dir, "weights"))
  stack = gencast_stack(model)
  inputs, targets, forcings = gencast_data(num_target_times=ENSEMBLE_STEPS)

  def predictor(**kwargs):  # each chunk samples from the first key on
    calls.clear()
    return stack(**kwargs)

  def run(m):
    return rollout.chunked_ensemble_prediction(
        predictor, torch.Generator().manual_seed(ENSEMBLE_SEED), inputs,
        targets, forcings, num_samples=members, mesh=m)

  out = {f"sharded/{n}": v.numpy() for n, v in
         ((n, run(mesh).data(n)) for n in targets.var_names)}
  if rank == 0:
    whole = run(None)
    out.update({f"whole/{n}": whole.data(n).numpy()
                for n in targets.var_names})
  save(out_dir, f"ens{rank}", **out)


def sp_gencast(rank, out_dir, mesh_size):
  """GenCast's loss and every gradient with the transformer split over
  {"sp": world}, on the test's σ and noise (draws.npz)."""
  mesh = sharding.make_mesh({"sp": torch.distributed.get_world_size()})
  fixed = load(out_dir, "draws")
  sigma = fixed.pop("sigma")
  noise.rho_inverse_cdf = lambda **kw: torch.from_numpy(sigma).to(kw["cdf"])

  def noise_like(generator, template, basis):
    del generator, basis
    return FieldSet({n: Field(torch.from_numpy(fixed[n]).to(
        template[n].dtype), template[n].dims) for n in template.var_names},
                    coords=template.coords)

  noise.spherical_white_noise_like = noise_like
  model = gencast_model("splash_mha", mesh_size,
                        sequence_parallel=(mesh, "sp"))
  params.load_params(model, load(out_dir, "weights"))
  inputs, targets, forcings = gencast_data()
  for fs in (inputs, targets):
    fs.data("sea_surface_temperature")[..., :2] = float("nan")
  loss, _ = gencast_stack(model).loss(inputs, targets, forcings,
                                      generator=torch.Generator())
  loss.mean().backward()
  save(out_dir, f"sp{rank}", loss=np.array(float(loss.mean())),
       **{k: (np.zeros(tuple(p.shape), np.float32) if p.grad is None
              else p.grad.numpy())
          for k, p in params.flat_params(model).items()})


# ----- sequence-parallel attention -----

def sp_attention(rank, out_dir):
  """``splash.SequenceParallelAttention`` over the world, q, k and v
  split by rows as the transformer splits them: the gathered output and
  the gradients of sum((o - target)²) in q, k and v."""
  case = load(out_dir, "attention")
  mask = sp.csr_matrix(case["mask"])
  group = torch.distributed.group.WORLD
  attn = splash.SequenceParallelAttention(splash.build_block_map(mask),
                                          group)
  q, k, v = (torch.from_numpy(case[n]).requires_grad_() for n in "qkv")
  o_local, _ = attn(*(attn.split(t) for t in (q, k, v)), float(case["scale"]))
  o = attn.gather(o_local, False)
  loss = ((o - torch.from_numpy(case["target"])) ** 2).sum()
  loss.backward()
  save(out_dir, f"attn{rank}", o=o.detach().numpy(), dq=q.grad.numpy(),
       dk=k.grad.numpy(), dv=v.grad.numpy(),
       o_local=o_local.detach().numpy(), rows=np.array(attn.rows))
