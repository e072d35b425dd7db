"""Entry points: a one-step GraphCast forward and the multi-process dry run
(the twins of the repository root's ``__graft_entry__.entry`` and
``dryrun_multichip``).

``dryrun_multichip(n)`` runs one FULL training step of a tiny GraphCast in
``n`` ranks, ``gloo`` processes on the CPU (the JAX package's dry run
forces its CPU platform too; the tiny widths are below what the card's
kernels take), on a mesh that factors ``n`` as the JAX package's does: ``sp = 2`` when n is even and at least 8; then ``tp``
the first of (4, 2, 3) that leaves a data axis of at least 2; ``dp`` the
rest; a global batch of dp × 2. Data parallelism over "batch", tensor
parallelism of the MLP weights over "model" and, with ``sp > 1``, the
GenCast denoiser's loss and gradients through sequence-parallel splash
attention over "sp". Rank 0 prints one line:

  dryrun_multichip(8): train step OK on mesh (batch=2, model=2, sp=2),
  loss=…, sp=2 denoiser loss+grads OK
"""

from __future__ import annotations

import math

import torch

from graphcast_tpu_torch import devices


def _build_predictor(model_config, task_config, device):
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models.graphcast import GraphCast
  from graphcast_tpu_torch.wrappers import (
      Autoregressive, Bfloat16Cast, InputsAndResiduals)
  stddev, mean, diffs = synthetic.make_norm_stats(task_config, device=device)
  return Autoregressive(
      InputsAndResiduals(
          Bfloat16Cast(GraphCast(model_config, task_config,
                                 generator=torch.Generator().manual_seed(0),
                                 device=device)),
          stddev_by_level=stddev, mean_by_level=mean,
          diffs_stddev_by_level=diffs),
      gradient_checkpointing=True)


def entry(device: torch.device | str = devices.DEFAULT_DEVICE):
  """Returns (fn, example_args): a GraphCast forward step at 4°, mesh-3,
  latent 128, 4 message-passing steps; fn(inputs, targets_template,
  forcings) returns the prediction. Runs on the card unless ``device``
  says otherwise."""
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import configs

  device = devices.resolve(device)
  task = configs.TASK_13
  model = configs.ModelConfig(
      resolution=4.0, mesh_size=3, latent_size=128, gnn_msg_steps=4,
      hidden_layers=1, radius_query_fraction_edge_length=0.6)
  predictor = _build_predictor(model, task, device)
  inputs, targets, forcings = synthetic.make_example_batch(
      task, resolution=4.0, batch=1, num_target_times=1, device=device)

  def fn(inputs, targets_template, forcings):
    return predictor(inputs, targets_template, forcings)

  return fn, (inputs, targets, forcings)


def mesh_axes(n_devices: int) -> dict[str, int]:
  """The dry run's factoring of ``n_devices`` (module doc)."""
  sp = 2 if n_devices % 2 == 0 and n_devices >= 8 else 1
  rem = n_devices // sp
  tp = 1
  for cand in (4, 2, 3):
    if rem % cand == 0 and rem // cand >= 2:
      tp = cand
      break
  axes = {"batch": rem // tp, "model": tp}
  if sp > 1:
    axes["sp"] = sp
  return axes


def _dryrun_rank(rank: int, n_devices: int):
  """One rank of ``dryrun_multichip``."""
  device = "cpu"
  from graphcast_tpu_torch import train
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import configs
  from graphcast_tpu_torch.parallel import sharding

  task = configs.TaskConfig(
      input_variables=(
          "2m_temperature", "temperature", "toa_incident_solar_radiation",
          "land_sea_mask"),
      target_variables=("2m_temperature", "temperature"),
      forcing_variables=("toa_incident_solar_radiation",),
      pressure_levels=(500, 850),
      input_duration="12h")
  model = configs.ModelConfig(
      resolution=20.0, mesh_size=1, latent_size=32, gnn_msg_steps=2,
      hidden_layers=1, radius_query_fraction_edge_length=0.6)
  predictor = _build_predictor(model, task, device)

  axes = mesh_axes(n_devices)
  dp, tp, sp = axes["batch"], axes["model"], axes.get("sp", 1)
  inputs, targets, forcings = synthetic.make_example_batch(
      task, resolution=20.0, batch=dp * 2, num_target_times=2,
      device=device)
  mesh = sharding.make_mesh(axes)
  inputs, targets, forcings = train.shard_batch(mesh, inputs, targets,
                                                forcings)
  # Replicas start equal; then the latent MLP weights split over "model";
  # the optimizer is made on the split parameters.
  sharding.replicate(predictor, mesh)
  sharding.shard_params_tensor_parallel(predictor, mesh)
  optimizer = train.graphcast_optimizer(predictor.parameters(),
                                        total_steps=100, warmup_steps=10)
  step = train.make_train_step(predictor, optimizer, mesh)
  loss, _ = step(inputs, targets, forcings)
  loss = float(loss)
  if not math.isfinite(loss):
    raise AssertionError(f"non-finite loss {loss}")

  sp_msg = ""
  if sp > 1:
    # The model's sequence is the mesh-node axis: the GenCast denoiser's
    # transformer with its node axis split over "sp"; diffusion loss and
    # gradients through the sharded splash attention.
    from graphcast_tpu_torch.models import denoiser, gencast
    from graphcast_tpu_torch.models.sparse_transformer import (
        SparseTransformerConfig)
    gc_task = configs.TaskConfig(
        input_variables=("2m_temperature", "temperature",
                         "day_progress_sin", "land_sea_mask"),
        target_variables=("2m_temperature", "temperature"),
        forcing_variables=("day_progress_sin",),
        pressure_levels=(500, 850),
        input_duration="24h")
    gc = gencast.GenCast(
        task_config=gc_task,
        denoiser_architecture_config=denoiser.DenoiserArchitectureConfig(
            sparse_transformer_config=SparseTransformerConfig(
                attention_k_hop=2, d_model=16, num_layers=2, num_heads=2,
                attention_type="splash_mha", ffw_hidden=32, block_q=32),
            mesh_size=1, latent_size=16, hidden_layers=1),
        sampler_config=gencast.SamplerConfig(num_noise_levels=3),
        noise_config=gencast.NoiseConfig(),
        noise_encoder_config=denoiser.NoiseEncoderConfig(
            num_frequencies=8, output_sizes=(16, 8)),
        sequence_parallel=(mesh, "sp"),
        generator=torch.Generator().manual_seed(1), device=device)
    gi, gt, gf = synthetic.make_example_batch(
        gc_task, resolution=20.0, batch=1, num_target_times=1,
        time_step_hours=12, device=device)
    gloss, _ = gc.loss(gi, gt, gf, generator=torch.Generator(
        device=device).manual_seed(2))
    gloss.mean().backward()
    # (The decoder's mesh-node MLP is unused, so it takes no gradient.)
    grads = [p.grad for p in gc.parameters() if p.grad is not None]
    if not math.isfinite(float(gloss.mean().detach())) or not all(
        torch.isfinite(g).all() for g in grads):
      raise AssertionError("non-finite denoiser loss or gradients")
    sp_msg = f", sp={sp} denoiser loss+grads OK"

  if rank == 0:
    print(f"dryrun_multichip({n_devices}): train step OK on mesh "
          f"(batch={dp}, model={tp}{', sp=%d' % sp if sp > 1 else ''}), "
          f"loss={loss:.4f}{sp_msg}", flush=True)


def dryrun_multichip(n_devices: int, init_method: str | None = None) -> None:
  """Runs the dry run (module doc) in ``n_devices`` gloo processes on the
  CPU. ``init_method``: the group's address (default tcp://localhost:<free
  port>)."""
  from graphcast_tpu_torch.parallel import launch
  launch.spawn(_dryrun_rank, n_devices, args=(n_devices,), device="cpu",
               init_method=init_method)
