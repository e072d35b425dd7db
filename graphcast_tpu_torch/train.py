"""Training step: AR loss + grads + optimizer (port of graphcast_tpu/train.py).

The parameters live in the predictor's modules (f32 masters) and the
optimizer state in ``torch.optim``; a train step is loss, ``backward`` and
one optimizer step. ``graphcast_optimizer`` equals the JAX package's optax
chain (train.py:161-174): clip by global norm 32, then AdamW (b1 0.9,
b2 0.95, eps 1e-8, weight decay 0.1 on every parameter) with a linear
warmup and cosine decay, read at the step count before the increment, so
the first step's learning rate is 0.

Over a device mesh (parallel/sharding.py), ``shard_batch`` gives each rank
its slice of the batch and ``make_train_step(..., mesh=)`` takes the JAX
step's contract (train.py:52): the loss is the mean over the whole batch.
Each rank's gradients of its slice's mean are averaged over the ``batch``
axis by bucketed all-reduces after ``backward``, before the clip, so every
rank clips the same gradient and its parameters stay bit-equal to every
other replica's. Under tensor parallelism the global norm adds the split
parameters' squares over the ``model`` axis. Not ported: the params-tree
plumbing (``TrainState``, ``partition_params``): the graph statics live on
the model here, not in the parameters.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist

from graphcast_tpu_torch.fields import FieldSet
from graphcast_tpu_torch.models.base import Predictor
from graphcast_tpu_torch.parallel import collectives
from graphcast_tpu_torch.parallel import sharding


def make_loss_fn(predictor: Predictor):
  """(inputs, targets, forcings, **kwargs) → (scalar loss, diagnostics): the
  batch mean of the predictor's per-sample loss. ``kwargs`` go to
  ``predictor.loss``: GenCast's ``generator``, the port's form of the JAX
  step's ``rng`` (train.py:110)."""
  def loss_fn(inputs: FieldSet, targets: FieldSet, forcings: FieldSet,
              **kwargs):
    loss, diagnostics = predictor.loss(inputs, targets, forcings, **kwargs)
    return loss.mean(0), {k: v.mean(0) for k, v in diagnostics.items()}
  return loss_fn


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Callable:
  """optax.warmup_cosine_decay_schedule: a linear warmup from init_value to
  peak_value over warmup_steps, then cosine decay to end_value at
  decay_steps (which includes the warmup)."""
  alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

  def schedule(count: int) -> float:
    if count < warmup_steps:
      frac = 1.0 - max(count, 0) / warmup_steps
      return (init_value - peak_value) * frac + peak_value
    t = min(count - warmup_steps, decay_steps - warmup_steps)
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / (decay_steps - warmup_steps)))
    return peak_value * ((1.0 - alpha) * cosine + alpha)

  return schedule


class ClippedAdamW:
  """optax.chain(clip_by_global_norm(clip_norm), adamw(schedule, ...)) on
  torch parameters: ``step`` clips the gradients by their global norm, sets
  the learning rate to schedule(count) and runs ``torch.optim.AdamW``.
  Parameters without a gradient take a zero one, as optax updates every
  leaf of the tree (weight decay included)."""

  def __init__(self, params: Iterable[torch.nn.Parameter],
               schedule: Callable[[int], float], b1: float, b2: float,
               eps: float, weight_decay: float, clip_norm: float):
    self.params = list(params)
    self.schedule = schedule
    self.clip_norm = clip_norm
    self.count = 0
    self.adamw = torch.optim.AdamW(self.params, lr=0.0, betas=(b1, b2),
                                   eps=eps, weight_decay=weight_decay)

  def zero_grad(self):
    self.adamw.zero_grad(set_to_none=True)

  def fill_grads(self):
    """Gives every parameter without a gradient a zero one."""
    for p in self.params:
      if p.grad is None:
        p.grad = torch.zeros_like(p)

  @torch.no_grad()
  def step(self, total_norm: Optional[torch.Tensor] = None):
    """``total_norm``: the gradients' global norm where this rank holds
    only part of them (tensor parallelism); else it is computed here."""
    self.fill_grads()
    if total_norm is None:
      torch.nn.utils.clip_grad_norm_(self.params, self.clip_norm)
    else:  # clip_grad_norm_'s rule on the given norm
      coef = torch.clamp(self.clip_norm / (total_norm + 1e-6), max=1.0)
      torch._foreach_mul_([p.grad for p in self.params], coef)
    for group in self.adamw.param_groups:
      group["lr"] = self.schedule(self.count)
    self.adamw.step()
    self.count += 1


def graphcast_optimizer(params: Iterable[torch.nn.Parameter],
                        peak_lr: float = 1e-3, warmup_steps: int = 1_000,
                        total_steps: int = 300_000, weight_decay: float = 0.1,
                        clip_norm: float = 32.0) -> ClippedAdamW:
  """The GraphCast paper's schedule: linear warmup, cosine decay, AdamW,
  global-norm clipping."""
  schedule = warmup_cosine_decay_schedule(
      init_value=0.0, peak_value=peak_lr, warmup_steps=warmup_steps,
      decay_steps=total_steps)
  return ClippedAdamW(params, schedule, b1=0.9, b2=0.95, eps=1e-8,
                      weight_decay=weight_decay, clip_norm=clip_norm)


def shard_batch(mesh, *fieldsets: FieldSet):
  """Each FieldSet's slice of the batch for this rank (graphcast_tpu/
  train.py:131): the batch dim split over the mesh's "batch" axis."""
  return sharding.shard_fieldsets(mesh, *fieldsets)


def global_grad_norm(params, tp_params, model_group) -> torch.Tensor:
  """The global norm of the gradients of ``params``, where those in
  ``tp_params`` are this rank's parts of tensors split over
  ``model_group``."""
  tp_ids = {id(p) for p in tp_params}
  sq = [torch.zeros((), device=params[0].grad.device) for _ in range(2)]
  for p in params:
    sq[id(p) in tp_ids] += p.grad.float().square().sum()
  dist.all_reduce(sq[1], group=model_group)
  return torch.sqrt(sq[0] + sq[1])


def make_train_step(predictor: Predictor, optimizer: ClippedAdamW,
                    mesh=None):
  """Returns train_step(inputs, targets, forcings, **kwargs) → (loss,
  diagnostics), detached; the step updates the predictor's parameters in
  place. ``kwargs`` go to the loss (``make_loss_fn``).

  With a ``mesh`` (module doc), each rank passes its slice of the batch
  (``shard_batch``); the returned loss and diagnostics are the whole
  batch's means, the same on every rank. Make the optimizer after
  ``sharding.shard_params_tensor_parallel``."""
  loss_fn = make_loss_fn(predictor)
  batch_group = None
  if mesh is not None and "batch" in mesh.mesh_dim_names and (
      sharding.axis_size(mesh, "batch") > 1):
    batch_group = mesh.get_group("batch")
  tp_params, model_group = sharding.tensor_parallel_parameters(predictor)

  def mean_over_batch(x):
    x = x.detach().clone()
    dist.all_reduce(x, group=batch_group)
    return x / collectives.group_size(batch_group)

  def train_step(inputs: FieldSet, targets: FieldSet, forcings: FieldSet,
                 **kwargs):
    optimizer.zero_grad()
    loss, diagnostics = loss_fn(inputs, targets, forcings, **kwargs)
    loss.backward()
    total_norm = None
    if batch_group is not None:
      optimizer.fill_grads()
      collectives.all_reduce_mean_([p.grad for p in optimizer.params],
                                   batch_group)
      loss = mean_over_batch(loss)
      diagnostics = {k: mean_over_batch(v) for k, v in diagnostics.items()}
    if tp_params:
      optimizer.fill_grads()
      total_norm = global_grad_norm(optimizer.params, tp_params, model_group)
    optimizer.step(total_norm)
    return loss.detach(), {k: v.detach() for k, v in diagnostics.items()}

  return train_step


def autoregressive_curriculum(total_steps: int = 300_000,
                              fine_tune_steps: int = 11_000,
                              max_ar_steps: int = 12):
  """The GraphCast paper's AR training curriculum: step → number of AR
  steps. 1-step targets first; then 2 up to ``max_ar_steps``, one more
  every ``fine_tune_steps / (max_ar_steps - 1)`` steps."""
  ramp = fine_tune_steps / max(max_ar_steps - 1, 1)

  def num_ar_steps(step: int) -> int:
    if step < total_steps - fine_tune_steps:
      return 1
    into = step - (total_steps - fine_tune_steps)
    return min(2 + int(into / ramp), max_ar_steps)

  return num_ar_steps
