"""The training entry: ``train.make_train_step`` over ``Autoregressive(
InputsAndResiduals(Bfloat16Cast(GraphCast)), gradient_checkpointing=True)``
with ``train.graphcast_optimizer``, at batch ``batch`` and AR-1, a fresh
batch drawn on the device from the seed for every step (``data_dtype``).

Set-up builds the one step object and drives it through its first
``checked_steps`` steps, on batches 1, 2, 3, keeping the first step's
gradient as the optimizer holds it (its first moment over 1 - b1) and the
parameters after the last; the window then runs steps 4, 5, ... of the
same object. End-to-end: ``train_step_s``, the window's seconds to the end
of its last whole step over its steps.

Comparison: the reference follows the same first steps from the same
weights and batches in float32 (loss, autograd, global-norm clip, AdamW at
the schedule's rates). ``loss_err``: the worst step's |program - reference|
/ |reference| loss; ``grad_err``: over the leaves, the gap between the
program's and the reference's first-gradient norms over the larger of the
reference leaf's norm and the median leaf's; ``change_err``: the same for
the parameters' change over the checked steps, leaving out the leaves
whose reference first gradient is under a thousandth of the median
leaf's (they move by weight decay and round-off alone); ``descent_err``:
over the same leaves, |1 - <program's change, m> / <reference's change,
m>|, m the reference's first moment after the checked steps. A norm is
blind to the update's direction (early in the warm-up AdamW moves each
weight by about lr times the sign of its moment, whatever the gradient's
size); the projection on the moment reads an update of the wrong sign as
2, and leaves the round-off of the small moments' signs out.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import data
from portbench.entries import common
from portbench.reference import graphcast as ref

TRACE = 10**6   # batch indices of the traced steps start here


def schedule(opt: dict, count: int) -> float:
  """A linear warm-up from 0 to ``peak_lr`` over ``warmup_steps``, then a
  cosine decay to 0 at ``total_steps``."""
  if count < opt["warmup_steps"]:
    return opt["peak_lr"] * count / opt["warmup_steps"]
  t = min(count - opt["warmup_steps"],
          opt["total_steps"] - opt["warmup_steps"])
  return opt["peak_lr"] * 0.5 * (1.0 + math.cos(
      math.pi * t / (opt["total_steps"] - opt["warmup_steps"])))


class Entry:

  def __init__(self, cfg, traffic, seed, device):
    self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
    self.batch = traffic["batch"]
    self.opt = traffic["optimizer"]
    self.dtype = getattr(torch, traffic["data_dtype"])
    self.attempted = 0
    self.phases = []   # (name, host clock) of set-up's stages
    self.graph = None
    self.exact = None   # the float32 reference's run, once computed

  def _batch(self, i: int):
    cfg = self.cfg
    gen = data.generator(self.seed, "batch", i, device=self.device)
    dynamic = [n for n in cfg["input_variables"]
               if n not in cfg["static_variables"]]
    inputs = data.make_fields(cfg, dynamic, self.batch,
                              ref.input_frames(cfg), gen, self.device,
                              self.dtype)
    targets = data.make_fields(cfg, cfg["target_variables"], self.batch, 1,
                               gen, self.device, self.dtype)
    forcings = data.make_fields(cfg, cfg["forcing_variables"], self.batch, 1,
                                gen, self.device, self.dtype)
    return {**inputs, **self.statics}, targets, forcings

  def _step(self, i: int):
    cfg, h = self.cfg, self.cfg["step_hours"]
    inputs, targets, forcings = self._batch(i)
    return self.step(
        self.program.fieldset(cfg, inputs, h, 1 - ref.input_frames(cfg)),
        self.program.fieldset(cfg, targets, h, 1),
        self.program.fieldset(cfg, forcings, h, 1))[0]

  def setup(self):
    from graphcast_tpu_torch import train
    from portbench import program
    cfg, opt = self.cfg, self.opt
    self.program = program
    self.stats = data.make_stats(cfg, self.seed, self.device)
    self.statics = data.make_fields(
        cfg, cfg["static_variables"], self.batch, 1,
        data.generator(self.seed, "statics", device=self.device), self.device,
        self.dtype)
    self.model, stack = program.graphcast_stack(
        cfg, data.make_weights(ref.param_shapes(cfg), self.seed, self.device),
        self.stats, self.device, gradient_checkpointing=True)
    self.optimizer = train.graphcast_optimizer(
        self.model.parameters(), peak_lr=opt["peak_lr"],
        warmup_steps=opt["warmup_steps"], total_steps=opt["total_steps"],
        weight_decay=opt["weight_decay"], clip_norm=opt["clip_norm"])
    self.step = train.make_train_step(stack, self.optimizer)
    self.phases.append(("model", time.perf_counter()))
    params = dict(self.model.named_parameters())
    self.losses = []
    for i in range(1, self.traffic["checked_steps"] + 1):
      self.losses.append(float(self._step(i)))
      self.phases.append((f"step {i}", time.perf_counter()))
      if i == 1:
        state = self.optimizer.adamw.state   # no state: no gradient taken
        self.first_grad = {
            n: state[p]["exp_avg"].detach() / (1 - opt["b1"])
            if "exp_avg" in state.get(p, {}) else torch.zeros_like(p)
            for n, p in params.items()}
    self.after = {n: p.detach().clone() for n, p in params.items()}
    common.synchronize(self.device)

  def window(self, seconds: float) -> dict:
    common.synchronize(self.device)
    t0 = time.perf_counter()
    i = self.traffic["checked_steps"] + 1
    while True:
      self._step(i)
      self.attempted += 1
      i += 1
      if time.perf_counter() - t0 >= seconds:
        break
    common.synchronize(self.device)
    return {"train_step_s": (time.perf_counter() - t0) / self.attempted}

  def traced(self) -> int:
    n = self.traffic["trace_steps"]
    for j in range(n):
      self._step(TRACE + j)
    common.synchronize(self.device)
    return n

  def release(self):
    del self.model, self.step, self.optimizer
    if self.device.type == "cuda":
      torch.cuda.empty_cache()

  def _reference(self, precision: str):
    """(losses, first clipped gradient, parameters after the checked
    steps, initial weights) of the reference at ``precision``."""
    cfg, opt = self.cfg, self.opt
    q = ref.quantizer(precision)
    if self.graph is None:
      self.graph = ref.DeviceGraph(cfg, self.device)
    w0 = data.make_weights(ref.param_shapes(cfg), self.seed, self.device)
    params = {n: w.clone().requires_grad_() for n, w in w0.items()}
    m = {n: torch.zeros_like(w) for n, w in w0.items()}
    v = {n: torch.zeros_like(w) for n, w in w0.items()}
    losses, first = [], None
    with ref.no_tf32():
      for i in range(1, self.traffic["checked_steps"] + 1):
        loss = ref.loss(cfg, params, self.graph, self.stats,
                        *self._batch(i), q, grad=True)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        g = {n: torch.zeros_like(params[n]) if d is None else d
             for n, d in zip(names, grads)}
        losses.append(float(loss.detach()))
        total = torch.sqrt(sum(t.double().square().sum() for t in g.values()))
        coef = min(1.0, opt["clip_norm"] / (float(total) + 1e-6))
        g = {n: t * coef for n, t in g.items()}
        if first is None:
          first = g
        lr = schedule(opt, i - 1)
        with torch.no_grad():
          for n, p in params.items():
            p.mul_(1 - lr * opt["weight_decay"])
            m[n].mul_(opt["b1"]).add_(g[n], alpha=1 - opt["b1"])
            v[n].mul_(opt["b2"]).addcmul_(g[n], g[n], value=1 - opt["b2"])
            bc1, bc2 = 1 - opt["b1"] ** i, 1 - opt["b2"] ** i
            denom = (v[n].sqrt() / math.sqrt(bc2)).add_(opt["eps"])
            p.addcdiv_(m[n], denom, value=-lr / bc1)
    return (losses, first, {n: p.detach() for n, p in params.items()}, w0,
            m)

  @staticmethod
  def _readings(losses, first, after, ref_run) -> dict:
    ref_losses, ref_first, ref_after, w0, ref_m = ref_run
    norms = {n: float(t.norm()) for n, t in ref_first.items()}
    median = float(np.median(list(norms.values())))
    moved = {n for n, x in norms.items() if x >= 1e-3 * median}
    change = {n: after[n] - w0[n] for n in w0}
    ref_change = {n: ref_after[n] - w0[n] for n in w0}
    return {
        "loss_err": max(abs(a - b) / abs(b)
                        for a, b in zip(losses, ref_losses)),
        "grad_err": common.worst_leaf_gap(first, ref_first),
        "change_err": common.worst_leaf_gap(change, ref_change, moved),
        "descent_err": max(
            abs(1 - common.dot(change[n], ref_m[n])
                / common.dot(ref_change[n], ref_m[n])) for n in moved)}

  def check(self) -> dict:
    return self._readings(self.losses, self.first_grad, self.after,
                          self._exact())

  def control(self, precision: str) -> dict:
    """The same readings with the reference at ``precision`` in the
    program's place."""
    losses, first, after = self._reference(precision)[:3]
    return self._readings(losses, first, after, self._exact())

  def _exact(self):
    if self.exact is None:
      self.exact = self._reference("float32")
    return self.exact

  def sizes(self) -> dict:
    g = self.graph
    return {"num_grid": g.num_grid, "num_mesh": g.num_mesh,
            **{k: int(v[0].shape[0]) for k, v in g.edges.items()},
            "batch": self.batch}
