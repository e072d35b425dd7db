"""The ensemble entry: ``members``-member GenCast forecasts of
``steps_per_forecast`` 12 h steps back to back, a closed loop, each from a
fresh initial state drawn on the device from the seed, with the members as
the batch axis: ``rollout.chunked_ensemble_prediction``'s own path (the
initial state tiled over the members by ``rollout.tile_batch``, one
generator a member from ``rollout.member_generators``, then ``rollout.
chunked_prediction_generator``, one step a chunk, the predictions left on
the device) over ``InputsAndResiduals(GenCast)``, so that the window can
stop after any whole step.

End-to-end: ``member_step_s``, the window's seconds to the end of its last
whole ensemble step over (members × steps). Comparison: for the window's
first step and a sample of ``sample`` others, one member each (drawn from
the seed, from the two halves of the batch in turn), the reference's 12 h sample from the same input window (the
initial state, or that member's own earlier predictions and the drawn
forcings) and the same noise, that member's generator replayed; the
program's prediction in the sampler's normalised space against the
reference's; ``sample_err`` is the worst variable's rms(program -
reference) / rms(reference).
"""

from __future__ import annotations

import time

import torch

from portbench import data
from portbench.entries import common
from portbench.reference import gencast as ref

WARMUP, TRACE = -1, -2   # forecast indices of the warm-up and traced steps


class Entry:

  def __init__(self, cfg, traffic, seed, device):
    self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
    self.members = traffic["members"]
    self.steps = traffic["steps_per_forecast"]
    self.dtype = getattr(torch, traffic["data_dtype"])
    self.attempted = 0
    self.phases = []   # (name, host clock) of set-up's stages
    self.sample = common.Sample(seed, traffic["sample"])
    self.graph = None
    self.expected = {}   # (forecast, step, member) → the float32 sample
    self.detail = {}     # (candidate, variable, forecast, step) → reading

  def setup(self):
    from portbench import program
    cfg = self.cfg
    self.program = program
    self.stats = data.make_stats(cfg, self.seed, self.device)
    self.model, self.stack = program.gencast_stack(
        cfg, data.make_weights(ref.param_shapes(cfg), self.seed, self.device),
        self.stats, self.device)
    self.phases.append(("model", time.perf_counter()))
    self.statics = data.make_fields(
        cfg, cfg["static_variables"], 1, 1,
        data.generator(self.seed, "statics", device=self.device), self.device,
        self.dtype)
    template = {n: torch.zeros(t.shape, dtype=self.dtype, device=self.device
                               ).expand(self.members, self.steps,
                                        *t.shape[2:])
                for n, t in data.make_fields(
                    cfg, cfg["target_variables"], 1, 1,
                    data.generator(self.seed, "template", device=self.device),
                    self.device).items()}
    self.template = program.fieldset(cfg, template, cfg["step_hours"], 1)
    for _, _ in zip(range(self.traffic["warmup_steps"]),
                    self._forecast(WARMUP)):
      common.synchronize(self.device)
      self.phases.append(("warm-up step", time.perf_counter()))

  def _data(self, f: int):
    """(initial inputs, forcings of every step) of forecast ``f``, batch
    1, in the served dtype."""
    cfg = self.cfg
    gen = data.generator(self.seed, "forecast", f, device=self.device)
    dynamic = [n for n in cfg["input_variables"]
               if n not in cfg["static_variables"]]
    inputs = data.make_fields(cfg, dynamic, 1, ref.input_frames(cfg), gen,
                              self.device, self.dtype)
    forcings = data.make_fields(cfg, cfg["forcing_variables"], 1, self.steps,
                                gen, self.device, self.dtype)
    return {**inputs, **self.statics}, forcings

  def _generators(self, f: int):
    return data.generator(self.seed, "members", f, device=self.device)

  def _forecast(self, f: int):
    from graphcast_tpu_torch import rollout
    cfg, h = self.cfg, self.cfg["step_hours"]
    inputs, forcings = self._data(f)
    frames = ref.input_frames(cfg)
    return rollout.chunked_prediction_generator(
        self.stack,
        rollout.member_generators(self._generators(f), range(self.members)),
        rollout.tile_batch(self.program.fieldset(cfg, inputs, h, 1 - frames),
                           self.members),
        self.template,
        rollout.tile_batch(self.program.fieldset(cfg, forcings, h, 1),
                           self.members),
        num_steps_per_chunk=self.traffic["steps_per_chunk"],
        pull_to_host=False)

  def window(self, seconds: float) -> dict:
    common.synchronize(self.device)
    t0 = time.perf_counter()
    f, done, steps = 0, False, 0
    frames = ref.input_frames(self.cfg)
    while not done:
      history = {}
      for k, pred in enumerate(self._forecast(f)):
        steps += 1
        history[k] = pred
        history.pop(k - frames - 1, None)
        self.sample.offer(lambda f=f, k=k, h=dict(history): (f, k, h))
        if time.perf_counter() - t0 >= seconds:
          done = True
          break
      f += 1
    common.synchronize(self.device)
    self.attempted = steps * self.members
    return {"member_step_s": (time.perf_counter() - t0) / self.attempted}

  def traced(self) -> int:
    n = self.traffic["trace_steps"]
    for _, _ in zip(range(n), self._forecast(TRACE)):
      pass
    common.synchronize(self.device)
    return n

  def release(self):
    del self.model, self.stack, self.template
    if self.device.type == "cuda":
      torch.cuda.empty_cache()

  def check(self) -> dict:
    return {"sample_err": self._worst(None)}

  def control(self, precision: str) -> dict:
    """The same readings with the reference at ``precision`` in the
    program's place, from the same input windows and noise."""
    return {"sample_err": self._worst(precision)}

  def _compared(self) -> list:
    """(f, k, history, member) of each answer compared: the sample's
    steps, one member each, drawn from the seed, from the two halves of
    the batch in turn (which half first, drawn from the seed too)."""
    half = self.members // 2
    first = data.sub_seed(self.seed, "half") % 2
    out = []
    for i, (f, k, history) in enumerate(self.sample.items()):
      lo, n = ((0, half) if (first + i) % 2 == 0
               else (half, self.members - half))
      out.append((f, k, history,
                  lo + data.sub_seed(self.seed, "member", f, k) % n))
    return out

  def _noise(self, f: int, k: int, m: int) -> ref.NoiseStream:
    """Member ``m``'s noise stream of forecast ``f``, past its first ``k``
    samples."""
    gen = ref.member_generators(self._generators(f), range(self.members))[m]
    stream = ref.NoiseStream(self.cfg, gen, self.graph.basis)
    for _ in range(k * ref.draws_per_sample(self.cfg)):
      stream.skip()
    return stream

  def _worst(self, precision) -> float:
    """The worst variable's rms(candidate - reference) / rms(reference)
    over the sample, in the sampler's normalised space; the candidate is
    the program's member, or the reference's at ``precision``."""
    cfg = self.cfg
    frames = ref.input_frames(cfg)
    if self.graph is None:
      self.graph = ref.DeviceGraph(cfg, self.device)
    weights = data.make_weights(ref.param_shapes(cfg), self.seed, self.device)
    stats = {k: {n: t.float() for n, t in v.items()}
             for k, v in self.stats.items()}
    worst = 0.0
    with torch.no_grad(), ref.no_tf32():
      for f, k, history, m in self._compared():
        inputs, forcings = self._data(f)

        def frame(name, j):
          if j < 0:
            return inputs[name][:, j + frames]
          if name in cfg["target_variables"]:
            return history[j][name].data[m:m + 1, 0]
          return forcings[name][:, j]

        window = {n: torch.stack([frame(n, j) for j in range(k - frames, k)],
                                 dim=1)
                  for n in cfg["input_variables"]
                  if n not in cfg["static_variables"]}
        window.update(self.statics)
        step_forcings = {n: t[:, k:k + 1] for n, t in forcings.items()}

        def sampled(precision):
          return ref.sample(cfg, weights, self.graph, stats, window,
                            step_forcings, self._noise(f, k, m),
                            ref.quantizer(precision))

        if (f, k, m) not in self.expected:
          self.expected[f, k, m] = sampled("float32")
        expected = self.expected[f, k, m]
        low = None if precision is None else sampled(precision)
        for name in cfg["target_variables"]:
          if low is not None:
            got = low[name]
          else:
            last = (frame(name, k - 1)[:, None]
                    if name in cfg["input_variables"] else None)
            got = ref.to_normalized_target(
                cfg, stats, name, history[k][name].data[m:m + 1], last)
          err = common.rel_rms(got, expected[name])
          self.detail[precision or "program", name, f, k] = err
          worst = max(worst, err)
    return worst

  def sizes(self) -> dict:
    g = self.graph
    return {"num_grid": g.num_grid, "num_mesh": g.num_mesh,
            **{k: int(v[0].shape[0]) for k, v in g.edges.items()},
            "mask_nnz": g.mask_nnz, "batch": self.members}
