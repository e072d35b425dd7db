"""The forecast entry: batch-``batch`` forecasts of ``steps_per_forecast``
steps back to back, a closed loop, each from a fresh initial state drawn
on the device from the seed, each through ``rollout.
chunked_prediction_generator`` (``steps_per_chunk`` steps a chunk, the
predictions left on the device) over ``Autoregressive(InputsAndResiduals(
Bfloat16Cast(GraphCast)))``.

End-to-end: ``forecast_step_s``, the window's seconds to the end of its
last whole step over its steps. Each step's own time, between CUDA events
recorded as consecutive steps are yielded, is read after the window for
the log of the slowest steps. Comparison: for the window's first step and
a sample of ``sample`` others, the reference's normalised residual from
the same input window (the initial state, or the program's own earlier
predictions and the drawn forcings) against the program's,
(prediction - last input) / diffs stddev; ``resid_err`` is the worst
variable's rms(program - reference) / rms(reference).
"""

from __future__ import annotations

import time

import torch

from portbench import data
from portbench.entries import common
from portbench.reference import graphcast as ref

WARMUP, TRACE = -1, -2   # forecast indices of the warm-up and traced steps


class Entry:

  def __init__(self, cfg, traffic, seed, device):
    self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
    self.batch = traffic["batch"]
    self.steps = traffic["steps_per_forecast"]
    self.attempted = 0
    self.phases = []   # (name, host clock) of set-up's stages
    self.sample = common.Sample(seed, traffic["sample"])
    self.graph = None

  def setup(self):
    from portbench import program
    cfg = self.cfg
    self.stats = data.make_stats(cfg, self.seed, self.device)
    self.model, self.stack = program.graphcast_stack(
        cfg, data.make_weights(ref.param_shapes(cfg), self.seed, self.device),
        self.stats, self.device)
    self.phases.append(("model", time.perf_counter()))
    self.statics = data.make_fields(
        cfg, cfg["static_variables"], self.batch, 1,
        data.generator(self.seed, "statics", device=self.device), self.device)
    targets = data.make_fields(
        cfg, cfg["target_variables"], self.batch, 1,
        data.generator(self.seed, "template", device=self.device),
        self.device)
    template = {n: torch.zeros_like(t).expand(
        t.shape[0], self.steps, *t.shape[2:]) for n, t in targets.items()}
    self.template = program.fieldset(cfg, template, cfg["step_hours"], 1)
    self.program = program
    for _, _ in zip(range(self.traffic["warmup_steps"]),
                    self._forecast(WARMUP)):
      common.synchronize(self.device)
      self.phases.append(("warm-up step", time.perf_counter()))

  def _data(self, f: int):
    """(initial inputs, forcings of every step) of forecast ``f``."""
    cfg = self.cfg
    gen = data.generator(self.seed, "forecast", f, device=self.device)
    frames = ref.input_frames(cfg)
    dynamic = [n for n in cfg["input_variables"]
               if n not in cfg["static_variables"]]
    inputs = data.make_fields(cfg, dynamic, self.batch, frames, gen,
                              self.device)
    forcings = data.make_fields(cfg, cfg["forcing_variables"], self.batch,
                                self.steps, gen, self.device)
    return {**inputs, **self.statics}, forcings

  def _forecast(self, f: int):
    from graphcast_tpu_torch import rollout
    cfg = self.cfg
    inputs, forcings = self._data(f)
    frames = ref.input_frames(cfg)
    return rollout.chunked_prediction_generator(
        self.stack, None,
        self.program.fieldset(cfg, inputs, cfg["step_hours"], 1 - frames),
        self.template,
        self.program.fieldset(cfg, forcings, cfg["step_hours"], 1),
        num_steps_per_chunk=self.traffic["steps_per_chunk"],
        pull_to_host=False)

  def window(self, seconds: float) -> dict:
    marks = common.Marks(self.device)
    common.synchronize(self.device)
    t0 = time.perf_counter()
    marks.mark()
    yielded, where = [], []   # host clock at each step's yield; (f, k)
    f, done = 0, False
    while not done:
      history = {}
      for k, pred in enumerate(self._forecast(f)):
        marks.mark()
        yielded.append(time.perf_counter() - t0)
        where.append((f, k))
        self.attempted += 1
        history[k] = pred
        history.pop(k - 3, None)
        self.sample.offer(lambda f=f, k=k, h=dict(history): (f, k, h))
        if time.perf_counter() - t0 >= seconds:
          done = True
          break
      f += 1
    common.synchronize(self.device)
    elapsed = time.perf_counter() - t0
    steps = marks.intervals()
    common.log_slowest(steps, where, yielded, elapsed)
    return {"forecast_step_s": elapsed / self.attempted}

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
    return {"resid_err": self._worst(None)}

  def control(self, precision: str) -> dict:
    """The same readings with the reference at ``precision`` in the
    program's place, from the same input windows."""
    return {"resid_err": self._worst(precision)}

  def _worst(self, precision) -> float:
    """The worst variable's rms(candidate - reference) / rms(reference)
    over the sample; the candidate is the program's residual, or the
    reference's at ``precision``."""
    cfg = self.cfg
    frames = ref.input_frames(cfg)
    if self.graph is None:
      self.graph = ref.DeviceGraph(cfg, self.device)
    weights = data.make_weights(ref.param_shapes(cfg), self.seed, self.device)
    worst = 0.0
    with torch.no_grad(), ref.no_tf32():
      for f, k, history in self.sample.items():
        inputs, forcings = self._data(f)

        def frame(name, j):
          if j < 0:
            return inputs[name][:, j + frames]
          if name in cfg["target_variables"]:
            return history[j][name].data[:, 0]
          return forcings[name][:, j]

        window = {n: torch.stack([frame(n, j) for j in range(k - frames, k)],
                                 dim=1)
                  for n in cfg["input_variables"]
                  if n not in cfg["static_variables"]}
        window.update(self.statics)
        step_forcings = {n: t[:, k:k + 1] for n, t in forcings.items()}

        def residuals(precision):
          return ref.residuals(cfg, weights, self.graph, self.stats, window,
                               step_forcings, ref.quantizer(precision))

        expected = residuals("float32")
        low = None if precision is None else residuals(precision)
        for name in cfg["target_variables"]:
          if low is not None:
            got = low[name]
          else:
            diffs = self.stats["diffs_stddev"][name]
            if ref.is_atmospheric(cfg, name):
              diffs = diffs[:, None, None]
            got = (history[k][name].data[:, 0].float()
                   - frame(name, k - 1).float()) / diffs
          worst = max(worst, common.rel_rms(got, expected[name]))
    return worst

  def sizes(self) -> dict:
    g = self.graph
    return {"num_grid": g.num_grid, "num_mesh": g.num_mesh,
            **{k: int(v[0].shape[0]) for k, v in g.edges.items()},
            "batch": self.batch}
