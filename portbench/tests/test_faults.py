"""The comparison that decides ``correct``, shown to fail. On the CPU at
a tiny size, a whole run of each cell (everything but the look for a
card) with the timed path broken underneath must come out not correct:
once for each fault the cell can have. On one device there is no exchange
between chips, and at batch 1 (forecast, training) no half batch to leave
out. And the float8 control, the reference in the program's place, must
fail a limit of each cell (the same is read on the card at the cell's
size, PERF.md)."""

import time

import pytest
import torch

from portbench import harness
from portbench.tests.helpers import CPU, LIMITS, tiny_bench

SEED = 2**32 + 11


def _run(cell: str, seconds: float = 0.5, control=None) -> dict:
  return harness.run_cell(tiny_bench(), cell, SEED, seconds, False, CPU,
                          time.perf_counter(), log=lambda *a, **k: None,
                          limits_dir=LIMITS, control=control)


CELLS = ("graphcast_0p25.forecast", "gencast_1p0.ensemble8",
         "graphcast_0p25.train_ar1")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(cell):
  result = _run(cell)
  assert result["correct"], result["checks"]
  assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS[:2])
def test_step_returns_its_state_unchanged(monkeypatch, cell):
  """Each step returns its last input (a variable that is no input: its
prediction unchanged), no residual at all."""
  from graphcast_tpu_torch.fields import Field, FieldSet
  from graphcast_tpu_torch.wrappers import InputsAndResiduals
  original = InputsAndResiduals._unnorm_prediction_and_add_input

  def unchanged(self, inputs, norm_predictions):
    out = original(self, inputs, norm_predictions)
    return FieldSet({n: Field(inputs[n].isel("time", -1).data[:, None]
                              if n in inputs else f.data, f.dims)
                     for n, f in out.items()}, coords=out.coords)
  monkeypatch.setattr(InputsAndResiduals, "_unnorm_prediction_and_add_input",
                      unchanged)
  assert not _run(cell)["correct"]


def test_forecast_answer_altered_where_it_is_produced(monkeypatch):
  """One output channel of the decoder doubled."""
  from graphcast_tpu_torch.models.graphcast import GraphCast
  original = GraphCast._grid_node_outputs_to_prediction

  def altered(self, outputs, template):
    outputs = outputs.clone()
    outputs[..., 0] *= 2
    return original(self, outputs, template)
  monkeypatch.setattr(GraphCast, "_grid_node_outputs_to_prediction", altered)
  assert not _run("graphcast_0p25.forecast")["correct"]


def test_train_step_returns_its_state_unchanged(monkeypatch):
  from graphcast_tpu_torch import train
  monkeypatch.setattr(train.ClippedAdamW, "step",
                      lambda self, total_norm=None: None)
  assert not _run("graphcast_0p25.train_ar1")["correct"]


def test_train_update_applied_with_the_wrong_sign(monkeypatch):
  """Each step moves the parameters by minus AdamW's update: every leaf's
  change keeps its norm, and only its direction tells."""
  from graphcast_tpu_torch import train
  original = train.ClippedAdamW.step

  def flipped(self, total_norm=None):
    before = [p.detach().clone() for p in self.params]
    out = original(self, total_norm)
    with torch.no_grad():
      for p, b in zip(self.params, before):
        p.copy_(2 * b - p)
    return out
  monkeypatch.setattr(train.ClippedAdamW, "step", flipped)
  result = _run("graphcast_0p25.train_ar1")
  assert not result["correct"]
  assert result["checks"]["change_err"]["value"] <= (
      result["checks"]["change_err"]["limit"])


def test_train_gradient_altered_where_it_is_produced(monkeypatch):
  """One leaf's gradient doubled before the optimizer takes it."""
  from graphcast_tpu_torch import train
  original = train.ClippedAdamW.step

  def altered(self, total_norm=None):
    self.fill_grads()
    self.params[0].grad.mul_(2)
    return original(self, total_norm)
  monkeypatch.setattr(train.ClippedAdamW, "step", altered)
  assert not _run("graphcast_0p25.train_ar1")["correct"]


def test_ensemble_answer_altered_where_it_is_produced(monkeypatch):
  """One output variable of every denoiser evaluation doubled."""
  from graphcast_tpu_torch.fields import Field
  from graphcast_tpu_torch.models.denoiser import DenoiserArchitecture
  original = DenoiserArchitecture.forward

  def altered(self, inputs, targets_template, forcings):
    out = original(self, inputs, targets_template, forcings)
    f = out["temperature"]
    return out.replace(temperature=Field(f.data * 2, f.dims))
  monkeypatch.setattr(DenoiserArchitecture, "forward", altered)
  assert not _run("gencast_1p0.ensemble8")["correct"]


def test_ensemble_half_of_the_batch_left_out(monkeypatch):
  """The sampler runs the first half of the members, and the second half
  repeats it."""
  from graphcast_tpu_torch.fields import Field, FieldSet
  from graphcast_tpu_torch.models.gencast import GenCast
  original = GenCast.forward

  def half(self, inputs, targets_template, forcings, generator=None):
    b = targets_template.sizes["batch"]
    take = lambda fs: fs.isel(batch=slice(0, b // 2))  # noqa: E731
    out = original(self, take(inputs), take(targets_template),
                   take(forcings), generator=generator[:b // 2])
    return FieldSet({n: Field(torch.cat([f.data, f.data]), f.dims)
                     for n, f in out.items()}, coords=out.coords)
  monkeypatch.setattr(GenCast, "forward", half)
  assert not _run("gencast_1p0.ensemble8")["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_float8_control_fails_a_limit(cell):
  """``run.py --control float8_e4m3``: the control's numbers held to the
  cell's limits."""
  result = _run(cell, control="float8_e4m3")
  assert not result["correct"], result["checks"]
