"""The port's demos (graphcast_tpu_torch/examples/) run end to end on the
CPU at tiny sizes: the GraphCast demo from an ERA5-shaped dataset, from
the synthetic batch and from a reference-format checkpoint bundle; the
GenCast demo with each attention backend. Without --device they ask for
the card and raise where there is none."""

import sys

import torch

# torch.utils.checkpoint imports torch._dynamo at first use, which calls
# importlib.util.find_spec on optional packages and raises on a module
# without __spec__, such as the fake ``xarray`` that tests/fake_xarray.py
# installs for other test files. Import it now, with any such module set
# aside.
_xarray = sys.modules.pop("xarray", None)
try:
  import torch._dynamo  # noqa: F401
finally:
  if _xarray is not None:
    sys.modules["xarray"] = _xarray

import pytest

from graphcast_tpu_torch.compat import haiku_checkpoint
from graphcast_tpu_torch.examples import gencast_demo, graphcast_demo
from graphcast_tpu_torch.models import configs
from graphcast_tpu_torch.models.graphcast import GraphCast
from tests.test_torch_graphcast import TINY_MODEL, TINY_TASK

GRAPHCAST_TINY = ["--resolution", "15", "--mesh-size", "1", "--latent-size",
                  "16", "--gnn-msg-steps", "2", "--steps", "2", "--device",
                  "cpu"]
GENCAST_TINY = ["--resolution", "15", "--mesh-size", "1", "--latent-size",
                "16", "--members", "2", "--noise-levels", "3", "--device",
                "cpu"]


def _check(predictions, names, time):
  assert set(predictions.var_names) == set(names)
  assert predictions.sizes["time"] == time
  for name in names:
    assert torch.isfinite(predictions.data(name).float()).all(), name


@pytest.mark.parametrize("data", ["era5", "synthetic"])
def test_graphcast_demo_runs_on_the_cpu(data, capsys):
  preds = graphcast_demo.main(GRAPHCAST_TINY + ["--data", data])
  _check(preds, configs.TASK_13.target_variables, 2)
  out = capsys.readouterr().out
  for line in ("rmse:", "acc:", "grads finite: True",
               "chunked rollout steps: 4"):
    assert line in out


def test_graphcast_demo_loads_a_checkpoint_bundle(tmp_path, capsys):
  task, mc = configs.TaskConfig(**TINY_TASK), configs.ModelConfig(**TINY_MODEL)
  model = GraphCast(mc, task, generator=torch.Generator().manual_seed(4),
                    device="cpu")
  path = tmp_path / "params.npz"
  haiku_checkpoint.save_graphcast_checkpoint(str(path), model, mc, task,
                                             description="tiny bundle")
  preds = graphcast_demo.main(["--checkpoint", str(path), "--steps", "2",
                               "--device", "cpu"])
  _check(preds, task.target_variables, 2)
  assert "loaded checkpoint: tiny bundle" in capsys.readouterr().out


@pytest.mark.parametrize("attention",
                         ["mha", "triblockdiag_mha", "splash_mha"])
def test_gencast_demo_runs_on_the_cpu(attention, capsys):
  from graphcast_tpu_torch.models import gencast
  ensemble = gencast_demo.main(GENCAST_TINY + ["--attention", attention])
  _check(ensemble, gencast.TASK.target_variables, 1)
  assert ensemble.sizes["batch"] == 2
  out = capsys.readouterr().out
  for line in ("crps:", "ensemble-mean rmse:", "grads finite: True"):
    assert line in out


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a CPU-only box")
@pytest.mark.parametrize("demo", [graphcast_demo, gencast_demo])
def test_demos_ask_for_the_card(demo):
  with pytest.raises(RuntimeError, match="no CUDA device"):
    demo.main(["--resolution", "15", "--mesh-size", "1"])
