"""The CUDA kernels against their plain-PyTorch twins on the card.

Marked ``cuda``; each test skips (from the ``cuda_device`` fixture) where
torch sees no CUDA device. On a GPU machine:
  python -m pytest tests/test_torch_cuda.py -q

Shapes are small but at the main path's latent width (512) and realistic
in-degree; bf16 activations. Tolerance, as in chip_smoke.py: relative RMS
<= 1e-2 and max-abs <= 0.125 (the kernel and twin round at the same points
and differ only in f32 summation order).
"""

import numpy as np
import pytest
import torch

from graphcast_tpu_torch.ops.fused_decoder import (
    MATRICES, VECTORS, fused_decode, fused_decode_reference)
from graphcast_tpu_torch.ops.fused_edge import (
    EdgeIndex, fused_edge, fused_edge_reference)

C = 512


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda")


def _assert_close(got, want):
  d = got.float() - want.float()
  rel = (d.square().mean().sqrt() / want.float().square().mean().sqrt())
  assert rel.item() <= 1e-2, rel.item()
  assert d.abs().max().item() <= 0.125, d.abs().max().item()


def _rand(gen, *shape, scale=1.0, offset=0.0, dtype=torch.float32):
  x = torch.randn(*shape, generator=gen) * scale + offset
  return x.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["processor", "encoder"])
def test_fused_edge_kernel_matches_twin(mode, cuda_device):
  encoder = mode == "encoder"
  rng = np.random.RandomState(0)
  n, ns, e = 700, 2000 if encoder else 700, 5000
  receivers = np.sort(rng.randint(0, n, e))
  senders = rng.randint(0, ns, e)
  gen = torch.Generator().manual_seed(0)
  bf16 = torch.bfloat16
  args = dict(
      e=_rand(gen, e, C, dtype=bf16), sproj=_rand(gen, ns, C, dtype=bf16),
      rproj=_rand(gen, n, C, dtype=bf16),
      we=None if encoder else _rand(gen, C, C, scale=C ** -0.5),
      b0=None if encoder else _rand(gen, C, scale=0.1),
      w1=_rand(gen, C, C, scale=C ** -0.5), b1=_rand(gen, C, scale=0.1),
      scale=_rand(gen, C, scale=0.1, offset=1.0),
      offset=_rand(gen, C, scale=0.1))
  args = {k: None if v is None else v.to(cuda_device)
          for k, v in args.items()}
  edges = EdgeIndex(senders, receivers, ns, n, device=cuda_device)
  before = fused_edge.launches
  with torch.inference_mode():
    got = fused_edge(edges, write_edges=not encoder, **args)
    want = fused_edge_reference(edges, write_edges=not encoder, **args)
  torch.cuda.synchronize()
  assert fused_edge.launches == before + 1
  if encoder:
    _assert_close(got, want)
  else:
    _assert_close(got[0], want[0])
    _assert_close(got[1], want[1])


@pytest.mark.cuda
def test_fused_decoder_kernel_matches_twin(cuda_device):
  rng = np.random.RandomState(1)
  G, M, num_out = 1000, 300, 227
  senders = rng.randint(0, M, 3 * G)
  edges = EdgeIndex(senders, np.repeat(np.arange(G), 3), M, G,
                    device=cuda_device)
  gen = torch.Generator().manual_seed(1)
  bf16 = torch.bfloat16
  w = {k: _rand(gen, C, C, scale=C ** -0.5) for k in MATRICES}
  w["wd1"] = _rand(gen, C, num_out, scale=C ** -0.5)
  w.update({k: _rand(gen, C, scale=0.1) for k in VECTORS})
  w["bd1"] = _rand(gen, num_out, scale=0.1)
  w = {k: v.to(cuda_device) for k, v in w.items()}
  grid = _rand(gen, G, C, dtype=bf16).to(cuda_device)
  mesh_proj = _rand(gen, M, C, dtype=bf16).to(cuda_device)
  const = _rand(gen, 3 * G, C, dtype=bf16).to(cuda_device)
  before = fused_decode.launches
  with torch.inference_mode():
    got = fused_decode(edges, grid, mesh_proj, const, w)
    want = fused_decode_reference(edges, grid, mesh_proj, const, w)
  torch.cuda.synchronize()
  assert fused_decode.launches == before + 1
  assert got.shape == (G, num_out) and got.dtype == bf16
  _assert_close(got, want)


@pytest.mark.cuda
def test_kernels_refuse_grad_and_f32(cuda_device):
  edges = EdgeIndex(np.zeros(4, np.int32), np.arange(4), 1, 4,
                    device=cuda_device)
  x = torch.randn(4, C, device=cuda_device)
  w = torch.randn(C, C, device=cuda_device, requires_grad=True)
  v = torch.zeros(C, device=cuda_device)
  with pytest.raises(NotImplementedError):
    fused_edge(edges, x.bfloat16(), x[:1].bfloat16(), x.bfloat16(), w, v, w,
               v, v, v)
  with pytest.raises(TypeError):
    with torch.no_grad():
      fused_edge(edges, x, x[:1], x, w, v, w, v, v, v)
