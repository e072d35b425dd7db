"""The CUDA kernels against their plain-PyTorch twins on the card.

Marked ``cuda``; each test skips (from the ``cuda_device`` fixture) where
torch sees no CUDA device. On a GPU machine:
  python -m pytest tests/test_torch_cuda.py -q

Shapes are small but at the main path's latent width (512) and realistic
in-degree; bf16 activations. Forward tolerance, as in chip_smoke.py:
relative RMS <= 1e-2 and max-abs <= 0.125 (the kernel and twin round at the
same points and differ only in f32 summation order). Backward (K4, K5
against ``torch.autograd.grad`` of the twins): relative RMS <= 1e-2 per
gradient; the kernels round the cotangents to bf16 where the TPU backward
does, autograd of the twin where its casts are, so single elements differ
by a few bf16 ulps. Weight-gradient reduction: relative RMS <= 1e-4 (the
same exact bf16 products, summed in f32 in another order). K6 (block-sparse
attention) against its plain version: o at the forward tolerance, lse
max-abs <= 1e-3 (f32 online softmax against f32 softmax). K7/K8 (its
backward) against the plain backward on the kernel's own o and lse:
relative RMS <= 1e-2 per gradient (both round p and ds to bf16 at the same
points; __expf and the summation order flip an occasional rounding). The
embed modes' backwards (K4, K5) against autograd of their twins: the
backward tolerance.
"""

import numpy as np
import pytest
import torch

from graphcast_tpu_torch.ops.fused_decoder import (
    KEYS, MATRICES, VECTORS, fused_decode, fused_decode_backward,
    fused_decode_reference)
from graphcast_tpu_torch.ops.fused_edge import (
    EdgeIndex, fused_edge, fused_edge_backward, fused_edge_reference)
from graphcast_tpu_torch.ops import splash
from graphcast_tpu_torch.ops.weight_grad import (
    feature_grad, feature_grad_reference, weight_grad, weight_grad_reference)

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


def _assert_grads_close(got, want):
  for name in want:
    d = got[name].float() - want[name].float()
    rel = d.square().mean().sqrt() / want[name].float().square().mean().sqrt()
    assert rel.item() <= 1e-2, (name, rel.item())


def _grads(fn, leaves: dict, cotangents):
  outs = fn(**leaves)
  outs = outs if isinstance(outs, tuple) else (outs,)
  names = [k for k, v in leaves.items()
           if isinstance(v, torch.Tensor) and v.requires_grad]
  grads = torch.autograd.grad(outs, [leaves[k] for k in names], cotangents)
  return dict(zip(names, grads))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["processor", "encoder"])
def test_fused_edge_backward_matches_twin_autograd(mode, cuda_device):
  encoder = mode == "encoder"
  rng = np.random.RandomState(2)
  n, ns, e = 700, 2000 if encoder else 700, 5000
  receivers = np.sort(rng.randint(0, n, e))
  senders = rng.randint(0, ns, e)
  gen = torch.Generator().manual_seed(2)
  bf16 = torch.bfloat16
  leaves = dict(
      e=_rand(gen, e, C, dtype=bf16), sproj=_rand(gen, ns, C, dtype=bf16),
      rproj=_rand(gen, n, C, dtype=bf16),
      we=None if encoder else _rand(gen, C, C, scale=C ** -0.5, dtype=bf16),
      b0=None if encoder else _rand(gen, C, scale=0.1),
      w1=_rand(gen, C, C, scale=C ** -0.5), b1=_rand(gen, C, scale=0.1),
      scale=_rand(gen, C, scale=0.1, offset=1.0),
      offset=_rand(gen, C, scale=0.1))
  leaves = {k: None if v is None else v.to(cuda_device).requires_grad_()
            for k, v in leaves.items()}
  d_agg = _rand(gen, n, C).to(cuda_device)
  cot = (d_agg,) if encoder else (
      _rand(gen, e, C, dtype=bf16).to(cuda_device), d_agg)
  edges = EdgeIndex(senders, receivers, ns, n, device=cuda_device)
  before = fused_edge_backward.launches, weight_grad.launches
  got = _grads(lambda **kw: fused_edge(edges, write_edges=not encoder, **kw),
               leaves, cot)
  want = _grads(lambda **kw: fused_edge_reference(
      edges, write_edges=not encoder, **kw), leaves, cot)
  torch.cuda.synchronize()
  # One row chunk: one K4 launch, then dW1 (and dWe in processor mode).
  assert (fused_edge_backward.launches - before[0],
          weight_grad.launches - before[1]) == (1, 1 if encoder else 2)
  for name, g in got.items():
    assert g.dtype == leaves[name].dtype and g.shape == leaves[name].shape
  _assert_grads_close(got, want)


@pytest.mark.cuda
def test_fused_decoder_backward_matches_twin_autograd(cuda_device):
  rng = np.random.RandomState(3)
  G, M, num_out = 1000, 300, 227
  senders = rng.randint(0, M, 3 * G)
  edges = EdgeIndex(senders, np.repeat(np.arange(G), 3), M, G,
                    device=cuda_device)
  gen = torch.Generator().manual_seed(3)
  bf16 = torch.bfloat16
  w = {k: _rand(gen, C, C, scale=C ** -0.5) for k in MATRICES}
  w["wd1"] = _rand(gen, C, num_out, scale=C ** -0.5)
  w.update({k: _rand(gen, C, scale=0.1) for k in VECTORS})
  w["bd1"] = _rand(gen, num_out, scale=0.1)
  for k in ("escale", "nscale"):
    w[k] = w[k] + 1.0
  leaves = dict(grid=_rand(gen, G, C, dtype=bf16),
                mesh_proj=_rand(gen, M, C, dtype=bf16),
                const=_rand(gen, 3 * G, C, dtype=bf16), **w)
  leaves = {k: v.to(cuda_device).requires_grad_() for k, v in leaves.items()}
  dout = _rand(gen, G, num_out, dtype=bf16).to(cuda_device)

  def run(fn):
    return lambda grid, mesh_proj, const, **weights: fn(
        edges, grid, mesh_proj, const, weights)

  before = fused_decode_backward.launches, weight_grad.launches
  got = _grads(run(fused_decode), leaves, (dout,))
  want = _grads(run(fused_decode_reference), leaves, (dout,))
  torch.cuda.synchronize()
  # One node chunk: one K5 launch, then its 7 matrix gradients.
  assert (fused_decode_backward.launches - before[0],
          weight_grad.launches - before[1]) == (1, 7)
  assert set(got) == {"grid", "mesh_proj", "const", *KEYS}
  _assert_grads_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(5000, 512), (1111, 256)])
def test_weight_grad_kernel_matches_plain(rows, n, cuda_device):
  gen = torch.Generator().manual_seed(4)
  bf16 = torch.bfloat16
  # ``a`` is a row slice of a wider buffer, as K5 passes its scratch slabs.
  a = _rand(gen, rows, 2 * C, dtype=bf16).to(cuda_device)[:, :C]
  b = _rand(gen, rows, n, dtype=bf16).to(cuda_device)
  init = _rand(gen, C, n).to(cuda_device)
  got, want = init.clone(), init.clone()
  before = weight_grad.launches
  weight_grad(a, b, got)
  weight_grad_reference(a, b, want)
  torch.cuda.synchronize()
  assert weight_grad.launches == before + 1
  rel = (got - want).square().mean().sqrt() / want.square().mean().sqrt()
  assert rel.item() <= 1e-4, rel.item()


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(128, 128), (384, 256), (512, 512)])
@pytest.mark.parametrize("rows", [1, 63, 64, 5000, 262_161])
def test_weight_grad_kernel_over_rows_and_tiles(rows, k, n, cuda_device):
  """The TMA + wgmma reduction at ragged row counts (a partial last slab,
  fewer rows than one slab) and 1 to 8 dW tiles, asymmetric operands that
  are row slices of wider buffers (lda > K), a nonzero out; a second run
  from the same out is bit-equal (the partials are summed in a fixed
  order)."""
  gen = torch.Generator().manual_seed(rows + k + n)
  bf16 = torch.bfloat16
  a = _rand(gen, rows, k + 64, offset=0.5, dtype=bf16).to(cuda_device)[:, :k]
  b = _rand(gen, rows, n + 128, scale=2.0, dtype=bf16).to(cuda_device)
  b = b[:, 8:8 + n]
  init = _rand(gen, k, n).to(cuda_device)
  got, again, want = init.clone(), init.clone(), init.clone()
  before = weight_grad.launches
  weight_grad(a, b, got)
  weight_grad(a, b, again)
  weight_grad_reference(a, b, want)
  torch.cuda.synchronize()
  assert weight_grad.launches == before + 2
  assert torch.equal(got, again)
  delta, want_delta = got - init, want - init
  rel = ((delta - want_delta).square().mean().sqrt()
         / want_delta.square().mean().sqrt())
  assert rel.item() <= 1e-4, rel.item()


@pytest.mark.cuda
def test_kernels_refuse_f32(cuda_device):
  edges = EdgeIndex(np.zeros(4, np.int32), np.arange(4), 1, 4,
                    device=cuda_device)
  x = torch.randn(4, C, device=cuda_device)
  w = torch.randn(C, C, device=cuda_device)
  v = torch.zeros(C, device=cuda_device)
  with pytest.raises(TypeError):
    with torch.no_grad():
      fused_edge(edges, x, x[:1], x, w, v, w, v, v, v)


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", [(1000, 1), (1024, 1), (1000, 4)])
def test_block_sparse_attention_kernel_matches_plain(n, batch, cuda_device):
  """K6 on a banded mask with self loops (n not a multiple of the tile,
  and one with a full tile), 4 heads of 128; batch 4 as an ensemble's
  members give it."""
  import scipy.sparse as sp
  rng = np.random.RandomState(n)
  i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
  dense = ((np.abs(i - j) <= 150) & (rng.rand(n, n) < 0.3)) | (i == j)
  dense[:64, :64] = True
  bm = splash.build_block_map(sp.csr_matrix(dense))
  assert bm.full.any()
  gen = torch.Generator().manual_seed(n)
  q, k, v = (_rand(gen, batch, n, 4, 128, dtype=torch.bfloat16)
             .to(cuda_device) for _ in range(3))
  before = splash.block_sparse_attention.launches
  with torch.inference_mode():
    got, lse = splash.block_sparse_attention(q, k, v, bm, 128 ** -0.5)
    want, want_lse = splash.block_sparse_attention_reference(
        q, k, v, bm, 128 ** -0.5)
  torch.cuda.synchronize()
  assert splash.block_sparse_attention.launches == before + 1
  assert got.shape == q.shape and got.dtype == torch.bfloat16
  _assert_close(got, want)
  assert (lse - want_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", [(1000, 1), (1000, 4), (700, 4)])
def test_block_sparse_attention_kernel_long_kv_lists(n, batch, cuda_device):
  """K6 where the kv lists are much longer than its 4-stage ring (a block
  of rows attends every node: 16 pairs, full and partial) and have
  different lengths (so the launch order differs from the tile order), n
  not a multiple of the tile, an odd number of q tiles (700: the last
  pair's tile has no partner), batch x heads up to 16, asymmetric mask."""
  import scipy.sparse as sp
  rng = np.random.RandomState(7)
  i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
  dense = ((np.abs(i - j) <= 150) & (rng.rand(n, n) < 0.05)) | (i == j)
  dense[64:128, :] = True
  dense[300:340, 500:900] = True
  bm = splash.build_block_map(sp.csr_matrix(dense))
  counts = np.diff(bm.kv_offsets)
  assert counts.max() == bm.nq > 4 and bm.full.any() and not bm.full.all()
  order = splash.paired_lists(bm).order
  assert (order != np.arange(len(order))).any()
  gen = torch.Generator().manual_seed(batch)
  q, k, v = (_rand(gen, batch, n, 4, 128, scale=s, dtype=torch.bfloat16)
             .to(cuda_device) for s in (1.0, 2.0, 1.0))
  with torch.inference_mode():
    got, lse = splash.block_sparse_attention(q, k, v, bm, 128 ** -0.5)
    want, want_lse = splash.block_sparse_attention_reference(
        q, k, v, bm, 128 ** -0.5)
  torch.cuda.synchronize()
  _assert_close(got, want)
  assert (lse - want_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_fused_edge_embed_kernel_matches_twin(cuda_device):
  rng = np.random.RandomState(5)
  n, ns, e, F = 700, 2000, 5000, 4
  receivers = np.sort(rng.randint(0, n, e))
  senders = rng.randint(0, ns, e)
  gen = torch.Generator().manual_seed(5)
  bf16 = torch.bfloat16
  args = dict(
      e=_rand(gen, e, F), sproj=_rand(gen, ns, C, dtype=bf16),
      rproj=_rand(gen, n, C, dtype=bf16),
      we=_rand(gen, C, C, scale=C ** -0.5, dtype=bf16),
      b0=_rand(gen, C, scale=0.1, dtype=bf16),
      w1=_rand(gen, C, C, scale=C ** -0.5), b1=_rand(gen, C, scale=0.1),
      scale=_rand(gen, C, scale=0.1, offset=1.0, dtype=bf16),
      offset=_rand(gen, C, scale=0.1, dtype=bf16))
  embed = (_rand(gen, F, C), _rand(gen, C, scale=0.1),
           _rand(gen, C, C, scale=C ** -0.5), _rand(gen, C, scale=0.1))
  args = {k: v.to(cuda_device) for k, v in args.items()}
  embed = tuple(t.to(cuda_device) for t in embed)
  edges = EdgeIndex(senders, receivers, ns, n, device=cuda_device)
  before = fused_edge.embed_launches
  with torch.inference_mode():
    got = fused_edge(edges, write_edges=False, embed_weights=embed, **args)
    want = fused_edge_reference(edges, write_edges=False,
                                embed_weights=embed, **args)
  torch.cuda.synchronize()
  assert fused_edge.embed_launches == before + 1
  _assert_close(got, want)


@pytest.mark.cuda
def test_fused_decoder_embed_kernel_matches_twin(cuda_device):
  rng = np.random.RandomState(6)
  G, M, num_out, F = 1000, 300, 84, 4
  senders = rng.randint(0, M, 3 * G)
  edges = EdgeIndex(senders, np.repeat(np.arange(G), 3), M, G,
                    device=cuda_device)
  gen = torch.Generator().manual_seed(6)
  bf16 = torch.bfloat16
  w = {k: _rand(gen, C, C, scale=C ** -0.5) for k in MATRICES}
  w["wd1"] = _rand(gen, C, num_out, scale=C ** -0.5)
  w.update({k: _rand(gen, C, scale=0.1) for k in VECTORS})
  w["bd1"] = _rand(gen, num_out, scale=0.1)
  w.update(ew0=_rand(gen, F, C), eb0=_rand(gen, C, scale=0.1),
           ew1=_rand(gen, C, C, scale=C ** -0.5),
           eb1=_rand(gen, C, scale=0.1),
           we=_rand(gen, C, C, scale=C ** -0.5), b0=_rand(gen, C, scale=0.1))
  w = {k: v.to(cuda_device) for k, v in w.items()}
  grid = _rand(gen, G, C, dtype=bf16).to(cuda_device)
  mesh_proj = _rand(gen, M, C, dtype=bf16).to(cuda_device)
  feats = _rand(gen, 3 * G, F).to(cuda_device)
  before = fused_decode.embed_launches
  with torch.inference_mode():
    got = fused_decode(edges, grid, mesh_proj, feats, w)
    want = fused_decode_reference(edges, grid, mesh_proj, feats, w)
  torch.cuda.synchronize()
  assert fused_decode.embed_launches == before + 1
  assert got.shape == (G, num_out) and got.dtype == bf16
  _assert_close(got, want)


@pytest.mark.cuda
def test_new_kernels_refuse_what_they_do_not_take(cuda_device):
  """K6 takes bf16 with head dim 128 and raises on CUDA rather than falling
  back; with grad it runs K6 forward and K7/K8 backward."""
  import scipy.sparse as sp
  bm = splash.build_block_map(sp.identity(64, format="csr"))
  q32 = torch.zeros(1, 64, 2, 128, device=cuda_device)
  with pytest.raises(TypeError):
    splash.block_sparse_attention(q32, q32, q32, bm, 1.0)
  q64 = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16, device=cuda_device)
  with pytest.raises(ValueError, match="head dim"):
    splash.block_sparse_attention(q64, q64, q64, bm, 1.0)
  qg = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16, device=cuda_device,
                   requires_grad=True)
  before = (splash.block_sparse_attention.launches, splash.splash_dq.launches,
            splash.splash_dkv.launches)
  o, _ = splash.block_sparse_attention(qg, qg, qg, bm, 1.0)
  (grad,) = torch.autograd.grad(o.float().sum(), qg)
  torch.cuda.synchronize()
  assert (splash.block_sparse_attention.launches, splash.splash_dq.launches,
          splash.splash_dkv.launches) == tuple(b + 1 for b in before)
  assert grad.shape == qg.shape and torch.isfinite(grad.float()).all()


def _attention_case(n, seed, asymmetric):
  import scipy.sparse as sp
  rng = np.random.RandomState(seed)
  i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
  if asymmetric:
    dense = (rng.rand(n, n) < 0.05) | (i == j)
  else:
    dense = ((np.abs(i - j) <= 150) & (rng.rand(n, n) < 0.3)) | (i == j)
    dense |= dense.T
  dense[64:128, :64] = True
  return splash.build_block_map(sp.csr_matrix(dense))


@pytest.mark.cuda
@pytest.mark.parametrize("n,asymmetric", [(1000, False), (1024, True)])
def test_block_sparse_attention_backward_kernels_match_plain(n, asymmetric,
                                                             cuda_device):
  """K7 and K8 (through autograd of block_sparse_attention) against the
  plain backward on the same q, k, v, do and the kernel's own o and lse:
  a symmetric banded mask with n not a multiple of the tile, and an
  asymmetric random one; 4 heads of 128, bf16."""
  bm = _attention_case(n, n, asymmetric)
  assert bm.full.any() and bm.transposed.full.any()
  gen = torch.Generator().manual_seed(n + 1)
  q, k, v = (_rand(gen, 1, n, 4, 128, dtype=torch.bfloat16).to(
      cuda_device).requires_grad_() for _ in range(3))
  do = _rand(gen, 1, n, 4, 128, dtype=torch.bfloat16).to(cuda_device)
  before = splash.splash_dq.launches, splash.splash_dkv.launches
  o, lse = splash.block_sparse_attention(q, k, v, bm, 128 ** -0.5)
  got = torch.autograd.grad(o, (q, k, v), do)
  torch.cuda.synchronize()
  assert (splash.splash_dq.launches, splash.splash_dkv.launches) == (
      before[0] + 1, before[1] + 1)
  with torch.no_grad():
    want = splash.block_sparse_attention_backward_reference(
        q, k, v, o, lse, do, bm, 128 ** -0.5)
  for name, g, w in zip(("dq", "dk", "dv"), got, want):
    assert g.shape == q.shape and g.dtype == torch.bfloat16, name
    _assert_grads_close({name: g}, {name: w})


@pytest.mark.cuda
def test_fused_edge_embed_backward_matches_twin_autograd(cuda_device):
  rng = np.random.RandomState(7)
  n, ns, e, F = 700, 2000, 5000, 4
  receivers = np.sort(rng.randint(0, n, e))
  senders = rng.randint(0, ns, e)
  gen = torch.Generator().manual_seed(7)
  bf16 = torch.bfloat16
  leaves = dict(
      e=_rand(gen, e, F), sproj=_rand(gen, ns, C, dtype=bf16),
      rproj=_rand(gen, n, C, dtype=bf16),
      we=_rand(gen, C, C, scale=C ** -0.5, dtype=bf16),
      b0=_rand(gen, C, scale=0.1, dtype=bf16),
      w1=_rand(gen, C, C, scale=C ** -0.5), b1=_rand(gen, C, scale=0.1),
      scale=_rand(gen, C, scale=0.1, offset=1.0, dtype=bf16),
      offset=_rand(gen, C, scale=0.1, dtype=bf16),
      ew0=_rand(gen, F, C, scale=0.5), eb0=_rand(gen, C, scale=0.1),
      ew1=_rand(gen, C, C, scale=C ** -0.5), eb1=_rand(gen, C, scale=0.1))
  leaves = {k: v.to(cuda_device).requires_grad_() for k, v in leaves.items()}
  d_agg = _rand(gen, n, C).to(cuda_device)
  edges = EdgeIndex(senders, receivers, ns, n, device=cuda_device)

  def run(fn):
    return lambda ew0, eb0, ew1, eb1, **kw: fn(
        edges, write_edges=False, embed_weights=(ew0, eb0, ew1, eb1), **kw)

  before = (fused_edge_backward.embed_launches, weight_grad.launches,
            feature_grad.launches)
  got = _grads(run(fused_edge), leaves, (d_agg,))
  want = _grads(run(fused_edge_reference), leaves, (d_agg,))
  torch.cuda.synchronize()
  # One row chunk: one K4 launch, dW1, dWe' and dEw1, one feature pass.
  assert (fused_edge_backward.embed_launches - before[0],
          weight_grad.launches - before[1],
          feature_grad.launches - before[2]) == (1, 3, 1)
  for name, g in got.items():
    assert g.dtype == leaves[name].dtype and g.shape == leaves[name].shape
  _assert_grads_close(got, want)


@pytest.mark.cuda
def test_fused_decoder_embed_backward_matches_twin_autograd(cuda_device):
  rng = np.random.RandomState(8)
  G, M, num_out, F = 1000, 300, 84, 4
  senders = rng.randint(0, M, 3 * G)
  edges = EdgeIndex(senders, np.repeat(np.arange(G), 3), M, G,
                    device=cuda_device)
  gen = torch.Generator().manual_seed(8)
  bf16 = torch.bfloat16
  w = {k: _rand(gen, C, C, scale=C ** -0.5) for k in MATRICES}
  w["wd1"] = _rand(gen, C, num_out, scale=C ** -0.5)
  w.update({k: _rand(gen, C, scale=0.1) for k in VECTORS})
  w["bd1"] = _rand(gen, num_out, scale=0.1)
  for k in ("escale", "nscale"):
    w[k] = w[k] + 1.0
  w.update(ew0=_rand(gen, F, C, scale=0.5), eb0=_rand(gen, C, scale=0.1),
           ew1=_rand(gen, C, C, scale=C ** -0.5),
           eb1=_rand(gen, C, scale=0.1),
           we=_rand(gen, C, C, scale=C ** -0.5, dtype=bf16),
           b0=_rand(gen, C, scale=0.1, dtype=bf16))
  leaves = dict(grid=_rand(gen, G, C, dtype=bf16),
                mesh_proj=_rand(gen, M, C, dtype=bf16),
                const=_rand(gen, 3 * G, F), **w)
  leaves = {k: v.to(cuda_device).requires_grad_() for k, v in leaves.items()}
  dout = _rand(gen, G, num_out, dtype=bf16).to(cuda_device)

  def run(fn):
    return lambda grid, mesh_proj, const, **weights: fn(
        edges, grid, mesh_proj, const, weights)

  before = (fused_decode_backward.embed_launches, weight_grad.launches,
            feature_grad.launches)
  got = _grads(run(fused_decode), leaves, (dout,))
  want = _grads(run(fused_decode_reference), leaves, (dout,))
  torch.cuda.synchronize()
  # One node chunk: one K5 launch, its 7 matrix gradients, We' and Ew1,
  # one feature pass.
  assert (fused_decode_backward.embed_launches - before[0],
          weight_grad.launches - before[1],
          feature_grad.launches - before[2]) == (1, 9, 1)
  for name, g in got.items():
    assert g.dtype == leaves[name].dtype and g.shape == leaves[name].shape
  _assert_grads_close(got, want)


@pytest.mark.cuda
def test_feature_grad_kernel_matches_plain(cuda_device):
  gen = torch.Generator().manual_seed(9)
  bf16 = torch.bfloat16
  R, F = 3001, 4
  x = _rand(gen, R, F, dtype=bf16).to(cuda_device)
  d = _rand(gen, R, 2 * C, dtype=bf16).to(cuda_device)[:, :C]
  w0 = _rand(gen, F, C, dtype=bf16).to(cuda_device)
  init = _rand(gen, F, C).to(cuda_device)
  got, want = init.clone(), init.clone()
  dx = feature_grad(x, d, w0, got)
  dx_want = feature_grad_reference(x, d, w0, want)
  torch.cuda.synchronize()
  _assert_grads_close({"dw0": got, "dx": dx}, {"dw0": want, "dx": dx_want})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_segment_sum_kernel_matches_plain(dtype, cuda_device):
  """K3 against its plain version on a skewed receiver-sorted edge list
  (one receiver with 3,000 edges, many with none), [E, 4, 512]: f32 within
  1e-5 relative RMS (chunk sums added in another order), bf16 within one
  bf16 ulp of the f32 sum per element; its gather backward too."""
  from graphcast_tpu_torch.ops.segment_sum import (
      segment_sum_reference, sorted_segment_sum)
  rng = np.random.RandomState(0)
  degrees = rng.randint(0, 20, size=2000)
  degrees[::7] = 0
  degrees[123] = 3000
  receivers = np.repeat(np.arange(2000), degrees).astype(np.int32)
  edges = EdgeIndex(np.zeros_like(receivers), receivers, 1, 2000,
                    cuda_device)
  gen = torch.Generator(device=cuda_device).manual_seed(1)
  msgs = torch.randn(receivers.size, 4, C, generator=gen,
                     device=cuda_device).to(dtype)
  before = sorted_segment_sum.launches
  got = sorted_segment_sum(edges, msgs)
  torch.cuda.synchronize()
  assert sorted_segment_sum.launches == before + 1
  want = segment_sum_reference(edges, msgs.reshape(receivers.size, -1))
  want = want.reshape(got.shape)
  assert got.dtype == dtype and got.shape == (2000, 4, C)
  if dtype == torch.float32:
    d = (got - want).square().mean().sqrt() / want.square().mean().sqrt()
    assert d.item() <= 1e-5
  else:
    flat = msgs.reshape(receivers.size, -1).double()
    exact = torch.zeros(2000, 4 * C, dtype=torch.float64, device=cuda_device)
    exact.index_add_(0, edges.receivers.long(), flat)
    magnitude = torch.zeros_like(exact).index_add_(
        0, edges.receivers.long(), flat.abs())
    ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(1e-30)))
                     - 7)
    # One bf16 ulp, plus the f32 reordering error where the sum cancels.
    tol = (ulp + 2.0 ** -20 * magnitude).reshape(got.shape)
    assert ((got.double() - want.double()).abs() <= tol).all()
  assert not got[torch.from_numpy(degrees == 0).to(cuda_device)].any()
  leaf = msgs.detach().float().requires_grad_()
  g = torch.randn(got.shape, generator=gen, device=cuda_device)
  sorted_segment_sum(edges, leaf).backward(g)
  torch.testing.assert_close(leaf.grad, g[edges.receivers.long()])


def _pipelined_case(mode, seed, device):
  """(edge list, fused_edge keyword arguments) of a small K1/K1p case:
  5,000 edges (a partial last tile), receiver runs across tile bounds."""
  rng = np.random.RandomState(seed)
  n, e, F = 700, 5000, 4
  ns = 700 if mode == "processor" else 2000
  edges = EdgeIndex(rng.randint(0, ns, e), np.sort(rng.randint(0, n, e)),
                    ns, n, device=device)
  gen = torch.Generator().manual_seed(seed)
  bf16 = torch.bfloat16
  args = dict(
      e=_rand(gen, e, F) if mode == "embed" else _rand(gen, e, C, dtype=bf16),
      sproj=_rand(gen, ns, C, dtype=bf16), rproj=_rand(gen, n, C, dtype=bf16),
      we=None if mode == "encoder" else _rand(gen, C, C, scale=C ** -0.5,
                                              dtype=bf16),
      b0=None if mode == "encoder" else _rand(gen, C, scale=0.1),
      w1=_rand(gen, C, C, scale=C ** -0.5), b1=_rand(gen, C, scale=0.1),
      scale=_rand(gen, C, scale=0.1, offset=1.0),
      offset=_rand(gen, C, scale=0.1), write_edges=mode == "processor")
  if mode == "embed":
    args["embed_weights"] = (
        _rand(gen, F, C), _rand(gen, C, scale=0.1),
        _rand(gen, C, C, scale=C ** -0.5), _rand(gen, C, scale=0.1))
  move = lambda v: v.to(device) if torch.is_tensor(v) else v  # noqa: E731
  args = {k: tuple(map(move, v)) if isinstance(v, tuple) else move(v)
          for k, v in args.items()}
  return edges, args


def _rel_rms(got, want):
  d = got.float() - want.float()
  return (d.square().mean().sqrt() / want.float().square().mean().sqrt()
          ).item()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["processor", "encoder", "embed"])
def test_pipelined_kernel_matches_k1_and_twin(mode, cuda_device):
  """K1p against K1 on the same inputs: e' bit-identical (the same products
  in the same K order, the same rounding points), the receiver sums equal to
  f32 reassociation (relative RMS <= 1e-6: K1p's 32-row tiles split other
  runs than K1's 64-row ones); against the twin at the forward tolerance.
  Each launch counts on its own kernel's counters."""
  edges, args = _pipelined_case(mode, 31, cuda_device)
  counts = lambda: (fused_edge.launches, fused_edge.pipelined_launches,  # noqa
                    fused_edge.pipelined_encoder_launches,
                    fused_edge.pipelined_embed_launches)
  before = counts()
  with torch.inference_mode():
    k1p = fused_edge(edges, pipelined=True, **args)
    after_k1p = counts()
    k1 = fused_edge(edges, pipelined=False, **args)
    want = fused_edge_reference(edges, **args)
  torch.cuda.synchronize()
  assert after_k1p == (before[0], before[1] + 1,
                       before[2] + (mode == "encoder"),
                       before[3] + (mode == "embed"))
  assert counts()[0] == before[0] + 1
  if mode == "processor":
    assert torch.equal(k1p[0], k1[0])
    _assert_close(k1p[0], want[0])
    k1p, k1, want = k1p[1], k1[1], want[1]
  assert _rel_rms(k1p, k1) <= 1e-6
  _assert_close(k1p, want)


@pytest.mark.cuda
def test_k4_behind_pipelined_forward_gives_k1_path_gradients(cuda_device):
  """Under grad the forward is K1p and the backward still K4, which keeps
  only the inputs: the gradients are those behind K1, up to the order of
  K4's f32 atomics (two runs of K1's path give that noise)."""
  edges, args = _pipelined_case("processor", 32, cuda_device)
  gen = torch.Generator().manual_seed(33)
  cot = (_rand(gen, edges.num_edges, C, dtype=torch.bfloat16).to(cuda_device),
         _rand(gen, edges.num_receivers, C).to(cuda_device))
  names = ["e", "sproj", "rproj", "we", "b0", "w1", "b1", "scale", "offset"]
  grads = {}
  for run, pipelined in (("k1", False), ("k1_again", False), ("k1p", True)):
    leaves = {k: args[k].detach().clone().requires_grad_() for k in names}
    out = fused_edge(edges, write_edges=True, pipelined=pipelined, **leaves)
    grads[run] = torch.autograd.grad(out, list(leaves.values()), cot)
  torch.cuda.synchronize()
  rms = lambda x: x.double().square().mean().sqrt().item()  # noqa: E731
  for name, want, again, got in zip(names, grads["k1"], grads["k1_again"],
                                    grads["k1p"]):
    assert rms(got - want) <= 2 * rms(again - want) + 1e-6 * rms(want), name


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 384, 640])
def test_pipelined_kernel_refuses_widths_it_does_not_take(width,
                                                          cuda_device):
  """K1p takes latent widths 256 and 512 (K1 also takes 128 and 384) and
  raises before launching on any other, on the card as well: no fallback
  to K1 or the twin."""
  edges = EdgeIndex(np.zeros(4, np.int32), np.arange(4, dtype=np.int32), 2,
                    4, device=cuda_device)
  z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16,  # noqa: E731
                             device=cuda_device)
  v = torch.zeros(width, device=cuda_device)
  before = fused_edge.pipelined_launches, fused_edge.launches
  with pytest.raises(ValueError, match="latent width"):
    fused_edge(edges, z(4, width), z(2, width), z(4, width), z(width, width),
               v, z(width, width), v, v, v, pipelined=True)
  assert (fused_edge.pipelined_launches, fused_edge.launches) == before
