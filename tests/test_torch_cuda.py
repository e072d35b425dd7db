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
backward tolerance. No sum of any kernel uses atomics: K1's receiver sums,
every gradient of K4 and K5 (K3's sender mode sums the per-edge sender
gradients) and feature_grad's rerun bit-equal, and K1p's e' and sums equal
K1's bit for bit. The general path (batch 2: a GenCast Mini evaluation and
a GraphCast_small train step) reruns bit-equal in its outputs and every
gradient with torch's deterministic algorithms off: its gathers'
gradients and all its aggregations are K3 sums.
"""

import numpy as np
import pytest
import torch

from graphcast_tpu_torch.ops.fused_decoder import (
    KEYS, MATRICES, VECTORS, fused_decode, fused_decode_backward,
    fused_decode_reference)
from graphcast_tpu_torch.ops.fused_edge import (
    EdgeIndex, fused_edge, fused_edge_backward, fused_edge_embed_backward,
    fused_edge_reference)
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


def _attention_case(n, seed, kind):
  """A block map for the backward tests: "banded" (symmetric, with self
  loops), "asymmetric" (random) or "long" (banded and sparse, plus q rows
  64-127 attending every node and every q row attending nodes 128-191, so
  that both maps have lists much longer than the kernels' 4-stage ring,
  of different lengths)."""
  import scipy.sparse as sp
  rng = np.random.RandomState(seed)
  i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
  if kind == "asymmetric":
    dense = (rng.rand(n, n) < 0.05) | (i == j)
  elif kind == "banded":
    dense = ((np.abs(i - j) <= 150) & (rng.rand(n, n) < 0.3)) | (i == j)
    dense |= dense.T
  else:
    dense = ((np.abs(i - j) <= 150) & (rng.rand(n, n) < 0.05)) | (i == j)
    dense[64:128, :] = True
    dense[:, 128:192] = True
  dense[64:128, :64] = True
  return splash.build_block_map(sp.csr_matrix(dense))


def _backward_operands(bm, batch, seed, device):
  gen = torch.Generator().manual_seed(seed)
  q, k, v = (_rand(gen, batch, bm.n, 4, 128, dtype=torch.bfloat16).to(
      device).requires_grad_() for _ in range(3))
  do = _rand(gen, batch, bm.n, 4, 128, dtype=torch.bfloat16).to(device)
  return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch,kind", [
    (1000, 1, "banded"), (1024, 1, "asymmetric"), (700, 1, "banded"),
    (700, 4, "asymmetric"), (1000, 4, "banded"), (1000, 1, "long"),
    (700, 4, "long")])
def test_block_sparse_attention_backward_kernels_match_plain(n, batch, kind,
                                                             cuda_device):
  """K7 and K8 (through autograd of block_sparse_attention) against the
  plain backward on the same q, k, v, do and the kernel's own o and lse:
  a symmetric banded mask with n not a multiple of the tile, an asymmetric
  random one, lists longer than the ring in both maps ("long"); an odd
  number of tiles (700: the last group's tile has no partner); batch 4
  (batch x heads 16); 4 heads of 128, bf16. K7 and K8 own their output
  rows and walk their lists in a fixed order, with no atomics, so a second
  backward gives the same dq, dk and dv bit for bit."""
  bm = _attention_case(n, n, kind)
  assert bm.full.any() and bm.transposed.full.any()
  if kind == "long":
    for m in (bm, bm.transposed):
      counts = np.diff(m.kv_offsets)
      assert counts.max() == m.nq > 4 and len(np.unique(counts)) > 1
  q, k, v, do = _backward_operands(bm, batch, n + 1, cuda_device)
  before = splash.splash_dq.launches, splash.splash_dkv.launches
  o, lse = splash.block_sparse_attention(q, k, v, bm, 128 ** -0.5)
  got = torch.autograd.grad(o, (q, k, v), do, retain_graph=True)
  torch.cuda.synchronize()
  assert (splash.splash_dq.launches, splash.splash_dkv.launches) == (
      before[0] + 1, before[1] + 1)
  again = torch.autograd.grad(o, (q, k, v), do)
  for name, a, b in zip(("dq", "dk", "dv"), got, again):
    assert torch.equal(a, b), name
  with torch.no_grad():
    want = splash.block_sparse_attention_backward_reference(
        q, k, v, o, lse, do, bm, 128 ** -0.5)
  for name, g, w in zip(("dq", "dk", "dv"), got, want):
    assert g.shape == q.shape and g.dtype == torch.bfloat16, name
    _assert_grads_close({name: g}, {name: w})


@pytest.mark.cuda
@pytest.mark.parametrize("num_shards", [2, 3, 4])
def test_attention_kernels_on_shard_maps(num_shards, cuda_device):
  """K6, K7 and K8 on sequence-parallel shard maps (rectangular: the
  shard's q tiles against every kv tile; 700 nodes give 11 q tiles, which
  3 and 4 shards do not divide, so the last shards hold empty tiles):
  each shard against the plain twins on its map; the shards' o, lse and dq
  put together equal the whole map's kernels bit for bit; the dk and dv
  partials summed in shard order within the backward tolerance of the
  whole map's."""
  bm = _attention_case(700, 700, "banded")
  q, k, v, do = (t.detach() for t in _backward_operands(bm, 2, 5,
                                                        cuda_device))
  scale = 128 ** -0.5

  def run(m, qs, dos):
    qs = qs.detach().requires_grad_()
    ks, vs = k.detach().requires_grad_(), v.detach().requires_grad_()
    o, lse = splash.block_sparse_attention(qs, ks, vs, m, scale)
    return (o, lse, *torch.autograd.grad(o, (qs, ks, vs), dos)), (qs, ks,
                                                                   vs)

  (o, lse, dq, dk, dv), _ = run(bm, q, do)
  parts, dk_sum, dv_sum = [], torch.zeros(dk.shape, device=cuda_device), (
      torch.zeros(dv.shape, device=cuda_device))
  for m, (a, b) in zip(splash.shard_block_maps(bm, num_shards),
                       splash.shard_rows(bm.n, num_shards)):
    got, (qs, ks, vs) = run(m, q[:, a:b], do[:, a:b])
    parts.append(got[:3])
    dk_sum += got[3].float()
    dv_sum += got[4].float()
    with torch.no_grad():
      want_o, want_lse = splash.block_sparse_attention_reference(
          qs, ks, vs, m, scale)
      _assert_close(got[0], want_o)
      assert (got[1] - want_lse).abs().max().item() <= 1e-3
      want = splash.block_sparse_attention_backward_reference(
          qs, ks, vs, got[0], got[1], do[:, a:b], m, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got[2:], want):
      _assert_grads_close({name: g}, {name: w})
  torch.cuda.synchronize()
  for i, (name, whole) in enumerate((("o", o), ("lse", lse), ("dq", dq))):
    assert torch.equal(torch.cat([p[i] for p in parts], 2 if i == 1 else 1),
                       whole), name
  _assert_grads_close({"dk": dk_sum.to(dk.dtype), "dv": dv_sum.to(dv.dtype)},
                      {"dk": dk, "dv": dv})


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
  # Every sum in a fixed order: a rerun is bit-equal in every gradient.
  again = _grads(run(fused_edge), leaves, (d_agg,))
  for name, g in got.items():
    assert torch.equal(g, again[name]), name


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
  # Every sum in a fixed order: a rerun is bit-equal in every gradient.
  again = _grads(run(fused_decode), leaves, (dout,))
  for name, g in got.items():
    assert torch.equal(g, again[name]), name


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
  # The block partials are added in a fixed order: a rerun is bit-equal.
  again = init.clone()
  assert torch.equal(feature_grad(x, d, w0, again), dx)
  assert torch.equal(again, got)


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


def _pipelined_case(mode, seed, device, width=C):
  """(edge list, fused_edge keyword arguments) of a small K1/K1p case:
  5,000 edges (a partial last tile), receiver runs across tile bounds, a
  360-edge run over several tiles, latent ``width``."""
  rng = np.random.RandomState(seed)
  n, e, F = 700, 5000, 4
  ns = 700 if mode == "processor" else 2000
  receivers = np.sort(rng.randint(0, n, e))
  receivers[100:460] = receivers[100]  # still sorted
  edges = EdgeIndex(rng.randint(0, ns, e), receivers, ns, n, device=device)
  gen = torch.Generator().manual_seed(seed)
  bf16 = torch.bfloat16
  W, s = width, width ** -0.5
  args = dict(
      e=_rand(gen, e, F) if mode == "embed" else _rand(gen, e, W, dtype=bf16),
      sproj=_rand(gen, ns, W, dtype=bf16), rproj=_rand(gen, n, W, dtype=bf16),
      we=None if mode == "encoder" else _rand(gen, W, W, scale=s,
                                              dtype=bf16),
      b0=None if mode == "encoder" else _rand(gen, W, scale=0.1),
      w1=_rand(gen, W, W, scale=s), b1=_rand(gen, W, scale=0.1),
      scale=_rand(gen, W, scale=0.1, offset=1.0),
      offset=_rand(gen, W, scale=0.1), write_edges=mode == "processor")
  if mode == "embed":
    args["embed_weights"] = (
        _rand(gen, F, W), _rand(gen, W, scale=0.1),
        _rand(gen, W, W, scale=s), _rand(gen, W, scale=0.1))
  move = lambda v: v.to(device) if torch.is_tensor(v) else v  # noqa: E731
  args = {k: tuple(map(move, v)) if isinstance(v, tuple) else move(v)
          for k, v in args.items()}
  return edges, args


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256, 384, 512])
@pytest.mark.parametrize("mode", ["processor", "encoder", "embed"])
def test_pipelined_kernel_matches_k1_and_twin(mode, width, cuda_device):
  """K1p against K1 on the same inputs: e' and the receiver sums equal bit
  for bit (the same wgmma sequence per 64-column chunk, the same LayerNorm
  sums and fixed-order run sums), at every latent width K1 takes; against
  the twin at the forward tolerance; a rerun of each bit-equal. Each launch
  counts on its own kernel's counters."""
  edges, args = _pipelined_case(mode, 31, cuda_device, width)
  counts = lambda: (fused_edge.launches, fused_edge.pipelined_launches,  # noqa
                    fused_edge.pipelined_encoder_launches,
                    fused_edge.pipelined_embed_launches)
  before = counts()
  with torch.inference_mode():
    k1p = fused_edge(edges, pipelined=True, **args)
    after_k1p = counts()
    k1 = fused_edge(edges, pipelined=False, **args)
    k1p_again = fused_edge(edges, pipelined=True, **args)
    k1_again = fused_edge(edges, pipelined=False, **args)
    want = fused_edge_reference(edges, **args)
  torch.cuda.synchronize()
  assert after_k1p == (before[0], before[1] + 1,
                       before[2] + (mode == "encoder"),
                       before[3] + (mode == "embed"))
  assert counts()[:2] == (before[0] + 2, before[1] + 2)
  outs = [(k1p, k1, k1p_again, k1_again, want)]
  if mode == "processor":
    outs = [tuple(o[i] for o in outs[0]) for i in (0, 1)]
  for got, ref, got2, ref2, plain in outs:
    assert torch.equal(got, ref), (got.float() - ref.float()).abs().max()
    assert torch.equal(got, got2) and torch.equal(ref, ref2)
    _assert_close(got, plain)


@pytest.mark.cuda
def test_k4_behind_pipelined_forward_gives_k1_path_gradients(cuda_device):
  """Under grad the forward is K1p and the backward still K4, which keeps
  only the inputs and sums in a fixed order: every gradient equals the one
  behind K1, bit for bit."""
  edges, args = _pipelined_case("processor", 32, cuda_device)
  gen = torch.Generator().manual_seed(33)
  cot = (_rand(gen, edges.num_edges, C, dtype=torch.bfloat16).to(cuda_device),
         _rand(gen, edges.num_receivers, C).to(cuda_device))
  names = ["e", "sproj", "rproj", "we", "b0", "w1", "b1", "scale", "offset"]
  grads = {}
  for run, pipelined in (("k1", False), ("k1p", True)):
    leaves = {k: args[k].detach().clone().requires_grad_() for k in names}
    out = fused_edge(edges, write_edges=True, pipelined=pipelined, **leaves)
    grads[run] = torch.autograd.grad(out, list(leaves.values()), cot)
  torch.cuda.synchronize()
  for name, want, got in zip(names, grads["k1"], grads["k1p"]):
    assert torch.equal(got, want), name


@pytest.mark.cuda
@pytest.mark.parametrize("width", [192, 640])
def test_pipelined_kernel_refuses_widths_it_does_not_take(width,
                                                          cuda_device):
  """K1p takes K1's latent widths, the multiples of 128 up to 512, and
  raises before launching on any other, as K1 does, on the card as well:
  no fallback to K1 or the twin."""
  edges = EdgeIndex(np.zeros(4, np.int32), np.arange(4, dtype=np.int32), 2,
                    4, device=cuda_device)
  z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16,  # noqa: E731
                             device=cuda_device)
  v = torch.zeros(width, device=cuda_device)
  before = fused_edge.pipelined_launches, fused_edge.launches
  for pipelined in (True, False):
    with pytest.raises(ValueError, match="latent width"):
      fused_edge(edges, z(4, width), z(2, width), z(4, width),
                 z(width, width), v, z(width, width), v, v, v,
                 pipelined=pipelined)
  assert (fused_edge.pipelined_launches, fused_edge.launches) == before


@pytest.mark.cuda
def test_sender_segment_sum_kernel_matches_plain(cuda_device):
  """K3's sender mode against its plain version on a receiver-sorted list
  whose senders are skewed (one sender feeds 3,000 receivers, many send
  nothing), [E, 1024] bf16 messages: f32 sums within 1e-5 relative RMS of
  index_add_ in the sender-sorted order (chunk sums added in another
  order), zeros for senders of no edge; a rerun bit-equal; one launch."""
  from graphcast_tpu_torch.ops.segment_sum import (
      sender_segment_sum, sender_sum_reference)
  rng = np.random.RandomState(3)
  E, N, S = 20_000, 2000, 5000
  receivers = np.sort(rng.randint(0, N, E)).astype(np.int32)
  senders = rng.randint(0, S // 2, E)
  senders[rng.rand(E) < 0.15] = 4321
  edges = EdgeIndex(senders, receivers, S, N, cuda_device)
  gen = torch.Generator(device=cuda_device).manual_seed(4)
  msgs = torch.randn(E, 2 * C, generator=gen, device=cuda_device).to(
      torch.bfloat16)
  before = sender_segment_sum.launches
  got = sender_segment_sum(edges, msgs)
  again = sender_segment_sum(edges, msgs)
  torch.cuda.synchronize()
  assert sender_segment_sum.launches == before + 2
  want = sender_sum_reference(edges, msgs)
  assert got.dtype == torch.float32 and got.shape == (S, 2 * C)
  d = (got - want).square().mean().sqrt() / want.square().mean().sqrt()
  assert d.item() <= 1e-5
  assert torch.equal(got, again)
  empty = torch.from_numpy(np.bincount(senders, minlength=S) == 0)
  assert not got[empty.to(cuda_device)].any()


# K2 and K5 at the shapes their block plan must handle: a grid-node count
# below one 64-node tile, partial last tiles, an odd tile count (the last
# cluster's second block holds no node), latent widths 128 to 512, one
# output and 227 (a partial 128-column pass), embed mode.
_DECODER_SHAPES = [(1, 512, 227, False), (37, 128, 1, False),
                   (150, 256, 227, True), (200, 384, 84, False),
                   (129, 512, 1, True), (1000, 512, 227, False)]


def _decoder_case(seed, G, width, num_out, embed, M=300, F=4):
  rng = np.random.RandomState(seed)
  senders = rng.randint(0, M, 3 * G)
  gen = torch.Generator().manual_seed(seed)
  bf16 = torch.bfloat16
  w = {k: _rand(gen, width, width, scale=width ** -0.5) for k in MATRICES}
  w["wd1"] = _rand(gen, width, num_out, scale=width ** -0.5)
  w.update({k: _rand(gen, width, scale=0.1) for k in VECTORS})
  w["bd1"] = _rand(gen, num_out, scale=0.1)
  for k in ("escale", "nscale"):
    w[k] = w[k] + 1.0
  if embed:
    w.update(ew0=_rand(gen, F, width, scale=0.5),
             eb0=_rand(gen, width, scale=0.1),
             ew1=_rand(gen, width, width, scale=width ** -0.5),
             eb1=_rand(gen, width, scale=0.1),
             we=_rand(gen, width, width, scale=width ** -0.5),
             b0=_rand(gen, width, scale=0.1))
  acts = dict(grid=_rand(gen, G, width, dtype=bf16),
              mesh_proj=_rand(gen, M, width, dtype=bf16),
              const=(_rand(gen, 3 * G, F) if embed
                     else _rand(gen, 3 * G, width, dtype=bf16)))
  dout = _rand(gen, G, num_out, dtype=bf16)
  return senders, w, acts, dout


@pytest.mark.cuda
@pytest.mark.parametrize("G,width,num_out,embed", _DECODER_SHAPES)
def test_fused_decoder_kernel_at_edge_shapes_matches_twin(G, width, num_out,
                                                          embed, cuda_device):
  senders, w, acts, _ = _decoder_case(11, G, width, num_out, embed)
  edges = EdgeIndex(senders, np.repeat(np.arange(G), 3), 300, G,
                    device=cuda_device)
  w = {k: v.to(cuda_device) for k, v in w.items()}
  acts = {k: v.to(cuda_device) for k, v in acts.items()}
  before = fused_decode.launches, fused_decode.embed_launches
  with torch.inference_mode():
    got = fused_decode(edges, acts["grid"], acts["mesh_proj"],
                       acts["const"], w)
    want = fused_decode_reference(edges, acts["grid"], acts["mesh_proj"],
                                  acts["const"], w)
  torch.cuda.synchronize()
  assert (fused_decode.launches - before[0],
          fused_decode.embed_launches - before[1]) == (1, int(embed))
  assert got.shape == (G, num_out) and got.dtype == torch.bfloat16
  _assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("G,width,num_out,embed", _DECODER_SHAPES)
def test_fused_decoder_backward_at_edge_shapes_matches_twin_and_reruns_bit_equal(
    G, width, num_out, embed, cuda_device):
  senders, w, acts, dout = _decoder_case(12, G, width, num_out, embed)
  edges = EdgeIndex(senders, np.repeat(np.arange(G), 3), 300, G,
                    device=cuda_device)
  leaves = {k: v.to(cuda_device).requires_grad_()
            for k, v in {**acts, **w}.items()}
  dout = dout.to(cuda_device)

  def run(fn):
    return lambda grid, mesh_proj, const, **weights: fn(
        edges, grid, mesh_proj, const, weights)

  got = _grads(run(fused_decode), leaves, (dout,))
  want = _grads(run(fused_decode_reference), leaves, (dout,))
  torch.cuda.synchronize()
  _assert_grads_close(got, want)
  # Fixed-order sums: a rerun at the same chunking is bit-equal in every
  # gradient.
  det = {k: v.detach() for k, v in leaves.items()}
  weights = {k: det[k] for k in w}
  runs = [fused_decode_backward(edges, det["grid"], det["mesh_proj"],
                                det["const"], weights, dout)
          for _ in range(2)]
  for i in range(3):  # dgrid, dmesh_proj, dconst
    assert torch.equal(runs[0][i], runs[1][i]), i
  for k in runs[0][3]:
    assert torch.equal(runs[0][3][k], runs[1][3][k]), k


@pytest.mark.cuda
def test_decoder_smem_layout_matches_kernels(cuda_device):
  import ctypes
  from graphcast_tpu_torch.native import build
  from graphcast_tpu_torch.ops import fused_decoder
  lib = build.load_library()
  keys = ("a", "g", "ring", "exchange", "sums", "colred", "bars", "stages",
          "total")
  for width in (128, 256, 384, 512):
    for outputs in (1, 227, 512):
      for embed in (False, True):
        for backward in (False, True):
          want = fused_decoder.smem_layout(width, outputs, embed, backward)
          no_pad = -(-outputs // 128) * 128
          kinds = len(fused_decoder._BWD_SUMS) + (
              len(fused_decoder._BWD_SUMS_EMBED) if embed else 0)
          W = fused_decoder.WIDTH
          buf = (ctypes.c_int * len(keys))()
          lib.gc_decoder_layout(W, max(W, no_pad) if backward else W,
                                kinds * W + no_pad if backward else 0, buf)
          assert dict(zip(keys, buf)) == want


# K1 and K4 at the shapes their block plan must handle: edge counts that are
# not a multiple of a cluster's 128 rows (1, 63, 129, 777, 1,500, 5,000), a
# receiver run longer than two 64-row tiles (a pole: 360 edges into one
# node, from 1,000 edges up), latent widths 128 to 512, and every mode: K1's
# processor (We, e'), We without e', encoder (no We), e' without We, embed;
# K4's processor, encoder and embed.
_EDGE_SHAPES = [(1, 512, "processor"), (63, 128, "encoder"),
                (129, 256, "embed"), (5000, 384, "processor"),
                (2000, 512, "nowe_write"), (777, 256, "we_nowrite"),
                (1500, 512, "embed"), (3000, 128, "encoder")]
_EDGE_BWD_SHAPES = [s for s in _EDGE_SHAPES
                    if s[2] in ("processor", "encoder", "embed")]


def _edge_shape_case(seed, E, width, mode, F=4, ns=300):
  """(edge list arrays, fused_edge keyword arguments, d_eout or None,
  d_agg) of one shape; CPU tensors."""
  rng = np.random.RandomState(seed)
  n = max(1, E // 8)
  receivers = np.sort(rng.randint(0, n, E))
  if E >= 1000:
    receivers[100:460] = receivers[100]  # still sorted
  senders = rng.randint(0, ns, E)
  gen = torch.Generator().manual_seed(seed)
  bf16 = torch.bfloat16
  has_we = mode in ("processor", "we_nowrite", "embed")
  embed = mode == "embed"
  s = width ** -0.5
  args = dict(
      e=_rand(gen, E, F) if embed else _rand(gen, E, width, dtype=bf16),
      sproj=_rand(gen, ns, width, dtype=bf16),
      rproj=_rand(gen, n, width, dtype=bf16),
      we=_rand(gen, width, width, scale=s, dtype=bf16) if has_we else None,
      b0=_rand(gen, width, scale=0.1) if has_we else None,
      w1=_rand(gen, width, width, scale=s), b1=_rand(gen, width, scale=0.1),
      scale=_rand(gen, width, scale=0.1, offset=1.0),
      offset=_rand(gen, width, scale=0.1),
      write_edges=mode in ("processor", "nowe_write"))
  if embed:
    args["embed_weights"] = (
        _rand(gen, F, width, scale=0.5), _rand(gen, width, scale=0.1),
        _rand(gen, width, width, scale=s), _rand(gen, width, scale=0.1))
  d_eout = (_rand(gen, E, width, dtype=bf16) if args["write_edges"]
            else None)
  d_agg = _rand(gen, n, width)
  return (senders, receivers, ns, n), args, d_eout, d_agg


def _to(device, v):
  if isinstance(v, tuple):
    return tuple(_to(device, t) for t in v)
  return v.to(device) if torch.is_tensor(v) else v


@pytest.mark.cuda
@pytest.mark.parametrize("E,width,mode", _EDGE_SHAPES)
def test_fused_edge_kernel_at_edge_shapes_matches_twin(E, width, mode,
                                                       cuda_device):
  idx, args, _, _ = _edge_shape_case(21, E, width, mode)
  edges = EdgeIndex(*idx, device=cuda_device)
  args = {k: _to(cuda_device, v) for k, v in args.items()}
  before = fused_edge.launches, fused_edge.embed_launches
  with torch.inference_mode():
    got = fused_edge(edges, pipelined=False, **args)
    want = fused_edge_reference(edges, **args)
    again = fused_edge(edges, pipelined=False, **args)
  torch.cuda.synchronize()
  assert (fused_edge.launches - before[0],
          fused_edge.embed_launches - before[1]) == (2, 2 * (mode == "embed"))
  # The receiver sums at tile ends add in a fixed order: bit-equal reruns.
  for a, b in zip(*((got, again) if args["write_edges"]
                    else ((got,), (again,)))):
    assert torch.equal(a, b)
  if args["write_edges"]:
    assert got[0].shape == (E, width) and got[0].dtype == torch.bfloat16
    _assert_close(got[0], want[0])
    got, want = got[1], want[1]
  assert got.shape == (edges.num_receivers, width)
  _assert_close(got, want)


def _edge_backward(edges, args, d_eout, d_agg):
  """K4 through its wrapper on detached inputs: {name: gradient}."""
  a = {k: v for k, v in args.items() if k not in ("write_edges", "offset")}
  embed = a.pop("embed_weights", None)
  if embed is not None:
    *g, doff, (dew0, deb0, dew1, deb1) = fused_edge_embed_backward(
        edges, a["e"], a["sproj"], a["rproj"], a["we"], a["b0"], a["w1"],
        a["b1"], a["scale"], embed, d_agg)
    names = ["e", "sproj", "rproj", "we", "b0", "w1", "b1", "scale"]
    out = dict(zip(names, g))
    out.update(offset=doff, ew0=dew0, eb0=deb0, ew1=dew1, eb1=deb1)
    return out
  g = fused_edge_backward(edges, a["e"], a["sproj"], a["rproj"], a["we"],
                          a["b0"], a["w1"], a["b1"], a["scale"], d_eout,
                          d_agg)
  names = ["e", "sproj", "rproj", "we", "b0", "w1", "b1", "scale", "offset"]
  return {k: v for k, v in zip(names, g) if v is not None}


@pytest.mark.cuda
@pytest.mark.parametrize("E,width,mode", _EDGE_BWD_SHAPES)
def test_fused_edge_backward_at_edge_shapes_matches_twin_and_reruns_bit_equal(
    E, width, mode, cuda_device):
  """K4 against autograd of the twin; then a rerun bit-equal in every
  gradient (the receiver runs at tile ends, the sender sums and
  feature_grad all sum in a fixed order)."""
  idx, args, d_eout, d_agg = _edge_shape_case(22, E, width, mode)
  edges = EdgeIndex(*idx, device=cuda_device)
  args = {k: _to(cuda_device, v) for k, v in args.items()}
  d_agg = d_agg.to(cuda_device)
  d_eout = None if d_eout is None else d_eout.to(cuda_device)
  embed = args.pop("embed_weights", None)
  write = args.pop("write_edges")
  leaves = {k: v.requires_grad_() for k, v in args.items() if v is not None}
  if embed is not None:
    leaves.update(zip(("ew0", "eb0", "ew1", "eb1"),
                      (t.requires_grad_() for t in embed)))

  def run(fn):
    def call(ew0=None, eb0=None, ew1=None, eb1=None, **kw):
      ew = None if ew0 is None else (ew0, eb0, ew1, eb1)
      return fn(edges, write_edges=write, embed_weights=ew,
                **{k: kw.get(k) for k in ("e", "sproj", "rproj", "we", "b0",
                                          "w1", "b1", "scale", "offset")})
    return call

  cot = (d_agg,) if d_eout is None else (d_eout, d_agg)
  before = fused_edge_backward.launches
  got = _grads(run(fused_edge), leaves, cot)
  want = _grads(run(fused_edge_reference), leaves, cot)
  torch.cuda.synchronize()
  assert fused_edge_backward.launches == before + 1
  for name, g in got.items():
    assert g.dtype == leaves[name].dtype and g.shape == leaves[name].shape
  _assert_grads_close(got, want)
  det = {k: v.detach() for k, v in leaves.items()}
  det_args = {**{k: det.get(k) for k in args}, "write_edges": write}
  if embed is not None:
    det_args["embed_weights"] = tuple(det[k] for k in ("ew0", "eb0", "ew1",
                                                       "eb1"))
  runs = [_edge_backward(edges, det_args, d_eout, d_agg) for _ in range(2)]
  for k in runs[0]:
    assert torch.equal(runs[0][k], runs[1][k]), k


@pytest.mark.cuda
def test_edge_smem_layout_matches_kernels(cuda_device):
  import ctypes
  from graphcast_tpu_torch.native import build
  from graphcast_tpu_torch.ops import fused_edge as fe
  lib = build.load_library()
  keys = ("a", "e", "ring", "exchange", "idx", "sums", "colred", "bars",
          "stages", "total")
  for width in (128, 256, 384, 512):
    for backward, embed, write in ((False, False, False),
                                   (False, False, True), (True, False, False),
                                   (True, True, False)):
      want = fe.smem_layout(width, backward=backward, embed=embed,
                            write_edges=write)
      kinds = fe.BWD_SUMS["embed" if embed else "processor"]
      buf = (ctypes.c_int * len(keys))()
      lib.gc_edge_layout(kinds * fe.WIDTH if backward else 0, int(write), buf)
      assert dict(zip(keys, buf)) == want
  for staged in (False, True):
    buf = (ctypes.c_int * len(keys))()
    lib.gc_pipelined_layout(int(staged), buf)
    assert dict(zip(keys, buf)) == fe.pipelined_smem_layout(staged)


@pytest.mark.cuda
@pytest.mark.parametrize("sorted_index", [False, True])
def test_row_gather_sums_its_gradient_with_k3_and_reruns_bit_equal(
    sorted_index, cuda_device):
  """ops/gather.py: the gather of [N, B, C] rows onto edges, its backward
  (K3 over the index's sorted order, each row written once) against the
  f32 sum of the same rows, and a rerun bit-equal."""
  from graphcast_tpu_torch.ops.gather import RowGather
  from graphcast_tpu_torch.ops.segment_sum import sorted_segment_sum
  rng = np.random.RandomState(3)
  index = rng.randint(0, 3000, size=40_000)
  if sorted_index:
    index = np.sort(index)
  gather = RowGather(index, 3500, cuda_device)
  gen = torch.Generator().manual_seed(4)
  table = _rand(gen, 3500, 2, C, dtype=torch.bfloat16).to(
      cuda_device).requires_grad_()
  cot = _rand(gen, index.size, 2, C, dtype=torch.bfloat16).to(cuda_device)
  out = gather(table)
  assert torch.equal(out, table.detach()[torch.as_tensor(
      index, device=cuda_device)])
  launches = sorted_segment_sum.launches
  grads = [torch.autograd.grad(gather(table), table, cot)[0]
           for _ in range(2)]
  assert sorted_segment_sum.launches == launches + 2
  assert torch.equal(grads[0], grads[1])
  want = torch.zeros(3500, 2, C, device=cuda_device)
  want.index_add_(0, torch.as_tensor(index, device=cuda_device), cot.float())
  _assert_close(grads[0], want.to(torch.bfloat16))


@pytest.mark.cuda
def test_training_form_gradients_rerun_bit_equal(cuda_device):
  """GraphCast in the 0.25° training form (processor remat, chunked
  encoder and decoder, models/graphcast.py) at latent 128 on the card:
  AR-2 loss and every gradient twice, bit-equal, with and without the host
  offloads of the carries; and the fused form with remat equal to it
  without."""
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import configs
  from graphcast_tpu_torch.models.graphcast import GraphCast
  from graphcast_tpu_torch.wrappers import (
      Autoregressive, Bfloat16Cast, InputsAndResiduals)
  task = configs.TaskConfig(
      input_variables=("2m_temperature", "temperature",
                       "toa_incident_solar_radiation", "land_sea_mask"),
      target_variables=("2m_temperature", "temperature"),
      forcing_variables=("toa_incident_solar_radiation",),
      pressure_levels=(500, 850), input_duration="12h")
  mc = configs.ModelConfig(resolution=5.0, mesh_size=3, latent_size=128,
                           gnn_msg_steps=4)
  data = [fs.astype(torch.bfloat16) for fs in synthetic.make_example_batch(
      task, 5.0, num_target_times=2, device=cuda_device)]
  stats = synthetic.make_norm_stats(task, device=cuda_device)
  training = dict(fused_aggregation="processor", remat_processor=True,
                  encode_chunks=5, decode_chunks=6)

  def grads(model_kw, **ar_kw):
    model = GraphCast(mc, task, **model_kw,
                      generator=torch.Generator().manual_seed(0),
                      device=cuda_device)
    stack = Autoregressive(InputsAndResiduals(Bfloat16Cast(model), *stats),
                           gradient_checkpointing=True, **ar_kw)
    loss = stack.loss(*data)[0].mean()
    loss.backward()
    return [loss.detach()] + [p.grad for p in model.parameters()
                              if p.grad is not None]

  offload = dict(loss_carry_offload=True, loss_offload_processor_carries=True)
  runs = [grads(training), grads(training), grads(training, **offload),
          grads({}), grads({"remat_processor": True})]
  for a, b in ((0, 1), (0, 2), (3, 4)):
    assert all(torch.equal(x, y) for x, y in zip(runs[a], runs[b])), (a, b)


def _rerun_bit_equal(run):
  """Runs ``run`` twice ({name: tensor} each) with torch's deterministic
  algorithms off: every tensor equal bit for bit."""
  assert not torch.are_deterministic_algorithms_enabled()
  first, second = run(), run()
  assert first.keys() == second.keys()
  differ = [k for k in first if not torch.equal(first[k], second[k])]
  assert not differ, differ[:5]


@pytest.mark.cuda
def test_general_path_gencast_evaluation_reruns_bit_equal(cuda_device):
  """GenCast Mini's denoiser (its transformer cut to 2 layers) at batch 2,
  the general path (K3 sums, RowGather gathers): one preconditioned
  evaluation and the gradient of its outputs' sum for every parameter,
  twice."""
  import dataclasses
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  preset = zoo.gencast_mini()
  arch = preset.denoiser_architecture_config
  preset = dataclasses.replace(preset, denoiser_architecture_config=(
      dataclasses.replace(arch, sparse_transformer_config=dataclasses.replace(
          arch.sparse_transformer_config, num_layers=2))))
  model = preset.build(generator=torch.Generator().manual_seed(0),
                       device=cuda_device)
  inputs, targets, forcings = (
      fs.astype(torch.bfloat16) for fs in synthetic.make_example_batch(
          preset.task_config, preset.resolution, batch=2,
          time_step_hours=12, device=cuda_device))
  levels = torch.tensor([80.0, 1.0], dtype=torch.bfloat16,
                        device=cuda_device)

  def run():
    model.zero_grad(set_to_none=True)
    out = model._preconditioned_denoiser(inputs, targets, levels, forcings)
    sum(out.data(n).float().sum() for n in out.var_names).backward()
    result = {n: out.data(n).detach().clone() for n in out.var_names}
    result.update({k: p.grad.clone() for k, p in model.named_parameters()
                   if p.grad is not None})
    return result

  _rerun_bit_equal(run)


@pytest.mark.cuda
def test_general_path_graphcast_small_train_step_reruns_bit_equal(
    cuda_device):
  """GraphCast_small at batch 2 through Autoregressive(InputsAndResiduals(
  Bfloat16Cast(GraphCast)), gradient_checkpointing=True), the general path:
  a train step's loss and every gradient, twice."""
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models import zoo
  from graphcast_tpu_torch.models.graphcast import GraphCast
  from graphcast_tpu_torch.wrappers import (
      Autoregressive, Bfloat16Cast, InputsAndResiduals)
  preset = zoo.graphcast_small()
  model = GraphCast(preset.model_config, preset.task_config,
                    generator=torch.Generator().manual_seed(0),
                    device=cuda_device)
  stack = Autoregressive(InputsAndResiduals(
      Bfloat16Cast(model), *synthetic.make_norm_stats(
          preset.task_config, device=cuda_device)),
                         gradient_checkpointing=True)
  data = [fs.astype(torch.bfloat16) for fs in synthetic.make_example_batch(
      preset.task_config, preset.model_config.resolution, batch=2,
      device=cuda_device)]

  def run():
    model.zero_grad(set_to_none=True)
    loss = stack.loss(*data)[0].mean()
    loss.backward()
    return {"loss": loss.detach(),
            **{k: p.grad.clone() for k, p in model.named_parameters()
               if p.grad is not None}}

  _rerun_bit_equal(run)


def _hidden_layers_2_small():
  """zoo.graphcast_small() at hidden_layers=2, its processor cut to 2
  steps for the CPU side's sake: the general path on the card (the fused
  kernels compute one hidden layer)."""
  import dataclasses
  from graphcast_tpu_torch.models import zoo
  preset = zoo.graphcast_small()
  return preset, dataclasses.replace(preset.model_config, hidden_layers=2,
                                     gnn_msg_steps=2)


def _hidden_layers_2_stack(mc, task, device, bf16=True):
  from graphcast_tpu_torch.data import synthetic
  from graphcast_tpu_torch.models.graphcast import GraphCast
  from graphcast_tpu_torch.wrappers import (
      Autoregressive, Bfloat16Cast, InputsAndResiduals)
  model = GraphCast(mc, task, generator=torch.Generator().manual_seed(0),
                    device=device)
  return model, Autoregressive(
      InputsAndResiduals(Bfloat16Cast(model, enabled=bf16),
                         *synthetic.make_norm_stats(task, device=device)),
      gradient_checkpointing=True)


def _assert_within_noise_floor(got, cpu_f32, cpu_bf16):
  """Per tensor: rms(card bf16 - cpu f32) <= 2 rms(cpu bf16 - cpu f32) +
  1e-4 rms(cpu f32) (chip_smoke.py's rule for the small phases)."""
  for k, f32 in cpu_f32.items():
    f32 = f32.double()
    floor = (cpu_bf16[k].double() - f32).square().mean().sqrt()
    err = (got[k].cpu().double() - f32).square().mean().sqrt()
    bound = 2 * floor + 1e-4 * f32.square().mean().sqrt()
    assert torch.isfinite(err) and err <= bound, (k, err.item(),
                                                  bound.item())


@pytest.mark.cuda
def test_hidden_layers_2_graphcast_small_step_matches_cpu_and_reruns(
    cuda_device):
  """One rollout step of GraphCast_small at hidden_layers=2 on the card
  against the port on the CPU within the bf16 noise floor, and a rerun on
  the card bit-equal."""
  from graphcast_tpu_torch.data import synthetic
  preset, mc = _hidden_layers_2_small()
  task = preset.task_config
  data = synthetic.make_example_batch(task, mc.resolution, device="cpu")

  def step(device, bf16=True):
    _, stack = _hidden_layers_2_stack(mc, task, device, bf16)
    batch = [fs.to(device) for fs in data]
    with torch.inference_mode():
      out = stack.rollout_final(*batch)
    return {n: out.data(n).float().cpu() for n in out.var_names}

  card = step(cuda_device)
  _assert_within_noise_floor(card, step("cpu", bf16=False), step("cpu"))
  _rerun_bit_equal(lambda: step(cuda_device))


@pytest.mark.cuda
def test_hidden_layers_2_graphcast_small_train_step_matches_cpu_and_reruns(
    cuda_device):
  """The AR-1 loss and every parameter gradient of GraphCast_small at
  hidden_layers=2 on the card against the port on the CPU within the bf16
  noise floor, and a rerun on the card bit-equal."""
  from graphcast_tpu_torch.data import synthetic
  preset, mc = _hidden_layers_2_small()
  task = preset.task_config
  data = synthetic.make_example_batch(task, mc.resolution, device="cpu")

  def grads(device, bf16=True):
    model, stack = _hidden_layers_2_stack(mc, task, device, bf16)
    loss = stack.loss(*[fs.to(device) for fs in data])[0].mean()
    loss.backward()
    return {"loss": loss.detach().float().cpu().reshape(1),
            **{k: p.grad.float().cpu() for k, p in model.named_parameters()
               if p.grad is not None}}

  card = grads(cuda_device)
  _assert_within_noise_floor(card, grads("cpu", bf16=False), grads("cpu"))
  _rerun_bit_equal(lambda: grads(cuda_device))


@pytest.mark.cuda
def test_k2_in_two_processes_on_one_card_is_bit_equal_to_one(cuda_device,
                                                             tmp_path):
  """Two processes that time-share the card launch K2 back to back for a
  few seconds (graphcast_tpu_torch/tools/shared_card_study.py hammer, as
  chip_smoke.py's shared_card phase does): neither faults, each launches
  K2 on every call, and each one's last output equals one call's in this
  process bit for bit."""
  from graphcast_tpu_torch.parallel import launch
  from graphcast_tpu_torch.tools import shared_card_study as study
  plan = (("k2", 4.0),)
  launch.spawn(study.hammer, 2, args=(str(tmp_path), plan),
               device="cuda", init_method=f"file://{tmp_path}/rendezvous",
               timeout_s=300)
  reports = study.collect(str(tmp_path), 2, study.reference(plan))
  for r in reports:
    k2 = r["kernels"]["k2"]
    assert k2["launches"] == k2["calls"] > 1, k2
