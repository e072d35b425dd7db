"""K1's plain-PyTorch twin (ops/fused_edge.py) against the JAX package's
FusedEdgeStep, run as its own tests run it on the CPU (Pallas interpret
mode) and through its ``_reference_math``, in processor, encoder and embed
mode; with ``pipelined`` on both sides too (the JAX package's
``_fused_edge_pipelined_kernel``, K1p; on the CPU the port runs the same
twin, which K1p must match as K1 does).

Inputs are made with numpy from a seed and fed to both. The JAX step works
on the chunk-aligned padded layout; the port on the receiver-sorted edge
list as is, so outputs are compared on the original edge order.

Tolerances: f32 1e-4 (only the f32 summation order differs); bf16: relative
RMS <= 1e-2 and max-abs <= 0.1, since the twin evaluates swish in f32 of the
bf16-rounded input where the TPU kernel chains bf16 operations, which moves
an output by about one bf16 ulp.

Gradients: the twin under torch autograd against ``jax.vjp`` of the step
with ``fused_backward=True`` (the Pallas backward kernel, interpret mode),
with the same seeded cotangents; the JAX side differentiates through
``pad_edges(sproj[senders])`` and the node padding, so every input's
gradient is compared in the original layout. f32: rtol 1e-4 plus atol 1e-4
of the gradient's largest element (summation order only). bf16: relative
RMS <= 2e-2 per gradient: the TPU kernel rounds dy and dx0 to bf16 and
evaluates swish' in bf16, autograd of the twin rounds the cotangents at the
twin's casts instead, so elements differ by a few bf16 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_tpu.ops import pallas_edge, pallas_mp
from graphcast_tpu_torch.ops.fused_edge import (
    EdgeIndex, fused_edge, fused_edge_reference)

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(seed, encoder, n=96, e=600, c=128, num_senders=150):
  rng = np.random.RandomState(seed)
  receivers = np.sort(rng.randint(0, n, e))
  receivers[:n] = np.arange(n)  # no empty node block (TPU layout needs it)
  receivers = np.sort(receivers).astype(np.int32)
  senders = rng.randint(0, num_senders if encoder else n, e).astype(np.int32)
  arrays = dict(
      e=rng.randn(e, c).astype(np.float32),
      sproj=rng.randn(num_senders if encoder else n, c).astype(np.float32),
      rproj=rng.randn(n, c).astype(np.float32),
      w1=(rng.randn(c, c) * 0.05).astype(np.float32),
      b1=(rng.randn(c) * 0.1).astype(np.float32),
      scale=(1.0 + 0.1 * rng.randn(c)).astype(np.float32),
      offset=(0.1 * rng.randn(c)).astype(np.float32))
  if not encoder:
    arrays["we"] = (rng.randn(c, c) * 0.05).astype(np.float32)
    arrays["b0"] = (rng.randn(c) * 0.1).astype(np.float32)
  return senders, receivers, arrays


def _jax_step(senders, receivers, a, encoder, dtype, pipelined):
  """FusedEdgeStep (interpret) and its _reference_math, mapped back to the
  original edge order: ((e_out or None, agg) kernel, (...) reference)."""
  n = a["rproj"].shape[0]
  summer = pallas_mp.BlockedSegmentSum(
      receivers, n, block_nodes=32, chunk_edges=64, interpret=True,
      padded_input=True)
  step = pallas_edge.FusedEdgeStep(
      summer, interpret=True, include_edge_matmul=not encoder,
      write_edges=not encoder, pipelined=pipelined)
  e_pad = jnp.asarray(summer.pad_edges(a["e"]), dtype)
  gs = jnp.asarray(summer.pad_edges(a["sproj"][senders]), dtype)
  gr_pad = step.pad_nodes(jnp.asarray(a["rproj"], dtype))
  w = {k: jnp.asarray(a[k]) for k in ("w1", "b1", "scale", "offset")}
  we = None if encoder else jnp.asarray(a["we"])
  b0 = None if encoder else jnp.asarray(a["b0"])
  valid = summer.layout_index < summer.num_edges

  def unpad(out):
    if encoder:
      return None, np.asarray(out, np.float32)
    eout_pad, agg = out
    eout = np.zeros(a["e"].shape, np.float32)
    eout[summer.layout_index[valid]] = np.asarray(eout_pad, np.float32)[valid]
    return eout, np.asarray(agg, np.float32)

  kernel = step(e_pad, gs, gr_pad, we, b0, w["w1"], w["b1"], w["scale"],
                w["offset"])
  if encoder:
    we, b0 = jnp.zeros((0,)), jnp.zeros((0,))
  ref = step._reference_math(e_pad, gs, gr_pad, we, b0, w["w1"], w["b1"],
                             w["scale"], w["offset"])
  return unpad(kernel), unpad(ref)


def _port(senders, receivers, a, encoder, dtype, pipelined):
  n = a["rproj"].shape[0]
  edges = EdgeIndex(senders, receivers, a["sproj"].shape[0], n)
  t = {k: torch.from_numpy(v) for k, v in a.items()}
  for k in ("e", "sproj", "rproj"):
    t[k] = t[k].to(dtype)
  out = fused_edge(edges, t["e"], t["sproj"], t["rproj"], t.get("we"),
                   t.get("b0"), t["w1"], t["b1"], t["scale"], t["offset"],
                   write_edges=not encoder, pipelined=pipelined)
  if encoder:
    return None, out.numpy()
  return out[0].float().numpy(), out[1].numpy()


def _assert_close(got, want, dtype_name, atol=0.1):
  if dtype_name == "f32":
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    return
  d = got - want
  rel_rms = np.sqrt(np.mean(d * d)) / np.sqrt(np.mean(want * want))
  assert rel_rms <= 1e-2, rel_rms
  assert np.abs(d).max() <= atol, np.abs(d).max()


def _check_forward(mode, dtype_name, pipelined, c=128, atol=0.1):
  encoder = mode == "encoder"
  jdtype, tdtype = _DTYPES[dtype_name]
  senders, receivers, a = _case(seed=7 if encoder else 3, encoder=encoder,
                                c=c)
  (k_eout, k_agg), (r_eout, r_agg) = _jax_step(senders, receivers, a,
                                               encoder, jdtype, pipelined)
  eout, agg = _port(senders, receivers, a, encoder, tdtype, pipelined)
  assert agg.dtype == np.float32 and agg.shape == k_agg.shape
  for want in (k_agg, r_agg):
    _assert_close(agg, want, dtype_name, atol)
  if not encoder:
    for want in (k_eout, r_eout):
      _assert_close(eout, want, dtype_name, atol)


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("dtype_name", sorted(_DTYPES))
@pytest.mark.parametrize("mode", ["processor", "encoder"])
def test_twin_matches_jax_fused_edge_step(mode, dtype_name, pipelined):
  _check_forward(mode, dtype_name, pipelined)


def test_twin_sums_only_edges_of_each_receiver():
  """A receiver with no incoming edges aggregates to exactly 0, and the
  sum is over bf16-rounded rows (the TPU kernel's aggregation input)."""
  senders = np.array([0, 1, 1, 0], np.int32)
  receivers = np.array([0, 0, 2, 2], np.int32)
  rng = np.random.RandomState(0)
  c = 8
  edges = EdgeIndex(senders, receivers, 2, 4)
  t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa
  args = dict(e=t(4, c).bfloat16(), sproj=t(2, c).bfloat16(),
              rproj=t(4, c).bfloat16(), we=t(c, c), b0=t(c), w1=t(c, c),
              b1=t(c), scale=t(c), offset=t(c))
  eout, agg = fused_edge(edges, write_edges=True, **args)
  assert (agg[1] == 0).all() and (agg[3] == 0).all()
  y = eout.float() - args["e"].float()  # ~ y up to bf16 rounding of e'
  assert torch.allclose(agg[0], y[0] + y[1], atol=0.1)
  want = fused_edge_reference(edges, write_edges=False, **args)
  assert torch.equal(agg, want)


def test_edge_index_rejects_unsorted_or_out_of_range():
  with pytest.raises(ValueError, match="sorted"):
    EdgeIndex(np.array([0, 1]), np.array([1, 0]), 2, 2)
  with pytest.raises(ValueError, match="range"):
    EdgeIndex(np.array([0, 2]), np.array([0, 1]), 2, 2)
  with pytest.raises(ValueError, match="range"):
    EdgeIndex(np.array([0, 1]), np.array([0, 2]), 2, 2)


def test_non_cpu_non_cuda_tensors_are_refused():
  """No silent fallback: only CPU tensors take the twin."""
  edges = EdgeIndex(np.array([0]), np.array([0]), 1, 1)
  m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
  with pytest.raises(ValueError, match="unsupported device"):
    fused_edge(edges, m(1, 128), m(1, 128), m(1, 128), m(128, 128), m(128),
               m(128, 128), m(128), m(128), m(128))


_GRAD_NAMES = ("e", "sproj", "rproj", "we", "b0", "w1", "b1", "scale",
               "offset")


def _jax_grads(senders, receivers, a, cot, encoder, dtype, pipelined):
  """jax.vjp of FusedEdgeStep (fused backward kernel, interpret mode) in
  the original edge order."""
  n = a["rproj"].shape[0]
  E = a["e"].shape[0]
  summer = pallas_mp.BlockedSegmentSum(
      receivers, n, block_nodes=32, chunk_edges=64, interpret=True,
      padded_input=True)
  step = pallas_edge.FusedEdgeStep(
      summer, interpret=True, include_edge_matmul=not encoder,
      write_edges=not encoder, fused_backward=True, pipelined=pipelined)
  valid = summer.layout_index < summer.num_edges
  slot = np.where(valid, summer.layout_index, E)   # pad slots → zero row
  pos = np.zeros(E, np.int64)
  pos[summer.layout_index[valid]] = np.nonzero(valid)[0]

  def pad(x):
    return jnp.concatenate([x, jnp.zeros((1, x.shape[1]), x.dtype)])[slot]

  names = [k for k in _GRAD_NAMES if k in a]

  def fn(*args):
    t = dict(zip(names, args))
    out = step(pad(t["e"]), pad(t["sproj"][senders]),
               step.pad_nodes(t["rproj"]), t.get("we"), t.get("b0"),
               t["w1"], t["b1"], t["scale"], t["offset"])
    if encoder:
      return out
    return out[0][pos], out[1]

  act = ("e", "sproj", "rproj") + (("we",) if not encoder else ())
  args = [jnp.asarray(a[k], dtype if k in act else jnp.float32)
          for k in names]
  _, vjp = jax.vjp(fn, *args)
  cot_j = (jnp.asarray(cot[0], jnp.float32) if encoder else
           (jnp.asarray(cot[0], dtype), jnp.asarray(cot[1], jnp.float32)))
  return {k: np.asarray(g, np.float32) for k, g in zip(names, vjp(cot_j))}


def _port_grads(senders, receivers, a, cot, encoder, dtype, pipelined):
  n = a["rproj"].shape[0]
  edges = EdgeIndex(senders, receivers, a["sproj"].shape[0], n)
  act = ("e", "sproj", "rproj") + (("we",) if not encoder else ())
  t = {k: torch.tensor(v, dtype=dtype if k in act else torch.float32,
                       requires_grad=True) for k, v in a.items()}
  out = fused_edge(edges, t["e"], t["sproj"], t["rproj"], t.get("we"),
                   t.get("b0"), t["w1"], t["b1"], t["scale"], t["offset"],
                   write_edges=not encoder, pipelined=pipelined)
  outs = (out,) if encoder else out
  cots = ((torch.from_numpy(cot[0]),) if encoder else
          (torch.from_numpy(cot[0]).to(dtype), torch.from_numpy(cot[1])))
  names = [k for k in _GRAD_NAMES if k in t]
  grads = torch.autograd.grad(outs, [t[k] for k in names], cots)
  for k, g in zip(names, grads):
    assert g.dtype == t[k].dtype and g.shape == t[k].shape, k
  return {k: g.float().numpy() for k, g in zip(names, grads)}


def _assert_grads_close(got, want, dtype_name):
  for name in want:
    g, w = got[name], want[name]
    if dtype_name == "f32":
      np.testing.assert_allclose(g, w, rtol=1e-4,
                                 atol=1e-4 * np.abs(w).max(), err_msg=name)
    else:
      rel = np.sqrt(np.mean((g - w) ** 2) / np.mean(w * w))
      assert rel <= 2e-2, (name, rel)


def _check_grads(mode, dtype_name, pipelined, c=128):
  encoder = mode == "encoder"
  jdtype, tdtype = _DTYPES[dtype_name]
  senders, receivers, a = _case(seed=11 if encoder else 13, encoder=encoder,
                                c=c)
  rng = np.random.RandomState(17)
  d_agg = rng.randn(a["rproj"].shape[0], a["e"].shape[1]).astype(np.float32)
  cot = (d_agg,) if encoder else (
      rng.randn(*a["e"].shape).astype(np.float32), d_agg)
  want = _jax_grads(senders, receivers, a, cot, encoder, jdtype, pipelined)
  got = _port_grads(senders, receivers, a, cot, encoder, tdtype, pipelined)
  assert set(got) == set(want) == (
      set(_GRAD_NAMES) - ({"we", "b0"} if encoder else set()))
  _assert_grads_close(got, want, dtype_name)


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("dtype_name", sorted(_DTYPES))
@pytest.mark.parametrize("mode", ["processor", "encoder"])
def test_twin_grads_match_jax_fused_backward(mode, dtype_name, pipelined):
  _check_grads(mode, dtype_name, pipelined)


def _embed_case(seed, n=96, e=600, c=128, num_senders=150, f=4):
  """Embed mode's operands (GenCast's grid2mesh): raw [E, F] features, the
  embed MLP, and the edge matmul whose We/b0 fold the conditioning."""
  senders, receivers, a = _case(seed, encoder=True, n=n, e=e, c=c,
                                num_senders=num_senders)
  rng = np.random.RandomState(seed + 100)
  a["e"] = rng.randn(e, f).astype(np.float32)
  a["we"] = (rng.randn(c, c) * 0.05).astype(np.float32)
  a["b0"] = (rng.randn(c) * 0.1).astype(np.float32)
  a["ew0"] = rng.randn(f, c).astype(np.float32)
  a["eb0"] = (rng.randn(c) * 0.1).astype(np.float32)
  a["ew1"] = (rng.randn(c, c) / np.sqrt(c)).astype(np.float32)
  a["eb1"] = (rng.randn(c) * 0.1).astype(np.float32)
  return senders, receivers, a


_EMBED = ("ew0", "eb0", "ew1", "eb1")


def _check_embed_forward(dtype_name, pipelined, c=128, atol=0.1):
  jdtype, tdtype = _DTYPES[dtype_name]
  senders, receivers, a = _embed_case(seed=21, c=c)
  n = a["rproj"].shape[0]
  summer = pallas_mp.BlockedSegmentSum(
      receivers, n, block_nodes=32, chunk_edges=64, interpret=True,
      padded_input=True)
  step = pallas_edge.FusedEdgeStep(summer, interpret=True,
                                   include_edge_matmul=True,
                                   write_edges=False, pipelined=pipelined)
  e_pad = jnp.asarray(summer.pad_edges(a["e"]), jdtype)
  gs = jnp.asarray(summer.pad_edges(a["sproj"][senders]), jdtype)
  gr_pad = step.pad_nodes(jnp.asarray(a["rproj"], jdtype))
  w = {k: jnp.asarray(a[k]) for k in ("we", "b0", "w1", "b1", "scale",
                                      "offset")}
  embed = tuple(jnp.asarray(a[k]) for k in _EMBED)
  args = (e_pad, gs, gr_pad, w["we"], w["b0"], w["w1"], w["b1"], w["scale"],
          w["offset"])
  want = {"kernel": step(*args, embed_weights=embed),
          "reference": step._reference_math(*args, embed_weights=embed)}

  edges = EdgeIndex(senders, receivers, a["sproj"].shape[0], n)
  t = {k: torch.from_numpy(v) for k, v in a.items()}
  agg = fused_edge(edges, t["e"].to(tdtype), t["sproj"].to(tdtype),
                   t["rproj"].to(tdtype), t["we"].to(tdtype), t["b0"],
                   t["w1"], t["b1"], t["scale"], t["offset"],
                   write_edges=False,
                   embed_weights=tuple(t[k] for k in _EMBED),
                   pipelined=pipelined)
  assert agg.dtype == torch.float32 and agg.shape == (n, a["w1"].shape[1])
  for name, want_agg in want.items():
    _assert_close(agg.numpy(), np.asarray(want_agg, np.float32), dtype_name,
                  atol)


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("dtype_name", sorted(_DTYPES))
def test_embed_mode_twin_matches_jax_fused_edge_step(dtype_name, pipelined):
  """Embed mode, aggregation only: FusedEdgeStep(embed_weights=...) in
  interpret mode and its _reference_math."""
  _check_embed_forward(dtype_name, pipelined)


def test_embed_mode_needs_the_edge_matmul():
  """As in the JAX package (pallas_edge.py:625): embed requires We/b0."""
  senders, receivers, a = _embed_case(seed=23, n=8, e=20, c=8,
                                      num_senders=10)
  edges = EdgeIndex(senders, receivers, 10, 8)
  t = {k: torch.from_numpy(v) for k, v in a.items()}
  with pytest.raises(ValueError, match="requires the edge matmul"):
    fused_edge(edges, t["e"], t["sproj"], t["rproj"], None, None, t["w1"],
               t["b1"], t["scale"], t["offset"], write_edges=False,
               embed_weights=tuple(t[k] for k in _EMBED))


_EMBED_GRAD_NAMES = _GRAD_NAMES + _EMBED


def _check_embed_grads(dtype_name, pipelined, c=128):
  jdtype, tdtype = _DTYPES[dtype_name]
  senders, receivers, a = _embed_case(seed=25, c=c)
  n = a["rproj"].shape[0]
  E = a["e"].shape[0]
  d_agg = np.random.RandomState(26).randn(
      n, a["w1"].shape[1]).astype(np.float32)
  summer = pallas_mp.BlockedSegmentSum(
      receivers, n, block_nodes=32, chunk_edges=64, interpret=True,
      padded_input=True)
  step = pallas_edge.FusedEdgeStep(
      summer, interpret=True, include_edge_matmul=True, write_edges=False,
      fused_backward=True, pipelined=pipelined)
  valid = summer.layout_index < summer.num_edges
  slot = np.where(valid, summer.layout_index, E)

  def pad(x):
    return jnp.concatenate([x, jnp.zeros((1, x.shape[1]), x.dtype)])[slot]

  def fn(*args):
    t = dict(zip(_EMBED_GRAD_NAMES, args))
    return step(pad(t["e"]), pad(t["sproj"][senders]),
                step.pad_nodes(t["rproj"]), t["we"], t["b0"], t["w1"],
                t["b1"], t["scale"], t["offset"],
                embed_weights=tuple(t[k] for k in _EMBED))

  act = ("e", "sproj", "rproj", "we")
  args = [jnp.asarray(a[k], jdtype if k in act else jnp.float32)
          for k in _EMBED_GRAD_NAMES]
  _, vjp = jax.vjp(fn, *args)
  want = {k: np.asarray(g, np.float32) for k, g in zip(
      _EMBED_GRAD_NAMES, vjp(jnp.asarray(d_agg, jnp.float32)))}

  edges = EdgeIndex(senders, receivers, a["sproj"].shape[0], n)
  t = {k: torch.tensor(a[k], dtype=tdtype if k in act else torch.float32,
                       requires_grad=True) for k in _EMBED_GRAD_NAMES}
  agg = fused_edge(edges, t["e"], t["sproj"], t["rproj"], t["we"], t["b0"],
                   t["w1"], t["b1"], t["scale"], t["offset"],
                   write_edges=False,
                   embed_weights=tuple(t[k] for k in _EMBED),
                   pipelined=pipelined)
  grads = torch.autograd.grad(agg, [t[k] for k in _EMBED_GRAD_NAMES],
                              torch.from_numpy(d_agg))
  for name, g in zip(_EMBED_GRAD_NAMES, grads):
    assert g.dtype == t[name].dtype and g.shape == t[name].shape, name
  _assert_grads_close({k: g.float().numpy() for k, g in zip(
      _EMBED_GRAD_NAMES, grads)}, want, dtype_name)


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("dtype_name", sorted(_DTYPES))
def test_embed_mode_twin_grads_match_jax_fused_backward(dtype_name,
                                                        pipelined):
  """Embed mode's gradients (K4's embed mode in the JAX package): the twin
  under autograd against jax.vjp of FusedEdgeStep(embed_weights=...) with
  ``fused_backward=True``, for every input: the raw features, the node
  projections, We', b0', the step's weights and the embed MLP's."""
  _check_embed_grads(dtype_name, pipelined)


@pytest.mark.parametrize("dtype_name", sorted(_DTYPES))
@pytest.mark.parametrize("kind", ["forward", "grads"])
@pytest.mark.parametrize("mode", ["processor", "encoder", "embed"])
def test_pipelined_twin_at_latent_384_matches_jax(mode, kind, dtype_name):
  """K1p's width 384 (the kernel takes every multiple of 128 up to 512, as
  K1 and the JAX package's pipelined kernel do): the twin with
  ``pipelined=True`` against FusedEdgeStep(pipelined=True) in interpret
  mode, its output and every input's gradient, each mode. The module's
  tolerances, but a bf16 output's max-abs error up to 0.125: one bf16 ulp
  of the largest outputs here (the embed mode's sums reach 30, where an
  ulp is 0.125), which a single rounding flip between the two sides'
  bf16 paths moves."""
  if kind == "forward":
    if mode == "embed":
      _check_embed_forward(dtype_name, True, c=384, atol=0.125)
    else:
      _check_forward(mode, dtype_name, True, c=384, atol=0.125)
  elif mode == "embed":
    _check_embed_grads(dtype_name, True, c=384)
  else:
    _check_grads(mode, dtype_name, True, c=384)

