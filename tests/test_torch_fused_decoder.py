"""K2's plain-PyTorch twin (ops/fused_decoder.py) against the JAX package's
FusedMesh2GridDecoder in Pallas interpret mode and its ``_reference_math``.

Inputs are made with numpy from a seed and fed to both; the JAX decoder
takes the hoisted const slot-major and the output weights padded, the port
takes both in the edge list's own order, unpadded.

Tolerances: f32 1e-4; bf16 relative RMS <= 1e-2 and max-abs <= 0.1 (the
twin's swish runs in f32 of the bf16-rounded input, the TPU kernel's in
chained bf16 operations: about one bf16 ulp on an output).

Gradients: the twin under torch autograd against ``jax.vjp`` of the decoder
with ``fused_backward=True`` (the Pallas backward kernel, interpret mode),
same seeded cotangent; the JAX side differentiates through the slot-major
re-layout of ``const`` and the output padding. f32: rtol 1e-4 plus atol
1e-4 of the gradient's largest element. bf16: relative RMS <= 2e-2 per
gradient (the TPU kernel rounds each cotangent before its product and
evaluates swish' in bf16; autograd of the twin rounds at the twin's casts).
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_tpu.ops.pallas_decoder import FusedMesh2GridDecoder
from graphcast_tpu_torch.ops import fused_decoder
from graphcast_tpu_torch.ops.fused_decoder import (
    KEYS, MATRICES, VECTORS, fused_decode)
from graphcast_tpu_torch.ops.fused_edge import EdgeIndex

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(seed, G=40, M=30, C=128, num_outputs=7):
  rs = np.random.RandomState(seed)
  senders = rs.randint(0, M, size=3 * G).astype(np.int32)
  arrays = dict(grid=rs.randn(G, C), mesh_proj=rs.randn(M, C),
                const=rs.randn(3 * G, C))
  weights = {k: rs.randn(C, C) / np.sqrt(C) for k in MATRICES}
  weights["wd1"] = rs.randn(C, num_outputs) / np.sqrt(C)
  weights.update({k: 0.1 * rs.randn(C) for k in VECTORS})
  weights["bd1"] = 0.1 * rs.randn(num_outputs)
  for k in ("escale", "nscale"):
    weights[k] = weights[k] + 1.0
  f32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa
  return senders, f32(arrays), f32(weights)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("dtype_name", sorted(_DTYPES))
def test_twin_matches_jax_fused_decoder(dtype_name, compact):
  jdtype, tdtype = _DTYPES[dtype_name]
  senders, a, w = _case(seed=5 if compact else 2,
                        G=160 if compact else 40)
  G, C = a["grid"].shape
  num_outputs = w["wd1"].shape[1]
  dec = FusedMesh2GridDecoder(senders, G, num_outputs,
                              block_nodes=64 if compact else 8,
                              interpret=True, compact_gather=compact)
  jw = {k: jnp.asarray(v) for k, v in w.items()}
  jw["wd1"] = jnp.pad(jw["wd1"], ((0, 0), (0, dec.out_pad - num_outputs)))
  jw["bd1"] = jnp.pad(jw["bd1"], (0, dec.out_pad - num_outputs))
  grid = jnp.asarray(a["grid"], jdtype)
  mesh_proj = jnp.asarray(a["mesh_proj"], jdtype)
  const_slot = dec.rearrange_edge_array(jnp.asarray(a["const"], jdtype))
  kernel = np.asarray(dec(grid, mesh_proj, const_slot, jw), np.float32)
  ref = np.asarray(dec._reference_math(grid, mesh_proj, const_slot, jw),
                   np.float32)

  edges = EdgeIndex(senders, np.repeat(np.arange(G), 3), a["mesh_proj"].shape[0],
                    G)
  out = fused_decode(
      edges, torch.from_numpy(a["grid"]).to(tdtype),
      torch.from_numpy(a["mesh_proj"]).to(tdtype),
      torch.from_numpy(a["const"]).to(tdtype),
      {k: torch.from_numpy(v) for k, v in w.items()})
  assert out.dtype == tdtype and out.shape == (G, num_outputs)
  got = out.float().numpy()
  for want in (kernel, ref):
    if dtype_name == "f32":
      np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
      d = got - want
      assert np.sqrt(np.mean(d * d) / np.mean(want * want)) <= 1e-2
      assert np.abs(d).max() <= 0.1


def test_decoder_refuses_edge_lists_without_three_edges_per_node():
  senders, a, w = _case(seed=1, G=4)
  edges = EdgeIndex(senders[:-1], np.sort(np.arange(11) % 4), 30, 4)
  t = {k: torch.from_numpy(v) for k, v in a.items()}
  with pytest.raises(ValueError, match="3 receiver-sorted edges"):
    fused_decode(edges, t["grid"], t["mesh_proj"], t["const"][:-1],
                 {k: torch.from_numpy(v) for k, v in w.items()})


@pytest.mark.parametrize("dtype_name", sorted(_DTYPES))
def test_twin_grads_match_jax_fused_backward(dtype_name):
  jdtype, tdtype = _DTYPES[dtype_name]
  senders, a, w = _case(seed=9, G=48)
  G, C = a["grid"].shape
  num_outputs = w["wd1"].shape[1]
  dout = np.random.RandomState(19).randn(G, num_outputs).astype(np.float32)
  dec = FusedMesh2GridDecoder(senders, G, num_outputs, block_nodes=16,
                              interpret=True, compact_gather=False,
                              fused_backward=True)
  pad = dec.out_pad - num_outputs

  def fn(grid, mesh_proj, const, weights):
    weights = dict(weights)
    weights["wd1"] = jnp.pad(weights["wd1"], ((0, 0), (0, pad)))
    weights["bd1"] = jnp.pad(weights["bd1"], (0, pad))
    return dec(grid, mesh_proj, dec.rearrange_edge_array(const), weights)

  _, vjp = jax.vjp(fn, *(jnp.asarray(a[k], jdtype)
                         for k in ("grid", "mesh_proj", "const")),
                   {k: jnp.asarray(v) for k, v in w.items()})
  dgrid, dmesh, dconst, dw = vjp(jnp.asarray(dout, jdtype))
  want = {"grid": dgrid, "mesh_proj": dmesh, "const": dconst, **dw}
  want = {k: np.asarray(v, np.float32) for k, v in want.items()}

  t = {k: torch.tensor(a[k], dtype=tdtype, requires_grad=True)
       for k in ("grid", "mesh_proj", "const")}
  t.update({k: torch.tensor(v, requires_grad=True) for k, v in w.items()})
  edges = EdgeIndex(senders, np.repeat(np.arange(G), 3),
                    a["mesh_proj"].shape[0], G)
  out = fused_decode(edges, t["grid"], t["mesh_proj"], t["const"],
                     {k: t[k] for k in KEYS})
  names = ["grid", "mesh_proj", "const", *KEYS]
  grads = torch.autograd.grad(out, [t[k] for k in names],
                              torch.from_numpy(dout).to(tdtype))
  assert set(want) == set(names)
  for name, g in zip(names, grads):
    assert g.dtype == t[name].dtype and g.shape == t[name].shape, name
    g, wv = g.float().numpy(), want[name]
    if dtype_name == "f32":
      np.testing.assert_allclose(g, wv, rtol=1e-4,
                                 atol=1e-4 * np.abs(wv).max(), err_msg=name)
    else:
      rel = np.sqrt(np.mean((g - wv) ** 2) / np.mean(wv * wv))
      assert rel <= 2e-2, (name, rel)


@pytest.mark.parametrize("dtype_name", sorted(_DTYPES))
def test_embed_mode_twin_matches_jax_fused_decoder(dtype_name):
  """Embed mode (GenCast's mesh2grid): raw [3G, F] slot features through
  the embed MLP and We'/b0' inside the decoder, against
  FusedMesh2GridDecoder in interpret mode and its _reference_math."""
  jdtype, tdtype = _DTYPES[dtype_name]
  senders, a, w = _case(seed=31, G=40)
  G, C = a["grid"].shape
  rs = np.random.RandomState(32)
  F = 4
  a["const"] = rs.randn(3 * G, F).astype(np.float32)
  w.update(ew0=rs.randn(F, C), eb0=0.1 * rs.randn(C),
           ew1=rs.randn(C, C) / np.sqrt(C), eb1=0.1 * rs.randn(C),
           we=rs.randn(C, C) / np.sqrt(C), b0=0.1 * rs.randn(C))
  w = {k: v.astype(np.float32) for k, v in w.items()}
  num_outputs = w["wd1"].shape[1]
  dec = FusedMesh2GridDecoder(senders, G, num_outputs, block_nodes=8,
                              interpret=True, compact_gather=False)
  jw = {k: jnp.asarray(v) for k, v in w.items()}
  jw["wd1"] = jnp.pad(jw["wd1"], ((0, 0), (0, dec.out_pad - num_outputs)))
  jw["bd1"] = jnp.pad(jw["bd1"], (0, dec.out_pad - num_outputs))
  grid = jnp.asarray(a["grid"], jdtype)
  mesh_proj = jnp.asarray(a["mesh_proj"], jdtype)
  slot = dec.rearrange_edge_array(jnp.asarray(a["const"], jdtype))
  want = {"kernel": dec(grid, mesh_proj, slot, jw),
          "reference": dec._reference_math(grid, mesh_proj, slot, jw)}

  edges = EdgeIndex(senders, np.repeat(np.arange(G), 3), a["mesh_proj"].shape[0],
                    G)
  out = fused_decode(
      edges, torch.from_numpy(a["grid"]).to(tdtype),
      torch.from_numpy(a["mesh_proj"]).to(tdtype),
      torch.from_numpy(a["const"]).to(tdtype),
      {k: torch.from_numpy(v) for k, v in w.items()})
  assert out.dtype == tdtype and out.shape == (G, num_outputs)
  got = out.float().numpy()
  for name, wv in want.items():
    wv = np.asarray(wv, np.float32)
    if dtype_name == "f32":
      np.testing.assert_allclose(got, wv, rtol=1e-4, atol=1e-4, err_msg=name)
    else:
      d = got - wv
      assert np.sqrt(np.mean(d * d) / np.mean(wv * wv)) <= 1e-2, name
      assert np.abs(d).max() <= 0.1, name


@pytest.mark.parametrize("dtype_name", sorted(_DTYPES))
def test_embed_mode_twin_grads_match_jax_fused_backward(dtype_name):
  """Embed mode's gradients (K5's embed mode in the JAX package): the twin
  under autograd against jax.vjp of FusedMesh2GridDecoder with
  ``fused_backward=True`` on raw slot features, for the grid, the mesh
  projection, the raw features and all 27 weights."""
  from graphcast_tpu_torch.ops.fused_decoder import EMBED_KEYS
  jdtype, tdtype = _DTYPES[dtype_name]
  senders, a, w = _case(seed=33, G=48)
  G, C = a["grid"].shape
  rs = np.random.RandomState(34)
  F = 4
  a["const"] = rs.randn(3 * G, F).astype(np.float32)
  w.update(ew0=rs.randn(F, C), eb0=0.1 * rs.randn(C),
           ew1=rs.randn(C, C) / np.sqrt(C), eb1=0.1 * rs.randn(C),
           we=rs.randn(C, C) / np.sqrt(C), b0=0.1 * rs.randn(C))
  w = {k: v.astype(np.float32) for k, v in w.items()}
  num_outputs = w["wd1"].shape[1]
  dout = np.random.RandomState(35).randn(G, num_outputs).astype(np.float32)
  dec = FusedMesh2GridDecoder(senders, G, num_outputs, block_nodes=16,
                              interpret=True, compact_gather=False,
                              fused_backward=True)
  pad = dec.out_pad - num_outputs

  def fn(grid, mesh_proj, const, weights):
    weights = dict(weights)
    weights["wd1"] = jnp.pad(weights["wd1"], ((0, 0), (0, pad)))
    weights["bd1"] = jnp.pad(weights["bd1"], (0, pad))
    return dec(grid, mesh_proj, dec.rearrange_edge_array(const), weights)

  act = ("grid", "mesh_proj", "const")
  jw = {k: jnp.asarray(v, jdtype if k == "we" else jnp.float32)
        for k, v in w.items()}
  _, vjp = jax.vjp(fn, *(jnp.asarray(a[k], jdtype) for k in act), jw)
  dgrid, dmesh, dconst, dw = vjp(jnp.asarray(dout, jdtype))
  want = {"grid": dgrid, "mesh_proj": dmesh, "const": dconst, **dw}
  want = {k: np.asarray(v, np.float32) for k, v in want.items()}

  t = {k: torch.tensor(a[k], dtype=tdtype, requires_grad=True) for k in act}
  t.update({k: torch.tensor(v, dtype=tdtype if k == "we" else torch.float32,
                            requires_grad=True) for k, v in w.items()})
  edges = EdgeIndex(senders, np.repeat(np.arange(G), 3),
                    a["mesh_proj"].shape[0], G)
  keys = KEYS + EMBED_KEYS
  out = fused_decode(edges, t["grid"], t["mesh_proj"], t["const"],
                     {k: t[k] for k in keys})
  names = [*act, *keys]
  grads = torch.autograd.grad(out, [t[k] for k in names],
                              torch.from_numpy(dout).to(tdtype))
  assert set(want) == set(names)
  for name, g in zip(names, grads):
    assert g.dtype == t[name].dtype and g.shape == t[name].shape, name
    g, wv = g.float().numpy(), want[name]
    if dtype_name == "f32":
      np.testing.assert_allclose(g, wv, rtol=1e-4,
                                 atol=1e-4 * np.abs(wv).max(), err_msg=name)
    else:
      rel = np.sqrt(np.mean((g - wv) ** 2) / np.mean(wv * wv))
      assert rel <= 2e-2, (name, rel)


_CSRC = pathlib.Path(__file__).resolve().parents[1] / "graphcast_tpu_torch" / "csrc"


def _kernel_constants():
  """The ``constexpr int`` constants of csrc/decoder.cuh and
  csrc/fused_decoder_bwd.cu, evaluated in order (sums and products of
  integers and earlier constants), and the count of K5's column sums from
  its enum."""
  consts = {}
  for name in ("decoder.cuh", "fused_decoder_bwd.cu"):
    text = (_CSRC / name).read_text()
    for key, expr in re.findall(r"constexpr int (kDec\w+) = ([^;]+);", text):
      consts[key] = eval(expr, {"__builtins__": {}}, dict(consts))  # noqa
  enum = re.search(r"enum \{ (kSBd0[^}]*)\}", (_CSRC / "fused_decoder_bwd.cu")
                   .read_text()).group(1)
  names = [n.split("=")[0].strip() for n in enum.split(",")]
  consts["kDecSums"] = names.index("kDecSums")
  consts["kDecSumsEmbed"] = (consts["kDecSums"]
                             + names.index("kDecSumsEmbed")
                             - names.index("kSB0"))
  return consts


def test_layout_constants_match_kernels():
  k = _kernel_constants()
  assert (k["kDecWidth"], k["kDecRows"], k["kDecCluster"], k["kDecBox"],
          k["kDecSmemLimit"], k["kDecMaxStages"], k["kDecAlign"],
          k["kDecExchange"]) == (
              fused_decoder.WIDTH, fused_decoder.ROWS, fused_decoder.CLUSTER,
              fused_decoder.BOX, fused_decoder.SMEM_LIMIT,
              fused_decoder.MAX_STAGES, fused_decoder.ALIGN,
              fused_decoder.EXCHANGE)
  assert k["kDecWork"] == fused_decoder.BWD_WORK
  assert k["kDecSums"] == len(fused_decoder._BWD_SUMS)
  assert (k["kDecSumsEmbed"] - k["kDecSums"]
          == len(fused_decoder._BWD_SUMS_EMBED))
  # Each weight byte fetched from L2 serves a cluster's rows.
  assert k["kDecRows"] * k["kDecCluster"] >= 128


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("embed", [False, True])
@pytest.mark.parametrize("C", [128, 256, 384, 512])
def test_smem_layout_fits_every_width_the_wrapper_takes(C, embed, backward):
  """K2's and K5's block plan fits a block's 232,448 bytes at every latent
  width and output count the wrapper accepts (each width in the layout of
  the kernels' WIDTH), its swizzled tiles on 1024-byte boundaries, A wide
  enough for its widest operand, and a ring of at least 4 boxes."""
  W = fused_decoder.WIDTH
  assert C <= W
  for outputs in (1, 84, 127, 128, 227, 256, 383, 512):
    lay = fused_decoder.smem_layout(C, outputs, embed, backward)
    no_pad = -(-outputs // 128) * 128
    assert lay["total"] <= fused_decoder.SMEM_LIMIT, (outputs, lay)
    assert lay["stages"] >= 4, (outputs, lay)
    assert lay["g"] - lay["a"] == 64 * max(W, no_pad) * 2
    assert lay["ring"] - lay["g"] == 64 * W * 2
    assert lay["exchange"] - lay["ring"] == lay["stages"] * fused_decoder.BOX
    for key in ("a", "g", "ring"):
      assert lay[key] % 1024 == 0, key
    kinds = len(fused_decoder._BWD_SUMS) + (
        len(fused_decoder._BWD_SUMS_EMBED) if embed else 0)
    assert lay["colred"] - lay["sums"] == (
        4 * (kinds * W + no_pad) if backward else 0)
    order = [lay[k] for k in ("a", "g", "ring", "exchange", "sums", "colred",
                              "bars")]
    assert order == sorted(order)
    assert lay["bars"] % 8 == 0
    assert lay["total"] == (lay["bars"] + (2 * fused_decoder.MAX_STAGES + 2)
                            * 8 + fused_decoder.ALIGN)


def test_smem_layout_refuses_widths_the_kernels_do_not_take():
  for C, outputs in ((64, 10), (640, 10), (200, 10), (512, 513)):
    with pytest.raises(ValueError):
      fused_decoder.smem_layout(C, outputs)
