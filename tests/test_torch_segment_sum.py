"""K3's plain version (ops/segment_sum.py) against graphcast_tpu's
``BlockedSegmentSum`` in Pallas interpret mode, its work plan, its
gradient, and the plain reducers of ops/segment.py against
graphcast_tpu/ops/segment.py.

Receiver-sorted edge lists: random in-degrees, a skewed one (one receiver
with 500 edges, more than the kernel's 64-edge chunks), and one with empty
receivers (in the middle and at the end); messages [E, C] and [E, B, C].
Tolerances: f32 1e-5 (summation order only); bf16 one bf16 ulp of the f32
sum (both sum in f32 and round once, so only a different f32 order can
flip the last bit).

The kernel itself runs only on the card (tests/test_torch_cuda.py); its
plan is held here by an emulation of its two passes in numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_tpu.ops import pallas_mp
from graphcast_tpu.ops import segment as jax_segment
from graphcast_tpu_torch.ops import segment
from graphcast_tpu_torch.ops.fused_edge import EdgeIndex
from graphcast_tpu_torch.ops.segment_sum import (
    CHUNK_EDGES, segment_sum_reference, sender_segment_sum,
    sender_sum_reference, sorted_segment_sum)

NUM_NODES = 200


def _receivers(case: str) -> np.ndarray:
  rng = np.random.RandomState({"random": 0, "skewed": 1, "empty": 2}[case])
  degrees = rng.randint(0, 12, size=NUM_NODES)
  if case == "skewed":
    degrees[37] = 500
  if case == "empty":
    degrees[50:80] = 0
    degrees[-10:] = 0
  return np.repeat(np.arange(NUM_NODES), degrees).astype(np.int32)


def _edges(receivers: np.ndarray) -> EdgeIndex:
  senders = np.random.RandomState(3).randint(0, 50, size=receivers.size)
  return EdgeIndex(senders, receivers, 50, NUM_NODES)


def _messages(num_edges: int, shape: tuple, seed: int = 4) -> np.ndarray:
  return np.random.RandomState(seed).randn(num_edges, *shape).astype(
      np.float32)


def _jax_summer(receivers):
  return pallas_mp.BlockedSegmentSum(receivers, NUM_NODES, block_nodes=64,
                                     chunk_edges=128, interpret=True)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
  """One bf16 ulp at |x| (8 significant bits)."""
  mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
  return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("shape", [(16,), (3, 8)], ids=["2d", "batched"])
@pytest.mark.parametrize("case", ["random", "skewed", "empty"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_blocked_segment_sum(case, shape, dtype):
  receivers = _receivers(case)
  msgs = _messages(receivers.size, shape)
  jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
  want = np.asarray(_jax_summer(receivers)(jnp.asarray(msgs, jdtype)),
                    np.float32)
  tmsgs = torch.from_numpy(msgs).to(getattr(torch, dtype))
  got = sorted_segment_sum(_edges(receivers), tmsgs)
  assert got.dtype == tmsgs.dtype
  assert tuple(got.shape) == (NUM_NODES,) + shape
  got = got.float().numpy()
  if dtype == "float32":
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
  else:
    exact = np.zeros((NUM_NODES,) + shape)
    np.add.at(exact, receivers, tmsgs.float().double().numpy())
    assert (np.abs(got - want) <= _bf16_ulp(exact)).all()
  empty = np.setdiff1d(np.arange(NUM_NODES), receivers)
  assert not got[empty].any()


@pytest.mark.parametrize("shape", [(16,), (3, 8)], ids=["2d", "batched"])
def test_gradient_matches_jax_vjp(shape):
  receivers = _receivers("skewed")
  msgs = _messages(receivers.size, shape)
  cot = _messages(NUM_NODES, shape, seed=5)
  _, vjp = jax.vjp(_jax_summer(receivers), jnp.asarray(msgs))
  (want,) = vjp(jnp.asarray(cot))
  tmsgs = torch.from_numpy(msgs).requires_grad_()
  sorted_segment_sum(_edges(receivers), tmsgs).backward(
      torch.from_numpy(cot))
  np.testing.assert_array_equal(tmsgs.grad.numpy(), np.asarray(want))


def _emulate_kernel(plan, msgs: np.ndarray, rows: int = NUM_NODES
                    ) -> np.ndarray:
  """The two passes of csrc/segment_sum.cu in numpy (f32 sums) into
  ``rows`` output rows; msgs in the plan's edge order."""
  items = plan.items.numpy()
  splits = plan.splits.numpy()
  out = np.full((rows, msgs.shape[1]), np.nan, np.float32)
  scratch = np.full((plan.num_scratch_rows, msgs.shape[1]), np.nan,
                    np.float32)
  for row, e0, e1, slot in items:
    acc = np.zeros(msgs.shape[1], np.float32)
    for e in range(e0, e1):
      acc += msgs[e]
    if slot < 0:
      out[row] = acc
    else:
      scratch[slot] = acc
  for row, r0, r1, _ in splits:
    out[row] = scratch[r0:r1].sum(0, dtype=np.float32)
  return out


@pytest.mark.parametrize("case", ["random", "skewed", "empty"])
def test_kernel_plan_covers_each_edge_once(case):
  receivers = _receivers(case)
  edges = _edges(receivers)
  plan = edges.segment_plan()
  assert plan is edges.segment_plan()  # built once
  items = plan.items.numpy()
  assert (items[:, 2] - items[:, 1] <= CHUNK_EDGES).all()
  covered = np.concatenate([np.arange(e0, e1) for _, e0, e1, _ in items])
  np.testing.assert_array_equal(covered, np.arange(receivers.size))
  assert set(items[:, 0]) == set(range(NUM_NODES))
  assert (plan.splits.numpy()[:, 0] == 37).any() == (case == "skewed")
  msgs = _messages(receivers.size, (8,))
  want = segment_sum_reference(edges, torch.from_numpy(msgs)).numpy()
  np.testing.assert_allclose(_emulate_kernel(plan, msgs), want, rtol=1e-5,
                             atol=1e-5)


def _skewed_senders(case: str, num_edges: int) -> np.ndarray:
  """Senders of a receiver-sorted edge list: random over 50 nodes, or with
  sender 7 feeding hundreds of receivers ("skewed"), or with senders
  20-39 feeding none ("empty")."""
  rng = np.random.RandomState({"random": 5, "skewed": 6, "empty": 7}[case])
  senders = rng.randint(0, 50, size=num_edges)
  if case == "skewed":
    senders[rng.rand(num_edges) < 0.4] = 7
  if case == "empty":
    senders[(senders >= 20) & (senders < 40)] = 3
  return senders.astype(np.int32)


@pytest.mark.parametrize("case", ["random", "skewed", "empty"])
def test_sender_plan_is_a_stable_sender_sort_covered_once(case):
  """EdgeIndex's sender plan (K3's sender mode): a stable sender-sorted
  permutation of the receiver-sorted edges, built once, and K3's plan over
  the senders' CSR offsets, each permuted edge in one chunk of at most
  CHUNK_EDGES, every sender one or more items; run as the kernel runs it
  (numpy, through the permutation), it gives the sender sums."""
  receivers = _receivers("random")
  senders = _skewed_senders(case, receivers.size)
  edges = EdgeIndex(senders, receivers, 50, NUM_NODES)
  sp = edges.sender_plan()
  assert sp is edges.sender_plan()  # built once
  perm = sp.perm.numpy()
  np.testing.assert_array_equal(np.sort(perm), np.arange(receivers.size))
  key = senders[perm].astype(np.int64) * receivers.size + perm
  assert (np.diff(key) > 0).all()  # sorted by sender, stable within one
  items = sp.plan.items.numpy()
  assert (items[:, 2] - items[:, 1] <= CHUNK_EDGES).all()
  covered = np.concatenate([np.arange(e0, e1) for _, e0, e1, _ in items])
  np.testing.assert_array_equal(covered, np.arange(receivers.size))
  assert set(items[:, 0]) == set(range(50))
  for row, e0, e1, _ in items:
    assert (senders[perm[e0:e1]] == row).all()
  degrees = np.bincount(senders, minlength=50)
  if case == "skewed":
    assert degrees[7] > 200  # one sender feeds hundreds of receivers
  split_rows = set(sp.plan.splits.numpy()[:, 0])
  assert split_rows == set(np.nonzero(degrees > CHUNK_EDGES)[0])
  msgs = _messages(receivers.size, (8,))
  want = np.zeros((50, 8), np.float32)
  np.add.at(want, senders, msgs)
  got = _emulate_kernel(sp.plan, msgs[perm], rows=50)
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
  if case == "empty":
    assert not got[20:40].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["random", "skewed"])
def test_sender_sum_plain_version_matches_index_add(case, dtype):
  """The sender mode's plain version (what a CPU tensor takes): f32 sums of
  the messages into their senders, equal to index_add_ in the
  sender-sorted order and, within f32 reordering, in the edge order."""
  receivers = _receivers("skewed")
  senders = _skewed_senders(case, receivers.size)
  edges = EdgeIndex(senders, receivers, 50, NUM_NODES)
  msgs = torch.from_numpy(_messages(receivers.size, (16,))).to(dtype)
  got = sender_segment_sum(edges, msgs)
  assert got.dtype == torch.float32 and got.shape == (50, 16)
  torch.testing.assert_close(got, sender_sum_reference(edges, msgs),
                             rtol=0, atol=0)
  perm = edges.sender_plan().perm.long()
  ordered = torch.zeros(50, 16).index_add_(
      0, torch.from_numpy(senders).long()[perm], msgs.float()[perm])
  assert torch.equal(got, ordered)
  plain = torch.zeros(50, 16).index_add_(
      0, torch.from_numpy(senders).long(), msgs.float())
  torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
  with pytest.raises(ValueError, match="rows"):
    sender_segment_sum(edges, msgs[1:])


def test_wrapper_takes_cpu_tensors_by_the_plain_version_only():
  receivers = _receivers("random")
  edges = _edges(receivers)
  msgs = torch.from_numpy(_messages(receivers.size, (8,)))
  torch.testing.assert_close(sorted_segment_sum(edges, msgs),
                             segment_sum_reference(edges, msgs))
  with pytest.raises(ValueError, match="E, C"):
    sorted_segment_sum(edges, msgs[:, 0])


@pytest.mark.parametrize("method", sorted(segment.REDUCERS))
def test_reducers_match_jax(method):
  rng = np.random.RandomState(6)
  ids = rng.randint(0, 40, size=300).astype(np.int32)
  ids[ids == 7] = 8  # an empty segment
  data = rng.randn(300, 2, 5).astype(np.float32)
  want = np.asarray(jax_segment.REDUCERS[method](
      jnp.asarray(data), jnp.asarray(ids), 45))
  got = segment.REDUCERS[method](torch.from_numpy(data),
                                 torch.from_numpy(ids), 45).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("f32_aggregation,normalization",
                         [(False, None), (True, None), (True, 4.0)])
def test_aggregate_edges_for_nodes_matches_jax(f32_aggregation,
                                               normalization):
  receivers = _receivers("empty")
  msgs = _messages(receivers.size, (2, 8))
  kw = dict(f32_aggregation=f32_aggregation, normalization=normalization)
  want = np.asarray(jax_segment.aggregate_edges_for_nodes(
      jnp.asarray(msgs, jnp.bfloat16), jnp.asarray(receivers), NUM_NODES,
      **kw).astype(jnp.float32))
  got = segment.aggregate_edges_for_nodes(
      torch.from_numpy(msgs).to(torch.bfloat16), torch.from_numpy(receivers),
      NUM_NODES, **kw)
  assert got.dtype == torch.bfloat16
  exact = np.zeros((NUM_NODES, 2, 8))
  np.add.at(exact, receivers, msgs.astype(jnp.bfloat16).astype(np.float64))
  exact /= normalization or 1.0
  # f32 sums: one bf16 ulp; bf16 sums (as JAX's plain path) round every
  # partial sum, so allow a few ulps of the largest element.
  tol = _bf16_ulp(exact) if f32_aggregation else 8 * _bf16_ulp(
      np.abs(exact).max())
  assert (np.abs(got.float().numpy() - want) <= tol).all()
  with pytest.raises(ValueError, match="sum"):
    segment.aggregate_edges_for_nodes(torch.from_numpy(msgs),
                                      torch.from_numpy(receivers), NUM_NODES,
                                      method="segment_max", normalization=2.0)
