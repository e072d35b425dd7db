"""The port's general message-passing path (nn/message_passing.py,
nn/deep_gnn.py ``forward``, nn/core.py's factored edge update) against
graphcast_tpu's, at batch 2, f32, on shared numpy weights and inputs.

- ``apply_graph_network`` on a graph of two node sets and three edge sets
  (one of them within a set): with context broadcast, sent messages in
  the node update and the global update (unfactored edge functions); and
  with factored edge functions and a per-edge-set aggregator mapping.
- ``DeepGraphNet``'s general path (context concat, embed, 2 processor
  steps with residuals, decode) with and without norm conditioning, the
  conditioning one row per batch member.

Tolerance 5e-4, the port's f32 bound (summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphcast_tpu.nn import deep_gnn as jax_deep_gnn
from graphcast_tpu.nn import message_passing as jax_mp
from graphcast_tpu.nn import typed_graph as jax_tg
from graphcast_tpu_torch import params
from graphcast_tpu_torch.nn import deep_gnn, message_passing, typed_graph

BATCH = 2
NODES = {"a": 6, "b": 9}
EDGE_SETS = {"ab": ("a", "b"), "ba": ("b", "a"), "bb": ("b", "b")}
C = 8
TOL = 5e-4


def _edge_lists(seed=0):
  rng = np.random.RandomState(seed)
  out = {}
  for name, (s, r) in EDGE_SETS.items():
    n = 3 * NODES[r]
    senders, receivers = jax_tg.sort_edges_by_receiver(
        rng.randint(0, NODES[s], n), rng.randint(0, NODES[r], n))
    out[name] = (senders, receivers)
  return out


def _graphs(context: bool, edge_width: int = C, node_width: int = C):
  """(JAX graph, port graph) with the same numpy features."""
  rng = np.random.RandomState(1)
  lists = _edge_lists()
  nodes = {n: rng.randn(k, BATCH, node_width).astype(np.float32)
           for n, k in NODES.items()}
  edges = {n: rng.randn(lists[n][0].size, BATCH, edge_width).astype(
      np.float32) for n in EDGE_SETS}
  ctx = rng.randn(BATCH, 3).astype(np.float32) if context else None

  def build(mod, arr, indices):
    return mod.TypedGraph(
        context=mod.Context(features=() if ctx is None else arr(ctx)),
        nodes={n: mod.NodeSet(NODES[n], arr(x)) for n, x in nodes.items()},
        edges={mod.EdgeSetKey(n, EDGE_SETS[n]): mod.EdgeSet(
            mod.EdgesIndices(*(indices(i) for i in lists[n])), arr(x))
            for n, x in edges.items()})

  return (build(jax_tg, jnp.asarray, jnp.asarray),
          build(typed_graph, torch.from_numpy, torch.from_numpy))


def _assert_graphs_close(got, want):
  for name, ns in want.nodes.items():
    np.testing.assert_allclose(got.nodes[name].features.detach().numpy(),
                               np.asarray(ns.features), rtol=TOL, atol=TOL,
                               err_msg=name)
  for key, es in want.edges.items():
    np.testing.assert_allclose(got.edges[key].features.detach().numpy(),
                               np.asarray(es.features), rtol=TOL, atol=TOL,
                               err_msg=key.name)


def _tanh_layer(rng, in_size, out_size):
  """The same tanh(concat @ W) function in both packages."""
  w = (rng.randn(in_size, out_size) / np.sqrt(in_size)).astype(np.float32)
  return (lambda *xs: jnp.tanh(jnp.concatenate(xs, -1) @ jnp.asarray(w)),
          lambda *xs: torch.tanh(torch.cat(xs, -1) @ torch.from_numpy(w)))


def test_apply_graph_network_with_context_sent_messages_and_globals():
  jgraph, tgraph = _graphs(context=True)
  rng = np.random.RandomState(2)
  edge_fns = {n: _tanh_layer(rng, 3 * C + 3, C) for n in EDGE_SETS}
  node_fns = {}
  for n in NODES:
    touching = sum((s == n) + (r == n) for s, r in EDGE_SETS.values())
    node_fns[n] = _tanh_layer(rng, C + touching * C + 3, C)
  global_fn = _tanh_layer(rng, (len(NODES) + len(EDGE_SETS)) * C + 3, 3)
  kw = dict(include_sent_messages_in_node_update=True)
  want = jax_mp.apply_graph_network(
      jgraph, update_edge_fn={n: f[0] for n, f in edge_fns.items()},
      update_node_fn={n: f[0] for n, f in node_fns.items()},
      update_global_fn=global_fn[0], **kw)
  got = message_passing.apply_graph_network(
      tgraph, update_edge_fn={n: f[1] for n, f in edge_fns.items()},
      update_node_fn={n: f[1] for n, f in node_fns.items()},
      update_global_fn=global_fn[1], **kw)
  _assert_graphs_close(got, want)
  np.testing.assert_allclose(got.context.features.numpy(),
                             np.asarray(want.context.features), rtol=TOL,
                             atol=TOL)
  with pytest.raises(ValueError, match="factored"):
    message_passing.apply_graph_network(
        tgraph, update_edge_fn={"ab": edge_fns["ab"][1]}, update_node_fn={},
        factored_edge_fns=True)


def test_apply_graph_network_factored_with_aggregator_mapping():
  jgraph, tgraph = _graphs(context=False)
  rng = np.random.RandomState(3)
  wf = {n: [(rng.randn(C, C) / np.sqrt(C)).astype(np.float32)
            for _ in range(3)] for n in EDGE_SETS}

  def factored(n, lib, arr, gather):
    we, ws, wr = (arr(w) for w in wf[n])
    return lambda e, s, r, si, ri: lib.tanh(
        e @ we + gather(s @ ws, si) + gather(r @ wr, ri))

  node_fns = {n: _tanh_layer(rng, C + sum(r == n for _, r in
                                          EDGE_SETS.values()) * C, C)
              for n in NODES}

  def jax_mean(data, idx, num, edge_set_name=None, indices_are_sorted=True):
    del edge_set_name
    return jax_mp.segment.aggregate_edges_for_nodes(
        data, idx, num, method="segment_mean",
        indices_are_sorted=indices_are_sorted)

  def port_mean(data, idx, num, edge_set_name=None, indices_are_sorted=True):
    del edge_set_name
    return message_passing.segment.aggregate_edges_for_nodes(
        data, idx, num, method="segment_mean",
        indices_are_sorted=indices_are_sorted)

  want = jax_mp.apply_graph_network(
      jgraph, update_edge_fn={n: factored(n, jnp, jnp.asarray,
                                          lambda x, i: x[i])
                              for n in EDGE_SETS},
      update_node_fn={n: f[0] for n, f in node_fns.items()},
      aggregate_edges_for_nodes_fn={"bb": jax_mean}, factored_edge_fns=True)
  got = message_passing.apply_graph_network(
      tgraph, update_edge_fn={n: factored(
          n, torch, torch.from_numpy, lambda x, i: x.index_select(0, i))
                              for n in EDGE_SETS},
      update_node_fn={n: f[1] for n, f in node_fns.items()},
      aggregate_edges_for_nodes_fn={"bb": port_mean}, factored_edge_fns=True)
  _assert_graphs_close(got, want)
  assert [k.name for k in message_passing.receiving_edge_sets(tgraph, "b")
          ] == ["ab", "bb"]
  assert [k.name for k in message_passing.sending_edge_sets(tgraph, "b")
          ] == ["ba", "bb"]


def _nondegenerate(flat: dict, seed: int) -> dict:
  """Norm conditionings redrawn at 1/sqrt(fan_in) (their init is ~0)."""
  rng = np.random.RandomState(seed)
  return {k: ((rng.randn(*v.shape) / np.sqrt(
      flat[k.rsplit("/", 1)[0] + "/w"].shape[0])).astype(np.float32)
              if "norm_conditioning" in k else v) for k, v in flat.items()}


def _nest(flat: dict) -> dict:
  tree: dict = {}
  for key, v in flat.items():
    node = tree
    *path, leaf = key.split("/")
    for part in path:
      node = node.setdefault(part, {})
    node[leaf] = jnp.asarray(v)
  return tree


@pytest.mark.parametrize("conditioned", [False, True])
def test_deep_graph_net_general_path_matches_jax(conditioned):
  """Two node sets with context, three edge sets, two processor steps, a
  node decoder, f32 aggregation with a normalization, at batch 2."""
  jgraph, tgraph = _graphs(context=True, edge_width=4, node_width=5)
  cfg = dict(node_latent_size={"a": C, "b": C},
             edge_latent_size={n: C for n in EDGE_SETS},
             mlp_hidden_size=16, mlp_num_hidden_layers=1,
             num_message_passing_steps=2, node_output_size={"b": 3},
             f32_aggregation=True, aggregate_normalization=2.0)
  cond = np.random.RandomState(4).randn(BATCH, 4).astype(np.float32)
  jnet = jax_deep_gnn.DeepGraphNet(
      activation="swish", use_norm_conditioning=conditioned,
      norm_conditioning_size=4 if conditioned else None, **cfg)
  flat = _nondegenerate(params.params_from_jax(jax.tree_util.tree_map(
      np.asarray, jnet.init(jax.random.PRNGKey(0), jgraph))), seed=5)
  net = deep_gnn.DeepGraphNet(
      node_input_size={n: 5 + 3 for n in NODES},
      edge_input_size={n: 4 for n in EDGE_SETS}, edge_sets=EDGE_SETS,
      norm_conditioning_size=4 if conditioned else None, **cfg)
  params.load_params(net, flat)
  want = jnet.apply(_nest(flat), jgraph, global_norm_conditioning=(
      jnp.asarray(cond) if conditioned else None))
  with torch.inference_mode():
    got = net(tgraph, cond=torch.from_numpy(cond) if conditioned else None)
  _assert_graphs_close(got, want)
  assert got.nodes["b"].features.shape == (NODES["b"], BATCH, 3)
  with pytest.raises(ValueError, match="cond"):
    net(tgraph, cond=None if conditioned else torch.from_numpy(cond))


def test_deep_graph_net_remat_steps_matches_jax(monkeypatch):
  """``remat_steps``: four processor steps in √4 = 2 recompute blocks of two
  per-step regions, the second block's inputs the named carries. Every
  parameter gradient of a fixed projection of the output against the JAX
  package's remat (5e-4), and bit-equal to the port without remat."""
  from graphcast_tpu_torch.nn import remat
  jgraph, tgraph = _graphs(context=True, edge_width=4, node_width=5)
  cfg = dict(node_latent_size={"a": C, "b": C},
             edge_latent_size={n: C for n in EDGE_SETS},
             mlp_hidden_size=16, mlp_num_hidden_layers=1,
             num_message_passing_steps=4, node_output_size={"b": 3},
             f32_aggregation=True, remat_steps=True)
  jnet = jax_deep_gnn.DeepGraphNet(activation="swish", **cfg)
  jparams = jnet.init(jax.random.PRNGKey(0), jgraph)
  flat = params.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
  cot = np.random.RandomState(6).randn(NODES["b"], BATCH, 3).astype(
      np.float32)
  want = params.params_from_jax(jax.tree_util.tree_map(np.asarray, jax.grad(
      lambda p: jnp.sum(jnet.apply(p, jgraph).nodes["b"].features * cot))(
          jparams)))
  regions, named = [], []
  checkpoint, named_checkpoint = remat.checkpoint, remat.named_checkpoint
  monkeypatch.setattr(remat, "checkpoint", lambda fn, *a: regions.append(
      1) or checkpoint(fn, *a))
  monkeypatch.setattr(remat, "named_checkpoint", lambda name, fn, *a: (
      named.append(name) or named_checkpoint(name, fn, *a)))
  grads = {}
  for remat_steps in (True, False):
    net = deep_gnn.DeepGraphNet(
        node_input_size={n: 5 + 3 for n in NODES},
        edge_input_size={n: 4 for n in EDGE_SETS}, edge_sets=EDGE_SETS,
        **{**cfg, "remat_steps": remat_steps})
    params.load_params(net, flat)
    out = net(tgraph).nodes["b"].features
    (out * torch.from_numpy(cot)).sum().backward()
    grads[remat_steps] = {
        k: torch.zeros_like(p) if p.grad is None else p.grad
        for k, p in params.flat_params(net).items()}
  assert named == ["mp_block_carry"]
  assert len(regions) >= 1 + 4  # the first block and the per-step regions
  for k, w in want.items():
    np.testing.assert_allclose(grads[True][k].numpy(), w, rtol=5e-4,
                               atol=5e-4, err_msg=k)
    assert torch.equal(grads[True][k], grads[False][k]), k
