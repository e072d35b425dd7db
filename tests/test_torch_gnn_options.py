"""Every option of the JAX ``DeepGraphNet`` constructor (graphcast_tpu/nn/
deep_gnn.py:28-71) and every activation name of the port's table (nn/
core.py ``ACTIVATIONS``, jax.nn's semantics) in the port's ``DeepGraphNet``
against graphcast_tpu's, at batch 2, f32, on shared numpy weights and
inputs (tests/test_torch_message_passing.py's graph: two node sets, three
edge sets, one within a set).

One parametrised test: the output graph's node and edge features (5e-4)
and every parameter gradient of a fixed random projection of them (within
5e-4 of each gradient's largest element). An unknown activation name
raises in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_message_passing as mp_case
from graphcast_tpu.nn import core as jax_core
from graphcast_tpu.nn import deep_gnn as jax_deep_gnn
from graphcast_tpu_torch import params
from graphcast_tpu_torch.nn import core, deep_gnn

C = mp_case.C
TOL = 5e-4
BASE = dict(node_latent_size={"a": C, "b": C},
            edge_latent_size={n: C for n in mp_case.EDGE_SETS},
            mlp_hidden_size=16, mlp_num_hidden_layers=1,
            num_message_passing_steps=2, node_output_size={"b": 3},
            activation="swish")
# name: (constructor options, graph with context, conditioned)
OPTIONS = {
    "num_processor_repetitions": (dict(num_processor_repetitions=2), True,
                                  False),
    "num_processor_repetitions_remat": (
        dict(num_processor_repetitions=2, num_message_passing_steps=4,
             remat_steps=True), True, False),
    "embed_edges_false": (dict(embed_edges=False), True, False),
    "embed_nodes_false": (dict(embed_nodes=False), False, False),
    "edge_output_size": (dict(edge_output_size={"ab": 3, "bb": 5}), True,
                         False),
    "include_sent_messages": (
        dict(include_sent_messages_in_node_update=True), True, False),
    "use_layer_norm_false": (dict(use_layer_norm=False), True, False),
    "factored_edge_updates_false": (dict(factored_edge_updates=False), True,
                                    False),
    "factored_edge_updates_false_conditioned": (
        dict(factored_edge_updates=False), False, True),
    "mlp_num_hidden_layers_0": (dict(mlp_num_hidden_layers=0), True, False),
    "mlp_num_hidden_layers_2": (dict(mlp_num_hidden_layers=2), True, False),
    "mlp_num_hidden_layers_3_conditioned": (dict(mlp_num_hidden_layers=3),
                                            False, True),
    "aggregation": (dict(f32_aggregation=True, aggregate_normalization=3.0),
                    True, False),
    "everything": (dict(num_processor_repetitions=2, embed_edges=False,
                        edge_output_size={"ba": 2},
                        include_sent_messages_in_node_update=True,
                        use_layer_norm=False, activation="gelu",
                        factored_edge_updates=False,
                        mlp_num_hidden_layers=2), True, False),
}
CASES = ([pytest.param(OPTIONS[n], id=n) for n in sorted(OPTIONS)]
         + [pytest.param((dict(activation=a), True, False),
                         id=f"activation_{a}")
            for a in sorted(core.ACTIVATIONS)])


def _jax_grads_and_outputs(jnet, jparams, jgraph, cond, cot):
  def project(p):
    out = jnet.apply(p, jgraph, global_norm_conditioning=cond)
    total = sum(jnp.sum(out.nodes[n].features * cot[n]) for n in out.nodes)
    total += sum(jnp.sum(out.edges[k].features * cot[k.name])
                 for k in out.edges)
    return total, out

  grads, out = jax.grad(project, has_aux=True)(jparams)
  return out, params.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            grads))


@pytest.mark.parametrize("case", CASES)
def test_deep_graph_net_option_matches_jax(case):
  options, context, conditioned = case
  cfg = dict(BASE, **options)
  widths = {} if cfg.get("embed_nodes", True) else {"node_width": C}
  if not cfg.get("embed_edges", True):
    widths["edge_width"] = C
  jgraph, tgraph = mp_case._graphs(context=context,
                                   **{"edge_width": 4, "node_width": 5,
                                      **widths})
  cond = (np.random.RandomState(4).randn(mp_case.BATCH, 4).astype(
      np.float32) if conditioned else None)
  jnet = jax_deep_gnn.DeepGraphNet(
      use_norm_conditioning=conditioned,
      norm_conditioning_size=4 if conditioned else None, **cfg)
  flat = mp_case._nondegenerate(params.params_from_jax(
      jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(0),
                                                   jgraph))), seed=5)
  node_in = {n: ns.features.shape[-1] + (3 if context else 0)
             for n, ns in tgraph.nodes.items()}
  edge_in = {k.name: es.features.shape[-1] for k, es in tgraph.edges.items()}
  net = deep_gnn.DeepGraphNet(
      node_input_size=node_in, edge_input_size=edge_in,
      edge_sets=mp_case.EDGE_SETS,
      norm_conditioning_size=4 if conditioned else None, **cfg)
  assert sorted(params.flat_params(net)) == sorted(flat)
  params.load_params(net, flat)

  rng = np.random.RandomState(6)
  jcond = None if cond is None else jnp.asarray(cond)
  probe = jnet.apply(mp_case._nest(flat), jgraph,
                     global_norm_conditioning=jcond)
  cot = {n: rng.randn(*ns.features.shape).astype(np.float32)
         for n, ns in probe.nodes.items()}
  cot.update({k.name: rng.randn(*es.features.shape).astype(np.float32)
              for k, es in probe.edges.items()})
  want, want_grads = _jax_grads_and_outputs(
      jnet, mp_case._nest(flat), jgraph, jcond, cot)

  got = net(tgraph, cond=None if cond is None else torch.from_numpy(cond))
  mp_case._assert_graphs_close(got, want)
  total = sum((got.nodes[n].features * torch.from_numpy(cot[n])).sum()
              for n in got.nodes)
  total = total + sum((got.edges[k].features
                       * torch.from_numpy(cot[k.name])).sum()
                      for k in got.edges)
  total.backward()
  grads = params.flat_params(net)
  assert sorted(grads) == sorted(want_grads)
  for k, w in want_grads.items():
    g = grads[k].grad
    g = np.zeros_like(w) if g is None else g.numpy()
    np.testing.assert_allclose(g, w, rtol=TOL,
                               atol=TOL * max(np.abs(w).max(), 1e-6),
                               err_msg=k)


def test_unknown_activation_raises_in_both_packages():
  with pytest.raises(ValueError, match="unknown activation"):
    jax_core.get_activation("not_an_activation")
  with pytest.raises(ValueError, match="unknown activation"):
    core.get_activation("not_an_activation")
  with pytest.raises(ValueError, match="unknown activation"):
    deep_gnn.DeepGraphNet(
        node_input_size={"a": 5, "b": 5}, edge_input_size={"ab": 4},
        edge_sets={"ab": ("a", "b")}, node_latent_size={"a": C, "b": C},
        edge_latent_size={"ab": C}, mlp_hidden_size=16,
        mlp_num_hidden_layers=1, num_message_passing_steps=1,
        activation="not_an_activation")
