"""The port's NodeMulticlassTask (RGCN over per-type pair plans) against the
JAX package's on the CPU, from weights bridged out of the flax params:
logits, loss and the gradient of every parameter; also on the batch
without plans, and with the options that leave the fused route (the
activation before the aggregation, a mean aggregation, the target-state
input with 2 hidden layers), where both packages take the unfused
per-edge path. Dropout is 0, since the two frameworks' dropout bits
cannot match.

Tolerances: f32 edge streams rtol 1e-4 / atol 1e-5 (the same products
summed in other orders by XLA and PyTorch; observed at most 4e-6 absolute
on logits). bf16 edge streams rtol 2e-3 / atol 1e-4: the tables are
rounded to bf16 from f32 values that differ in the last f32 bits, so an
entry may round to the neighbouring bf16 value (2**-8 relative) and carry
that downstream (observed 1.1e-5 absolute on logits, 5e-7 on gradients).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.data import graph_batch as jgb
from tf2_gnn_tpu.models.node_multiclass_task import (
    NodeMulticlassTask as JaxNodeMulticlassTask,
)
from tf2_gnn_tpu.ops import pair_spmm as jps
from tf2_gnn_tpu_torch.data import graph_batch as tgb
from tf2_gnn_tpu_torch.harness.import_jax import (
    flax_params_to_state_dict,
    load_flax_params,
)
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask
from tf2_gnn_tpu_torch.ops import pair_spmm as tps


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores, and small ops then run many
    times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NUM_LABELS = 7
FEATURES = 12
TOLS = {"float32": dict(rtol=1e-4, atol=1e-5),
        "bfloat16": dict(rtol=2e-3, atol=1e-4)}


def small_workload(seed: int, graphs=2, nodes_per_graph=150, edges=500,
                   v_pad=384, merged=False, merge_targets=False):
    """A PPI-shaped batch at small size (self loops, random forward edges
    and their reverses per graph), padded and planned by both packages:
    per-type plans, or with ``merged`` one merged plan over all types
    (the RGAT form of ``bench.py::build_batch``), whose targets lie in the
    merged ``l * V + t`` row space with ``merge_targets`` (the target-state
    edge-MLP form)."""
    rng = np.random.RandomState(seed)
    loops, fwd = [], []
    for g in range(graphs):
        base = g * nodes_per_graph
        nodes = np.arange(base, base + nodes_per_graph)
        loops.append(np.stack([nodes, nodes], 1))
        fwd.append(rng.randint(0, nodes_per_graph, (edges, 2)) + base)
    loops = np.concatenate(loops).astype(np.int32)
    fwd = np.concatenate(fwd).astype(np.int32)
    adjacency = [loops, fwd, fwd[:, ::-1].copy()]
    n = graphs * nodes_per_graph
    features = rng.randn(n, FEATURES).astype(np.float32)
    node_to_graph = np.repeat(np.arange(graphs, dtype=np.int32),
                              nodes_per_graph)
    labels = (rng.rand(n, NUM_LABELS) > 0.7).astype(np.float32)
    budgets = tuple(((a.shape[0] + 63) // 64) * 64 for a in adjacency)

    def planned(gb_mod, ps_mod):
        batch = gb_mod.pad_batch_arrays(
            features, adjacency, node_to_graph, graphs,
            gb_mod.PaddingConfig(num_nodes=v_pad, num_graphs=graphs + 1,
                                 edge_budgets=budgets))
        srcs = [np.asarray(s) for s in batch.edge_sources]
        tgts = [np.asarray(t) for t in batch.edge_targets]
        cnts = [int(c) for c in np.asarray(batch.num_edges)]
        if merged:
            gf, gb = ps_mod.choose_pair_groups(srcs, tgts, cnts, v_pad,
                                               merge_targets=merge_targets)
            plans = ps_mod.build_pair_plans(srcs, tgts, cnts, v_pad,
                                            overflow_budget=256,
                                            merge_targets=merge_targets,
                                            group_fwd=gf, group_bwd=gb)
            return batch.replace(pair_plans=plans.astuple(),
                                 pair_targets_merged=merge_targets)
        gf, gb = ps_mod.choose_pair_groups([srcs[0]], [tgts[0]], [cnts[0]],
                                           v_pad)
        typed = tuple(
            ps_mod.build_pair_plans([srcs[t]], [tgts[t]], [cnts[t]], v_pad,
                                    group_fwd=gf, group_bwd=gb).astuple()
            for t in range(3))
        return batch.replace(pair_plans_typed=typed)

    label_pad = jgb.pad_node_label_array(labels, v_pad)
    return planned(jgb, jps), planned(tgb, tps).to("cpu"), label_pad


CONFIGS = {
    # The shipped PPI_RGCN layout at small width: dense at layer 0 only,
    # residual only records ``last``.
    "ppi": {"gnn_num_layers": 3, "gnn_hidden_dim": 32,
            "gnn_dense_every_num_layers": 10000,
            "gnn_residual_every_num_layers": 10000},
    # Mean residual at layer 2, dense at layers 0 and 2, LayerNorm.
    "residual_dense_layernorm": {
        "gnn_num_layers": 3, "gnn_hidden_dim": 16,
        "gnn_dense_every_num_layers": 2, "gnn_residual_every_num_layers": 2,
        "gnn_use_inter_layer_layernorm": True},
}


def make_params(config: str, edge_dtype: str):
    params = JaxNodeMulticlassTask.get_default_hyperparameters("rgcn")
    params.update(CONFIGS[config])
    params.update({"gnn_edge_dtype": edge_dtype,
                   "gnn_layer_input_dropout_rate": 0.0,
                   "gnn_global_exchange_every_num_layers": 10000})
    return params


def build_pair(params, jbatch, seed=0):
    """The JAX model with its flax params, and the port's model with those
    params bridged in."""
    jmodel = JaxNodeMulticlassTask.from_params(
        params, types.SimpleNamespace(num_node_target_labels=NUM_LABELS))
    jparams = jmodel.init(jax.random.PRNGKey(seed), jbatch, False)["params"]
    tmodel = NodeMulticlassTask.from_params(
        params, input_dim=FEATURES, num_edge_types=3, device="cpu",
        num_labels=NUM_LABELS)
    load_flax_params(tmodel, jax.device_get(jparams))
    return jmodel, jparams, tmodel


@pytest.mark.parametrize("config,edge_dtype", [
    ("ppi", "float32"), ("ppi", "bfloat16"),
    ("residual_dense_layernorm", "float32")])
def test_forward_loss_and_gradients_match_jax(config, edge_dtype):
    jbatch, tbatch, labels = small_workload(seed=3)
    check_matches_jax(make_params(config, edge_dtype), jbatch, tbatch,
                      labels)


def check_matches_jax(params, jbatch, tbatch, labels):
    """Logits, loss, F1 counts and every parameter gradient of the port's
    model against the JAX package's, at the edge dtype's tolerance.
    Returns the port's model."""
    jmodel, jparams, tmodel = build_pair(params, jbatch)
    tols = TOLS[params["gnn_edge_dtype"]]

    def jloss(p):
        out = jmodel.apply({"params": p}, jbatch, False)
        metrics = jmodel.compute_task_metrics(
            jbatch, out, {"node_labels": jnp.asarray(labels)})
        return metrics["loss"], (out[0], metrics)

    (jl, (jlogits, jmetrics)), jgrads = jax.value_and_grad(
        jloss, has_aux=True)(jparams)

    out = tmodel(tbatch, False)
    metrics = tmodel.compute_task_metrics(
        tbatch, out, {"node_labels": torch.from_numpy(labels)})
    metrics["loss"].backward()

    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(jlogits),
                               **tols)
    np.testing.assert_allclose(float(metrics["loss"].detach()), float(jl),
                               **tols)
    for key in ("f1_tp", "f1_fp", "f1_fn"):
        # Counts of logits' signs: a logit within tolerance of 0 may flip.
        assert abs(float(metrics[key]) - float(jmetrics[key])) <= 2
    want = flax_params_to_state_dict(jax.device_get(jgrads))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for name, grad in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), grad.numpy(),
                                   err_msg=name, **tols)
    return tmodel


def test_bridge_rejects_unmapped_leaves():
    jbatch, _, _ = small_workload(seed=4)
    params = make_params("ppi", "float32")
    _, jparams, tmodel = build_pair(params, jbatch)
    tree = jax.device_get(jparams)
    extra = dict(tree)
    extra["gnn"] = dict(tree["gnn"])
    extra["gnn"]["global_exchange_1"] = {"kernel": np.zeros((32, 32),
                                                            np.float32)}
    with pytest.raises(ValueError, match="global_exchange_1"):
        load_flax_params(tmodel, extra)
    odd = {"gnn": {"initial_node_projection": {"embedding": np.zeros((2, 2))}}}
    with pytest.raises(ValueError, match="no counterpart"):
        flax_params_to_state_dict(odd)
    missing = {k: v for k, v in tree.items() if k != "node_to_labels"}
    with pytest.raises(RuntimeError, match="node_to_labels"):
        load_flax_params(tmodel, missing)


def test_batch_without_pair_plans_raises():
    """A batch without pair plans takes the unfused per-edge path, as in
    the JAX package, and matches it (the test's name is its id from when
    this path raised)."""
    jbatch, tbatch, labels = small_workload(seed=5)
    bare = tbatch.replace(pair_plans_typed=None)
    params = make_params("ppi", "float32")
    tmodel = check_matches_jax(params, jbatch.replace(pair_plans_typed=None),
                               bare, labels)
    for i in range(params["gnn_num_layers"]):
        assert getattr(tmodel.gnn, f"mp_layer_{i}")._route(bare) == "unfused"


@pytest.mark.parametrize("override", [
    {"gnn_message_activation_before_aggregation": True},
    {"gnn_use_target_state_as_input": True,
     "gnn_num_edge_MLP_hidden_layers": 2},
    {"gnn_aggregation_function": "mean"},
    {"gnn_use_remat": True},
])
def test_unported_options_raise(override):
    """Each option matches the JAX package's model with it (the test's name
    is its id from when they raised): ``use_remat`` on the fused route
    (remat changes no value), the others on the unfused path, where they
    send the per-type-plan batch."""
    params = make_params("ppi", "float32")
    params.update(override)
    jbatch, tbatch, labels = small_workload(seed=6)
    tmodel = check_matches_jax(params, jbatch, tbatch, labels)
    route = tmodel.gnn.mp_layer_0._route(tbatch)
    assert route == ("pair_joint" if "gnn_use_remat" in override
                     else "unfused")
