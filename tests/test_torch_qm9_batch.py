"""The port's QM9-shaped workload against ``bench.py``'s: the batch of
``workloads.build_qm9_batch_host(0)`` is array-identical to
``bench.build_qm9_batch(0)`` (features, edges, graph map, the five
per-type pair plans and the labels), and its form without plans has the
same arrays; ``workloads.qm9_shipped_params()`` is
the dict ``bench.py::measure_qm9`` builds; the port's copy of
``QM9_RGCN.json`` is the JAX package's; the graph mask and the per-graph
label pad are the JAX package's.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from tf2_gnn_tpu.data import graph_batch as jgb
from tf2_gnn_tpu.models.qm9_regression_task import (
    QM9RegressionTask as JaxQM9RegressionTask,
)
from tf2_gnn_tpu_torch import workloads
from tf2_gnn_tpu_torch.data import graph_batch as tgb


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores, and small ops then run many
    times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def batches():
    return bench.build_qm9_batch(0), workloads.build_qm9_batch_host(0)


def test_batch_arrays_are_the_bench_batch(batches):
    (jbatch, jlabels, jmols), (tbatch, tlabels, tmols) = batches
    assert tmols == jmols == 909
    for name in ("node_features", "node_to_graph", "num_edges",
                 "in_degrees"):
        np.testing.assert_array_equal(getattr(tbatch, name),
                                      np.asarray(getattr(jbatch, name)),
                                      err_msg=name)
        assert getattr(tbatch, name).dtype == np.asarray(
            getattr(jbatch, name)).dtype
    for name in ("edge_sources", "edge_targets"):
        for t, (got, want) in enumerate(zip(getattr(tbatch, name),
                                            getattr(jbatch, name))):
            np.testing.assert_array_equal(got, np.asarray(want),
                                          err_msg=f"{name}[{t}]")
    for name in ("num_nodes", "num_graphs", "num_graphs_padded"):
        assert int(getattr(tbatch, name)) == int(getattr(jbatch, name)), name
    assert tbatch.num_nodes_padded == 16384 and tbatch.num_graphs_padded == 910
    assert tbatch.node_features.shape == (16384, 32)
    assert set(tlabels) == set(jlabels) == {"target_value"}
    np.testing.assert_array_equal(tlabels["target_value"],
                                  np.asarray(jlabels["target_value"]))
    assert tlabels["target_value"].shape == (910,)


def test_bare_batch_is_the_bench_batch_without_its_plans(batches):
    """``build_qm9_batch_host(0, plans=False)``, the dataset's default
    form, has ``bench.build_qm9_batch(0)``'s arrays and no plan."""
    (jbatch, jlabels, _), _ = batches
    bare, labels, mols = workloads.build_qm9_batch_host(0, plans=False)
    assert mols == 909
    for name in ("node_features", "node_to_graph", "num_edges",
                 "in_degrees"):
        got, want = getattr(bare, name), np.asarray(getattr(jbatch, name))
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert got.dtype == want.dtype, name
    for name in ("edge_sources", "edge_targets"):
        for t, (got, want) in enumerate(zip(getattr(bare, name),
                                            getattr(jbatch, name))):
            np.testing.assert_array_equal(got, np.asarray(want),
                                          err_msg=f"{name}[{t}]")
    for name in ("num_nodes", "num_graphs", "num_graphs_padded"):
        assert int(getattr(bare, name)) == int(getattr(jbatch, name)), name
    np.testing.assert_array_equal(labels["target_value"],
                                  np.asarray(jlabels["target_value"]))
    assert jbatch.pair_plans_typed is not None
    assert (bare.pair_plans_typed, bare.pair_plans,
            bare.scatter_plans) == (None, None, None)


def test_per_type_plans_are_the_bench_plans(batches):
    (jbatch, _, _), (tbatch, _, _) = batches
    assert len(tbatch.pair_plans_typed) == len(jbatch.pair_plans_typed) == 5
    for t, (got, want) in enumerate(zip(tbatch.pair_plans_typed,
                                        jbatch.pair_plans_typed)):
        assert len(got) == len(want) == 13
        for i, (a, b) in enumerate(zip(got, want)):
            b = np.asarray(b)
            assert a.dtype == b.dtype, (t, i)
            np.testing.assert_array_equal(a, b, err_msg=f"type {t} array {i}")


def test_small_counts_build_the_same_construction():
    """The counts are arguments: a small batch keeps the layout (18-node
    molecules, 5 types, 910-style pad slot, budgets rounded to 512)."""
    batch, labels, mols = workloads.build_qm9_batch_host(
        1, molecules=40, node_budget=768)
    assert mols == 40 and batch.num_graphs_padded == 41
    assert batch.num_nodes == 720 and batch.num_nodes_padded == 768
    assert [s.shape[0] for s in batch.edge_sources] == [512] * 5
    assert list(batch.num_edges) == [440] * 5
    assert labels["target_value"].shape == (41,)
    assert labels["target_value"][40] == 0.0
    np.testing.assert_array_equal(batch.node_to_graph[700:],
                                  [38] * 2 + [39] * 18 + [40] * 48)
    # Every edge stays inside its molecule.
    for src, tgt, n in zip(batch.edge_sources, batch.edge_targets,
                           batch.num_edges):
        np.testing.assert_array_equal(src[:n] // 18, tgt[:n] // 18)


def test_qm9_shipped_params_are_the_bench_config():
    shipped = json.loads((REPO / "tf2_gnn_tpu" / "harness" / "default_hypers"
                          / "QM9_RGCN.json").read_text())
    want = JaxQM9RegressionTask.get_default_hyperparameters("rgcn")
    want.update(shipped["model_params"])
    got = workloads.qm9_shipped_params()
    assert got == want
    port_copy = json.loads(
        (REPO / "tf2_gnn_tpu_torch" / "harness" / "default_hypers"
         / "QM9_RGCN.json").read_text())
    assert port_copy == shipped
    assert got["gnn_num_layers"] == 8 and got["gnn_hidden_dim"] == 128
    assert got["optimizer"] == "RMSProp"
    assert got["gnn_edge_dtype"] == "bfloat16"
    assert got["gradient_clip_value"] == 1.0
    assert got["gnn_global_exchange_every_num_layers"] == 2
    assert got["use_intermediate_gnn_results"] is False


@pytest.mark.parametrize("num_graphs,padded", [(3, 4), (909, 910), (0, 1)])
def test_graph_mask_and_label_pad_match_jax(num_graphs, padded):
    rng = np.random.RandomState(num_graphs)
    values = rng.randn(num_graphs, 2).astype(np.float32)
    np.testing.assert_array_equal(tgb.pad_graph_label_array(values, padded),
                                  jgb.pad_graph_label_array(values, padded))
    batch = tgb.GraphBatch(
        node_features=np.zeros((8, 1), np.float32), edge_sources=(),
        edge_targets=(), node_to_graph=np.zeros(8, np.int32), num_nodes=8,
        num_edges=np.zeros(0, np.int32), num_graphs=num_graphs,
        num_graphs_padded=padded).to("cpu")
    want = (np.arange(padded) < num_graphs).astype(np.float32)
    np.testing.assert_array_equal(batch.graph_mask.numpy(), want)
