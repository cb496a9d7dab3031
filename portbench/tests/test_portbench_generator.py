"""The generator's layouts against the port's synthetic workloads
(``tf2_gnn_tpu_torch/workloads.py``), array for array at the cells'
sizes, and the seed derivation."""
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import generator
from tf2_gnn_tpu_torch import workloads

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def traffic(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


def params(name):
    return {k: v for k, v in traffic(name).items()
            if k not in ("layout", "draws", "why")}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_ppi_draw_is_build_raw_arrays(seed, monkeypatch):
    seed32 = seed % 2**32
    p = params("ppi_train")
    # workloads.py sizes its batch by module constants: the cell's sizes.
    monkeypatch.setattr(workloads, "GRAPHS_PER_BATCH", p["graphs_per_draw"])
    monkeypatch.setattr(workloads, "NODE_BUDGET", 49152)
    draw = generator.layout("ppi")(seed32, **p)
    features, adjacency, node_to_graph = workloads.build_raw_arrays(seed32)
    np.testing.assert_array_equal(draw.node_features, features)
    assert len(draw.edges) == len(adjacency)
    for got, want in zip(draw.edges, adjacency):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(draw.node_to_graph, node_to_graph)
    _, labels, real_edges = workloads.build_ppi_batch_host(seed32,
                                                           plans=False)
    np.testing.assert_array_equal(
        draw.node_labels, labels["node_labels"][:draw.num_nodes])
    assert sum(e.shape[0] for e in draw.edges) == real_edges == 1408000


@pytest.mark.parametrize("seed", [0, 3])
def test_qm9_draw_is_build_qm9_batch_host(seed):
    p = params("qm9_train")
    draw = generator.layout("qm9")(seed, **p)
    budget = 131072
    batch, labels, molecules = workloads.build_qm9_batch_host(
        seed, molecules=p["molecules_per_draw"],
        nodes_per_molecule=p["nodes_per_molecule"],
        num_types=p["edge_types"],
        edges_per_molecule=p["edges_per_molecule"], node_budget=budget,
        feature_dim=p["feature_dim"], plans=False)
    n = draw.num_nodes
    assert (n, molecules) == (131058, draw.num_graphs) == (131058, 7281)
    np.testing.assert_array_equal(draw.node_features,
                                  batch.node_features[:n])
    np.testing.assert_array_equal(draw.node_to_graph,
                                  batch.node_to_graph[:n])
    for l, edges in enumerate(draw.edges):
        count = int(batch.num_edges[l])
        assert edges.shape[0] == count
        np.testing.assert_array_equal(edges[:, 0],
                                      batch.edge_sources[l][:count])
        np.testing.assert_array_equal(edges[:, 1],
                                      batch.edge_targets[l][:count])
    np.testing.assert_array_equal(draw.graph_targets,
                                  labels["target_value"][:molecules])
    assert sum(e.shape[0] for e in draw.edges) == 400455


def test_generate_draws_from_derived_seeds():
    small = dict(traffic("ppi_train"), draws=3, nodes_per_graph=20,
                 fwd_edges_per_graph=50)
    draws = generator.generate(small, 2**40 + 3)
    again = generator.generate(small, 2**40 + 3)
    other = generator.generate(small, 2**40 + 4)
    for a, b in zip(draws, again):
        np.testing.assert_array_equal(a.node_features, b.node_features)
    assert not np.array_equal(draws[0].node_features,
                              other[0].node_features)
    assert not np.array_equal(draws[0].node_features,
                              draws[1].node_features)


def test_a_layout_is_found_by_name():
    assert generator.layout("ppi").__module__ == "portbench_layout_ppi"
    with pytest.raises(SystemExit, match="no traffic layout"):
        generator.layout("no_such_layout")


@pytest.mark.parametrize("seed", [0, 1, -1, 2**31, 2**31 + 5, 2**64 + 9])
def test_derive_seed_range(seed):
    value = generator.derive_seed(seed, 4)
    assert 0 <= value < 2**32
    assert value == generator.derive_seed(seed, 4)
    assert value != generator.derive_seed(seed, 5)
    assert 0 <= generator.derive_seed(seed, 4, bits=63) < 2**63


def test_split_graphs_round_trips():
    small = dict(traffic("ppi_train"), draws=1, nodes_per_graph=30,
                 fwd_edges_per_graph=70)
    (draw,) = generator.generate(small, 5)
    graphs = list(generator.split_graphs(draw))
    assert len(graphs) == draw.num_graphs
    offset = 0
    rebuilt = [[] for _ in draw.edges]
    for features, adjacency, labels in graphs:
        assert labels.shape == (30, 121)
        for l, adj in enumerate(adjacency):
            assert adj.min() >= 0 and adj.max() < 30
            rebuilt[l].append(adj + offset)
        offset += features.shape[0]
    for l, parts in enumerate(rebuilt):
        np.testing.assert_array_equal(np.concatenate(parts), draw.edges[l])
