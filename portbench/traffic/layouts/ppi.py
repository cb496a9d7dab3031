"""Layout ``ppi``: a copy, draw for draw, of
``tf2_gnn_tpu_torch/workloads.py::build_raw_arrays`` and the node labels of
``build_ppi_batch_host``: ``graphs_per_draw`` graphs of ``nodes_per_graph``
nodes, three edge types (self loops, ``fwd_edges_per_graph`` uniform random
forward edges a graph and their reverses), ``feature_dim`` normal
features, ``num_labels`` labels a node positive with probability
``label_rate``."""
import numpy as np

from portbench.generator import Draw


def draw(seed: int, graphs_per_draw: int, nodes_per_graph: int,
         fwd_edges_per_graph: int, feature_dim: int, num_labels: int,
         label_rate: float) -> Draw:
    rng = np.random.RandomState(seed)
    n, e = nodes_per_graph, fwd_edges_per_graph
    fwd_chunks, bkwd_chunks, loop_chunks = [], [], []
    for g in range(graphs_per_draw):
        base = g * n
        src = rng.randint(0, n, e) + base
        tgt = rng.randint(0, n, e) + base
        fwd_chunks.append(np.stack([src, tgt], axis=1))
        bkwd_chunks.append(np.stack([tgt, src], axis=1))
        nodes = np.arange(base, base + n)
        loop_chunks.append(np.stack([nodes, nodes], axis=1))
    edges = [np.concatenate(c).astype(np.int32)
         for c in (loop_chunks, fwd_chunks, bkwd_chunks)]
    node_features = rng.randn(graphs_per_draw * n,
                              feature_dim).astype(np.float32)
    # The labels come from a second stream of the same seed, as
    # build_ppi_batch_host draws them.
    labels = (np.random.RandomState(seed).rand(graphs_per_draw * n,
                                               num_labels)
              > 1.0 - label_rate).astype(np.float32)
    return Draw(node_features=node_features, edges=edges,
                graph_nodes=[n] * graphs_per_draw,
                graph_edges=[[n] * graphs_per_draw, [e] * graphs_per_draw,
                             [e] * graphs_per_draw],
                node_labels=labels)
