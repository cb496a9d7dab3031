"""Layout ``qm9``: a copy, draw for draw, of the raw arrays of
``tf2_gnn_tpu_torch/workloads.py::build_qm9_batch_host``:
``molecules_per_draw`` molecules of ``nodes_per_molecule`` nodes,
``edge_types`` types of ``edges_per_molecule`` uniform random edges a
molecule, ``feature_dim`` normal features, one normal regression target a
molecule."""
import numpy as np

from portbench.generator import Draw


def draw(seed: int, molecules_per_draw: int, nodes_per_molecule: int,
         edge_types: int, edges_per_molecule: int,
         feature_dim: int) -> Draw:
    rng = np.random.RandomState(seed)
    m, n, e = molecules_per_draw, nodes_per_molecule, edges_per_molecule
    base = (np.arange(m) * n)[:, None]
    edges = []
    for _ in range(edge_types):
        src = rng.randint(0, n, (m, e))
        tgt = rng.randint(0, n, (m, e))
        edges.append(np.stack([(src + base).reshape(-1),
                               (tgt + base).reshape(-1)],
                              axis=1).astype(np.int32))
    node_features = rng.randn(m * n, feature_dim).astype(np.float32)
    targets = rng.randn(m).astype(np.float32)
    return Draw(node_features=node_features, edges=edges,
                graph_nodes=[n] * m,
                graph_edges=[[e] * m for _ in range(edge_types)],
                graph_targets=targets)
