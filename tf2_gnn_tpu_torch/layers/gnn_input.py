"""GNNInput, the reference's library-embedding entry point (port of
``tf2_gnn_tpu/layers/gnn_input.py``).

Reference: tf2_gnn/layers/gnn.py:21-30 exposes ``GNN(params)(GNNInput(...))``
for users embedding the encoder in their own models. The port's encoder
consumes padded ``GraphBatch``es; build a ``GNNInput`` from ragged arrays
and convert it with ``batch_from_gnn_input`` (budgets derived from the
input unless pinned). The batch carries no plans, so the encoder takes the
unfused per-edge route on it, as the JAX package's does; move it to the
model's device with ``.to(device)``.
"""
from typing import NamedTuple, Optional, Sequence

import numpy as np

from ..data.graph_batch import GraphBatch, PaddingConfig, pad_batch_arrays
from ..utils.shapes import round_up


class GNNInput(NamedTuple):
    """Ragged GNN encoder input, mirroring the reference's NamedTuple.

    * ``node_features``: float [V, D]
    * ``adjacency_lists``: one int [E_l, 2] array per edge type (row = (u, v),
      messages flow u -> v)
    * ``node_to_graph_map``: int [V]
    * ``num_graphs``: int
    """

    node_features: np.ndarray
    adjacency_lists: Sequence[np.ndarray]
    node_to_graph_map: np.ndarray
    num_graphs: int


def batch_from_gnn_input(
    gnn_input: GNNInput,
    config: Optional[PaddingConfig] = None,
    node_alignment: int = 64,
    edge_alignment: int = 64,
) -> GraphBatch:
    """Pad a ragged ``GNNInput`` into a static-shape host ``GraphBatch``.

    Without an explicit ``config`` the budgets are derived from this input
    (aligned up); pin a config to give many inputs one set of shapes.
    """
    node_features = np.asarray(gnn_input.node_features, dtype=np.float32)
    adjacency = [
        np.asarray(a, dtype=np.int32).reshape(-1, 2)
        for a in gnn_input.adjacency_lists
    ]
    if config is None:
        config = PaddingConfig(
            num_nodes=round_up(node_features.shape[0] + 1, node_alignment),
            num_graphs=int(gnn_input.num_graphs) + 1,
            edge_budgets=tuple(
                round_up(a.shape[0], edge_alignment) for a in adjacency
            ),
        )
    return pad_batch_arrays(
        node_features=node_features,
        adjacency_lists=adjacency,
        node_to_graph=np.asarray(gnn_input.node_to_graph_map, dtype=np.int32),
        num_graphs=int(gnn_input.num_graphs),
        config=config,
    )
