"""Graph-global information exchange (port of
``tf2_gnn_tpu/layers/global_exchange.py``; the reference's
tf2_gnn/layers/graph_global_exchange.py:20-183).

A weighted-sum readout computes a summary per graph, which is broadcast
back to the nodes (``gather_rows`` over ``node_to_graph``), dropped out in
training and combined with the node states: their mean, a GRU step (the
summary is the GRU's input, the node state its state) or an MLP of their
concatenation. On one shard of a node-partitioned graph (``spmd_axis``)
the summary spans every shard. Module names follow the flax tree
(``node_to_graph_representation``, ``gru_cell``, ``combine_mlp``).
"""
from typing import Optional

import torch
from torch import nn

from ..ops.gru import GRUCell
from ..ops.segment import gather_rows
from .dropout import dropout
from .mlp import MLP
from .readout import WeightedSumGraphRepresentation


class GraphGlobalExchange(nn.Module):
    """Base class: ``dropout(broadcast(readout(nodes)))`` per node; the
    subclasses combine it with the node states."""

    def __init__(self, hidden_dim: int, weighting_fun: str = "softmax",
                 num_heads: int = 4, dropout_rate: float = 0.0):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.dropout_rate = dropout_rate
        self.node_to_graph_representation = WeightedSumGraphRepresentation(
            hidden_dim, graph_representation_size=hidden_dim,
            num_heads=num_heads, weighting_fun=weighting_fun,
            scoring_mlp_layers=(hidden_dim,))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for module in self.children():
            module.reset_parameters(generator)

    def _per_node_graph_representations(
            self, node_embeddings: torch.Tensor, node_to_graph: torch.Tensor,
            num_graphs: int, training: bool,
            generator: Optional[torch.Generator],
            spmd_axis: Optional[str] = None) -> torch.Tensor:
        graph_reprs = self.node_to_graph_representation(
            node_embeddings, node_to_graph, num_graphs, training, generator,
            spmd_axis)
        per_node = gather_rows(graph_reprs, node_to_graph)  # [V, H]
        if training and self.dropout_rate > 0.0:
            if generator is None:
                raise ValueError("training with dropout needs an explicit "
                                 "torch.Generator")
            per_node = dropout(per_node, self.dropout_rate, generator)
        return per_node


class GraphGlobalMeanExchange(GraphGlobalExchange):
    def forward(self, node_embeddings, node_to_graph, num_graphs: int,
                training: bool = False, generator=None,
                spmd_axis=None) -> torch.Tensor:
        per_node = self._per_node_graph_representations(
            node_embeddings, node_to_graph, num_graphs, training, generator,
            spmd_axis)
        return (node_embeddings + per_node) / 2.0


class GraphGlobalGRUExchange(GraphGlobalExchange):
    def __init__(self, hidden_dim: int, **kwargs):
        super().__init__(hidden_dim, **kwargs)
        self.gru_cell = GRUCell(hidden_dim, hidden_dim)

    def forward(self, node_embeddings, node_to_graph, num_graphs: int,
                training: bool = False, generator=None,
                spmd_axis=None) -> torch.Tensor:
        per_node = self._per_node_graph_representations(
            node_embeddings, node_to_graph, num_graphs, training, generator,
            spmd_axis)
        return self.gru_cell(per_node, node_embeddings)


class GraphGlobalMLPExchange(GraphGlobalExchange):
    def __init__(self, hidden_dim: int, **kwargs):
        super().__init__(hidden_dim, **kwargs)
        self.combine_mlp = MLP(2 * hidden_dim, hidden_dim)

    def forward(self, node_embeddings, node_to_graph, num_graphs: int,
                training: bool = False, generator=None,
                spmd_axis=None) -> torch.Tensor:
        per_node = self._per_node_graph_representations(
            node_embeddings, node_to_graph, num_graphs, training, generator,
            spmd_axis)
        return self.combine_mlp(
            torch.cat([per_node, node_embeddings], dim=-1), training,
            generator)


GLOBAL_EXCHANGE_MODES = {
    "mean": GraphGlobalMeanExchange,
    "gru": GraphGlobalGRUExchange,
    "mlp": GraphGlobalMLPExchange,
}


def get_global_exchange_class(mode: str):
    cls = GLOBAL_EXCHANGE_MODES.get(mode.lower())
    if cls is None:
        raise ValueError(
            f"Unknown global_exchange_mode {mode} - has to be one of "
            f"{sorted(GLOBAL_EXCHANGE_MODES)}!")
    return cls
