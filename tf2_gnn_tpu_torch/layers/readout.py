"""Nodes-to-graph readouts (port of ``tf2_gnn_tpu/layers/readout.py``;
the reference's tf2_gnn/layers/nodes_to_graph_representation.py:51-314):
``WeightedSumGraphRepresentation`` and ``WASGraphRepresentation``, the
softmax-average and sigmoid-sum readouts concatenated and projected.

Per-graph segment ops use the static padded graph count; padded nodes land
in the reserved pad-graph slot, so real graphs are unaffected.
"""
from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..ops.activations import get_activation_function
from ..ops.segment import segment_mean, segment_softmax, segment_sum
from ..utils.init import init_dense_
from .mlp import MLP

WEIGHTINGS = ("none", "average", "softmax", "sigmoid")


class WeightedSumGraphRepresentation(nn.Module):
    """Multi-head weighted sum of transformed node representations per
    graph. Weightings: ``sigmoid`` (a gate per node and head), ``softmax``
    (normalised per graph), ``none`` (a plain segment sum) and ``average``
    (a segment mean)."""

    def __init__(self, input_dim: int, graph_representation_size: int,
                 num_heads: int, weighting_fun: str = "softmax",
                 scoring_mlp_layers: Union[int, Sequence[int]] = (128,),
                 scoring_mlp_activation_fun: str = "relu",
                 scoring_mlp_use_biases: bool = False,
                 scoring_mlp_dropout_rate: float = 0.2,
                 transformation_mlp_layers: Union[int, Sequence[int]] = (128,),
                 transformation_mlp_activation_fun: str = "relu",
                 transformation_mlp_use_biases: bool = False,
                 transformation_mlp_dropout_rate: float = 0.2,
                 transformation_mlp_result_lower_bound: Optional[float] = None,
                 transformation_mlp_result_upper_bound: Optional[float] = None):
        super().__init__()
        self.weighting = weighting_fun.lower()
        if self.weighting not in WEIGHTINGS:
            raise ValueError(f"Unknown weighting function {weighting_fun}.")
        if graph_representation_size % num_heads:
            raise ValueError(
                f"Number of heads {num_heads} must divide representation "
                f"size {graph_representation_size}.")
        self.graph_representation_size = graph_representation_size
        self.num_heads = num_heads
        self.lower_bound = transformation_mlp_result_lower_bound
        self.upper_bound = transformation_mlp_result_upper_bound
        if self.weighting in ("softmax", "sigmoid"):
            self.scoring_mlp = MLP(
                input_dim, num_heads, hidden_layers=scoring_mlp_layers,
                use_biases=scoring_mlp_use_biases,
                activation=scoring_mlp_activation_fun,
                dropout_rate=scoring_mlp_dropout_rate)
        self.transformation_act = get_activation_function(
            transformation_mlp_activation_fun)
        self.transformation_mlp = MLP(
            input_dim, graph_representation_size,
            hidden_layers=transformation_mlp_layers,
            use_biases=transformation_mlp_use_biases,
            activation=transformation_mlp_activation_fun,
            dropout_rate=transformation_mlp_dropout_rate)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for module in self.children():
            module.reset_parameters(generator)

    def forward(self, node_embeddings: torch.Tensor,
                node_to_graph: torch.Tensor, num_graphs: int,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                spmd_axis: Optional[str] = None) -> torch.Tensor:
        """[V, D] node embeddings -> [G, graph_representation_size]; with
        ``spmd_axis`` (the rows one shard of a node-partitioned graph) the
        per-graph softmax and sums span every shard, and the result is
        replicated."""
        weights = None
        if self.weighting in ("softmax", "sigmoid"):
            scores = self.scoring_mlp(node_embeddings, training, generator)
            if self.weighting == "sigmoid":
                weights = torch.sigmoid(scores)
            else:
                weights = segment_softmax(scores, node_to_graph, num_graphs,
                                          spmd_axis)

        node_reprs = self.transformation_act(
            self.transformation_mlp(node_embeddings, training, generator))
        if self.lower_bound is not None:
            node_reprs = torch.clamp(node_reprs, min=self.lower_bound)
        if self.upper_bound is not None:
            node_reprs = torch.clamp(node_reprs, max=self.upper_bound)

        if self.weighting == "none":
            return segment_sum(node_reprs, node_to_graph, num_graphs,
                               spmd_axis)
        if self.weighting == "average":
            return segment_mean(node_reprs, node_to_graph, num_graphs,
                                spmd_axis)
        head_dim = self.graph_representation_size // self.num_heads
        weighted = weights[:, :, None] * node_reprs.reshape(
            -1, self.num_heads, head_dim)
        return segment_sum(
            weighted.reshape(-1, self.graph_representation_size),
            node_to_graph, num_graphs, spmd_axis)


class WASGraphRepresentation(nn.Module):
    """Weighted-Average-and-Sum readout: concat(softmax-average readout
    ``weighted_avg``, sigmoid-sum readout ``weighted_sum``) projected back
    to ``graph_representation_size`` by ``out_projection`` (no bias)
    (reference nodes_to_graph_representation.py:232-314). The pooling MLP
    settings serve both readouts' scoring and transformation MLPs."""

    def __init__(self, input_dim: int, graph_representation_size: int = 128,
                 num_heads: int = 8,
                 pooling_mlp_layers: Union[int, Sequence[int]] = (128, 128),
                 pooling_mlp_activation_fun: str = "elu",
                 pooling_mlp_use_biases: bool = True,
                 pooling_mlp_dropout_rate: float = 0.0):
        super().__init__()
        common = dict(
            graph_representation_size=graph_representation_size,
            num_heads=num_heads,
            scoring_mlp_layers=pooling_mlp_layers,
            scoring_mlp_dropout_rate=pooling_mlp_dropout_rate,
            scoring_mlp_use_biases=pooling_mlp_use_biases,
            scoring_mlp_activation_fun=pooling_mlp_activation_fun,
            transformation_mlp_layers=pooling_mlp_layers,
            transformation_mlp_dropout_rate=pooling_mlp_dropout_rate,
            transformation_mlp_use_biases=pooling_mlp_use_biases,
            transformation_mlp_activation_fun=pooling_mlp_activation_fun,
        )
        self.weighted_avg = WeightedSumGraphRepresentation(
            input_dim, weighting_fun="softmax", **common)
        self.weighted_sum = WeightedSumGraphRepresentation(
            input_dim, weighting_fun="sigmoid", **common)
        self.out_projection = nn.Linear(2 * graph_representation_size,
                                        graph_representation_size,
                                        bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weighted_avg.reset_parameters(generator)
        self.weighted_sum.reset_parameters(generator)
        init_dense_(self.out_projection, generator)

    def forward(self, node_embeddings: torch.Tensor,
                node_to_graph: torch.Tensor, num_graphs: int,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                spmd_axis: Optional[str] = None) -> torch.Tensor:
        """[V, D] node embeddings -> [G, graph_representation_size]."""
        args = (node_to_graph, num_graphs, training, generator, spmd_axis)
        return self.out_projection(torch.cat(
            [self.weighted_avg(node_embeddings, *args),
             self.weighted_sum(node_embeddings, *args)], dim=-1))
