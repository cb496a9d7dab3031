"""Graph-level regression task (port of
``tf2_gnn_tpu/models/graph_regression_task.py``).

The readout's node representations are the raw input features concatenated
with every message-passing layer's output (the initial projection's is
skipped) when ``use_intermediate_gnn_results`` is on, the default for this
task, else with the final node states. Two weighted-sum readouts
(softmax-weighted average and sigmoid-gated sum, ELU MLPs) are
concatenated and fed to a relu regression MLP with biases. Flax infers the
readouts' input width; here it is stated: ``D + L * H`` with intermediates
(``D`` input features, ``L`` layers, ``H`` hidden), else ``D + H``.
"""
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..data.graph_batch import GraphBatch
from ..layers.mlp import MLP
from ..layers.readout import WeightedSumGraphRepresentation
from .graph_task_model import GraphTaskModel

# The head's hyperparameters and their defaults (reference
# graph_regression_task.py:18-42); a missing key takes its default.
HEAD_DEFAULTS = {
    "use_intermediate_gnn_results": True,
    "graph_aggregation_output_size": 32,
    "graph_aggregation_num_heads": 4,
    "graph_aggregation_layers": (32, 32),
    "graph_aggregation_dropout_rate": 0.1,
    "regression_mlp_layers": (64, 32),
    "regression_mlp_dropout": 0.1,
}


class GraphRegressionTask(GraphTaskModel):
    # The detailed evaluation of harness/evaluation.py.
    EVAL_KIND = "regression"

    def __init__(self, params: Dict[str, Any], input_dim: int,
                 num_edge_types: int):
        params = {**HEAD_DEFAULTS, **params}
        super().__init__(params, input_dim, num_edge_types)
        hidden = self.gnn.hidden_dim
        readout_dim = input_dim + (self.gnn.num_layers * hidden
                                   if self.use_intermediate_gnn_results
                                   else hidden)
        size = params["graph_aggregation_output_size"]
        layers = tuple(params["graph_aggregation_layers"])
        rate = params["graph_aggregation_dropout_rate"]
        common = dict(
            graph_representation_size=size,
            num_heads=params["graph_aggregation_num_heads"],
            scoring_mlp_layers=layers,
            scoring_mlp_dropout_rate=rate,
            scoring_mlp_activation_fun="elu",
            transformation_mlp_layers=layers,
            transformation_mlp_dropout_rate=rate,
            transformation_mlp_activation_fun="elu",
        )
        self.weighted_avg_readout = WeightedSumGraphRepresentation(
            readout_dim, weighting_fun="softmax", **common)
        self.weighted_sum_readout = WeightedSumGraphRepresentation(
            readout_dim, weighting_fun="sigmoid", **common)
        self.regression_mlp = MLP(
            2 * size, 1, hidden_layers=tuple(params["regression_mlp_layers"]),
            use_biases=True, activation="relu",
            dropout_rate=params["regression_mlp_dropout"])

    @classmethod
    def get_default_hyperparameters(
            cls, mp_style: Optional[str] = None) -> Dict[str, Any]:
        params = super().get_default_hyperparameters(mp_style)
        params.update({k: list(v) if isinstance(v, tuple) else v
                       for k, v in HEAD_DEFAULTS.items()})
        return params

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        self.weighted_avg_readout.reset_parameters(generator)
        self.weighted_sum_readout.reset_parameters(generator)
        self.regression_mlp.reset_parameters(generator)

    def _node_representations_for_readout(self, batch: GraphBatch,
                                          node_representations):
        if self.use_intermediate_gnn_results:
            _, intermediates = node_representations
            # intermediates[0] is the initial projection's output (reference
            # graph_regression_task.py:607-615).
            return torch.cat((batch.node_features,) + tuple(intermediates[1:]),
                             dim=-1)
        return torch.cat([batch.node_features, node_representations], dim=-1)

    def compute_task_output(self, batch: GraphBatch, node_representations,
                            training: bool,
                            generator: Optional[torch.Generator] = None):
        node_reprs = self._node_representations_for_readout(
            batch, node_representations)
        args = (batch.node_to_graph, batch.num_graphs_padded, training,
                generator, batch.spmd_axis)
        graph_reprs = torch.cat([self.weighted_avg_readout(node_reprs, *args),
                                 self.weighted_sum_readout(node_reprs, *args)],
                                dim=-1)
        return self.regression_mlp(graph_reprs, training,
                                   generator).squeeze(-1)  # [G]

    @staticmethod
    def compute_task_metrics(batch: GraphBatch, task_output,
                             labels: Dict[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
        """Mean squared error over the real graphs (the loss) and the
        squared and absolute error sums."""
        target = labels["target_value"]
        num_graphs = max(float(batch.num_graphs), 1.0)
        err = (task_output - target) * batch.graph_mask
        mse = torch.sum(err * err) / num_graphs
        mae = torch.sum(torch.abs(err)) / num_graphs
        return {
            "loss": mse,
            "batch_squared_error": mse * num_graphs,
            "batch_absolute_error": mae * num_graphs,
            "num_graphs": num_graphs,
        }

    @staticmethod
    def compute_epoch_metrics(task_results: List[Dict[str, Any]]
                              ) -> Tuple[float, str]:
        total_graphs = sum(float(r["num_graphs"]) for r in task_results)
        total_abs = sum(float(r["batch_absolute_error"]) for r in task_results)
        total_sq = sum(float(r["batch_squared_error"]) for r in task_results)
        mse, mae = total_sq / total_graphs, total_abs / total_graphs
        return mae, f" MSE = {mse:.3f} | MAE = {mae:.3f}"
