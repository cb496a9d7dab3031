"""QM9 molecular property regression with a gated per-node readout (port
of ``tf2_gnn_tpu/models/qm9_regression_task.py``).

Per node ``sigmoid(gate(initial features || final)) * transform(final)``,
both single linear layers with biases, summed per graph over the padded
graph count (pad nodes land in the pad-graph slot, which the loss masks).
The loss and metrics are the regression task's; the epoch MAE is also
reported against the property's chemical-accuracy normalising constant.

The reference passes ``out_layer_dropout_keep_prob`` as the MLPs' dropout
*rate*; with no hidden layers the MLP never applies dropout, so the value
has no effect. The port keeps both as they are.
"""
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..data.graph_batch import GraphBatch
from ..layers.mlp import MLP
from ..ops.segment import segment_sum
from .graph_regression_task import GraphRegressionTask
from .graph_task_model import GraphTaskModel

# Dataset-generation normalisation constants (reference
# qm9_regression.py:13-27).
CHEMICAL_ACC_NORMALISING_FACTORS = (
    0.066513725,
    0.012235489,
    0.071939046,
    0.033730778,
    0.033486113,
    0.004278493,
    0.001330901,
    0.004165489,
    0.004128926,
    0.00409976,
    0.004527465,
    0.012292586,
    0.037467458,
)


class QM9RegressionTask(GraphTaskModel):
    def __init__(self, params: Dict[str, Any], input_dim: int,
                 num_edge_types: int, task_id: int = 0):
        super().__init__(params, input_dim, num_edge_types)
        self.task_id = task_id
        rate = params.get("out_layer_dropout_keep_prob", 1.0)
        hidden = self.gnn.hidden_dim
        self.regression_transform = MLP(hidden, 1, hidden_layers=(),
                                        use_biases=True, dropout_rate=rate)
        self.regression_gate = MLP(input_dim + hidden, 1, hidden_layers=(),
                                   use_biases=True, dropout_rate=rate)

    @classmethod
    def get_default_hyperparameters(
            cls, mp_style: Optional[str] = None) -> Dict[str, Any]:
        params = super().get_default_hyperparameters(mp_style)
        params.update(
            {
                "use_intermediate_gnn_results": False,
                "out_layer_dropout_keep_prob": 1.0,
            }
        )
        return params

    @classmethod
    def _dataset_kwargs(cls, params: Dict[str, Any],
                        dataset) -> Dict[str, Any]:
        return {"task_id": int(dataset.params.get("task_id", 0))}

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        self.regression_transform.reset_parameters(generator)
        self.regression_gate.reset_parameters(generator)

    def compute_task_output(self, batch: GraphBatch, node_representations,
                            training: bool,
                            generator: Optional[torch.Generator] = None):
        if self.use_intermediate_gnn_results:
            node_representations, _ = node_representations
        per_node_output = self.regression_transform(
            node_representations, training, generator)  # [V, 1]
        per_node_weight = self.regression_gate(
            torch.cat([batch.node_features, node_representations], dim=-1),
            training, generator)  # [V, 1]
        per_node_weighted = (torch.sigmoid(per_node_weight)
                             * per_node_output).squeeze(-1)
        return segment_sum(per_node_weighted, batch.node_to_graph,
                           batch.num_graphs_padded, batch.spmd_axis)  # [G]

    EVAL_KIND = "regression"
    compute_task_metrics = staticmethod(GraphRegressionTask.compute_task_metrics)
    compute_epoch_metrics = staticmethod(
        GraphRegressionTask.compute_epoch_metrics)

    @classmethod
    def make_epoch_metrics_fn(cls, task_id: int):
        """Epoch metric closure with the chemical-accuracy error ratio of
        the QM9 property ``task_id`` (reference qm9_regression.py:927-949)."""

        def fn(task_results: List[Dict[str, Any]]) -> Tuple[float, str]:
            total_graphs = sum(float(r["num_graphs"]) for r in task_results)
            total_abs = sum(float(r["batch_absolute_error"])
                            for r in task_results)
            total_sq = sum(float(r["batch_squared_error"])
                           for r in task_results)
            mse, mae = total_sq / total_graphs, total_abs / total_graphs
            ratio = mae / CHEMICAL_ACC_NORMALISING_FACTORS[task_id]
            return mae, (
                f"Task {task_id} | MSE = {mse:.3f} | MAE = {mae:.3f} | "
                f"Error Ratio: {ratio:.3f}"
            )

        return fn
