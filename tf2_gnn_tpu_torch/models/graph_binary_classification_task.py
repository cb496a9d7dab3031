"""Graph binary classification, a sigmoid on the regression head (port of
``tf2_gnn_tpu/models/graph_binary_classification_task.py``).

The loss is Keras' binary cross-entropy on probabilities clipped to
``[SMALL_NUMBER, 1 - SMALL_NUMBER]``, averaged over the real graphs.
"""
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..data.graph_batch import GraphBatch
from ..utils.constants import SMALL_NUMBER
from .graph_regression_task import GraphRegressionTask


class GraphBinaryClassificationTask(GraphRegressionTask):
    EVAL_KIND = "binary_classification"

    def compute_task_output(self, batch: GraphBatch, node_representations,
                            training: bool,
                            generator: Optional[torch.Generator] = None):
        return torch.sigmoid(super().compute_task_output(
            batch, node_representations, training, generator))

    @staticmethod
    def compute_task_metrics(batch: GraphBatch, task_output,
                             labels: Dict[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
        target = labels["target_value"]
        mask = batch.graph_mask
        num_graphs = max(float(batch.num_graphs), 1.0)
        probs = torch.clamp(task_output, SMALL_NUMBER, 1.0 - SMALL_NUMBER)
        per_graph_ce = -(target * torch.log(probs)
                         + (1.0 - target) * torch.log(1.0 - probs))
        ce = torch.sum(per_graph_ce * mask) / num_graphs
        num_correct = torch.sum((torch.round(task_output) == target) * mask)
        return {
            "loss": ce,
            "batch_acc": num_correct / num_graphs,
            "num_correct": num_correct,
            "num_graphs": num_graphs,
        }

    @staticmethod
    def compute_epoch_metrics(task_results: List[Dict[str, Any]]
                              ) -> Tuple[float, str]:
        total_graphs = sum(float(r["num_graphs"]) for r in task_results)
        total_correct = sum(float(r["num_correct"]) for r in task_results)
        acc = total_correct / total_graphs
        return -acc, f"Accuracy = {acc:.3f}"
