"""Per-node multiclass (multi-label) task, the PPI head (port of
``tf2_gnn_tpu/models/node_multiclass_task.py``).

A dense layer with bias maps final node states to per-node logits; the loss
is sigmoid cross-entropy summed over labels and averaged over REAL nodes;
the tracked metric is batch micro-F1, negated so that lower is better.
"""
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.graph_batch import GraphBatch
from ..utils.init import init_dense_
from ..utils.constants import SMALL_NUMBER
from .graph_task_model import GraphTaskModel


def masked_f1_counts(logits: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor, spmd_axis=None):
    """(TP, FP, FN) over real nodes, summed over the mesh axis
    ``spmd_axis`` when the nodes are one shard's."""
    # round(sigmoid(x)) == (x > 0), exactly.
    predicted = (logits > 0.0).to(logits.dtype) * mask[:, None]
    labels = labels * mask[:, None]
    true_pos = torch.sum(predicted * labels)
    false_pos = torch.sum(predicted * (1.0 - labels) * mask[:, None])
    false_neg = torch.sum((1.0 - predicted) * labels)
    if spmd_axis is not None:
        from ..parallel.collectives import psum_flat

        true_pos, false_pos, false_neg = psum_flat(
            [true_pos, false_pos, false_neg], spmd_axis)
    return true_pos, false_pos, false_neg


def f1_from_counts(true_pos, false_pos, false_neg):
    precision = true_pos / torch.clamp(true_pos + false_pos, min=SMALL_NUMBER)
    recall = true_pos / torch.clamp(true_pos + false_neg, min=SMALL_NUMBER)
    return (2.0 * precision * recall) / torch.clamp(precision + recall,
                                                    min=SMALL_NUMBER)


def masked_micro_f1(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor, spmd_axis=None) -> torch.Tensor:
    """Micro-averaged F1 over real nodes (reference micro_f1,
    node_multiclass_task.py:10-23, with padding masked out)."""
    return f1_from_counts(*masked_f1_counts(logits, labels, mask, spmd_axis))


class NodeMulticlassTask(GraphTaskModel):
    def __init__(self, params: Dict[str, Any], input_dim: int,
                 num_edge_types: int, num_labels: int = 121):
        super().__init__(params, input_dim, num_edge_types)
        self.num_labels = num_labels
        self.node_to_labels = nn.Linear(self.gnn.hidden_dim, num_labels,
                                        bias=True)

    @classmethod
    def get_default_hyperparameters(
            cls, mp_style: Optional[str] = None) -> Dict[str, Any]:
        return super().get_default_hyperparameters(mp_style)

    @classmethod
    def _dataset_kwargs(cls, params: Dict[str, Any],
                        dataset) -> Dict[str, Any]:
        if not hasattr(dataset, "num_node_target_labels"):
            raise ValueError(
                f"Provided dataset of type {type(dataset)} does not provide "
                "num_node_target_labels information.")
        return {"num_labels": dataset.num_node_target_labels}

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        init_dense_(self.node_to_labels, generator)

    def compute_task_output(self, batch: GraphBatch, node_representations,
                            training: bool,
                            generator: Optional[torch.Generator] = None):
        return (self.node_to_labels(node_representations),)

    @staticmethod
    def compute_task_metrics(batch: GraphBatch, task_output,
                             labels: Dict[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
        (x,) = task_output
        z = labels["node_labels"]
        mask = batch.node_mask
        # Numerically-stable sigmoid BCE with logits, summed over labels,
        # with the reference's derivatives at a logit of exactly 0 (a node
        # whose representation is all zeros): jnp.maximum's 1/2 and
        # jnp.abs's 1, so the two terms' slopes cancel there, where
        # clamp's 1 and abs's 0 would add 1.
        magnitude = torch.where(x >= 0.0, x, -x)
        per_entry = (torch.maximum(x, torch.zeros_like(x)) - x * z
                     + torch.log1p(torch.exp(-magnitude)))
        per_node = torch.sum(per_entry, dim=-1) * mask
        loss_sum = torch.sum(per_node)
        num_nodes = float(batch.num_nodes)
        if batch.spmd_axis is not None:
            # One shard of a node-partitioned graph: the loss over every
            # shard's nodes (its gradient flows back through the psum).
            from ..parallel.collectives import psum

            loss_sum = psum(loss_sum, batch.spmd_axis)
            num_nodes = float(psum(torch.tensor(
                num_nodes, device=x.device), batch.spmd_axis))
        loss = loss_sum / max(num_nodes, 1.0)
        tp, fp, fn = masked_f1_counts(x, z, mask, batch.spmd_axis)
        return {"loss": loss, "f1_score": f1_from_counts(tp, fp, fn),
                "num_graphs": batch.num_graphs,
                "f1_tp": tp, "f1_fp": fp, "f1_fn": fn}

    @staticmethod
    def compute_epoch_metrics(task_results: List[Dict[str, Any]]
                              ) -> Tuple[float, str]:
        """The unweighted mean of the batch F1s (the selection metric,
        negated), and the epoch's micro-F1 from the pooled TP/FP/FN
        counts, which small trailing batches do not bias."""
        avg_f1 = float(np.average([float(r["f1_score"])
                                   for r in task_results]))
        tp = float(np.sum([float(r.get("f1_tp", 0.0)) for r in task_results]))
        fp = float(np.sum([float(r.get("f1_fp", 0.0)) for r in task_results]))
        fn = float(np.sum([float(r.get("f1_fn", 0.0)) for r in task_results]))
        precision = tp / max(tp + fp, SMALL_NUMBER)
        recall = tp / max(tp + fn, SMALL_NUMBER)
        exact_f1 = (2.0 * precision * recall
                    / max(precision + recall, SMALL_NUMBER))
        return -avg_f1, (f"Avg MicroF1: {avg_f1:.3f} (exact epoch MicroF1: "
                         f"{exact_f1:.3f})")
