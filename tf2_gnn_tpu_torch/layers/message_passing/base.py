"""Message-passing template + registry (port of
``tf2_gnn_tpu/layers/message_passing/base.py``).

A layer maps node states ``[V, D] -> [V, hidden_dim]``: node-space
transforms run densely first, the block-pair streamed op aggregates them
over the edges, and ``_post_aggregate`` applies the message activation.

Only the fused paths (over pair plans and scatter plans) are ported. The
unfused per-edge segment path and the SPMD halo branches are not; a batch
without the plans a flavour's fused path reads (``_check_batch``) raises
``NotImplementedError`` instead of silently taking another path.
"""
import inspect
from typing import Any, Dict

import torch
from torch import nn

from ...data.graph_batch import GraphBatch
from ...ops.activations import get_activation_function

MESSAGE_PASSING_IMPLEMENTATIONS: Dict[str, type] = {}

# What the reference runs where no fused route applies; the port raises
# there, naming it.
UNFUSED_PATH = ("the unfused per-edge segment path, which is not ported "
                "(ROADMAP.md, queue A item 6)")


def register_message_passing_implementation(cls):
    """Register an MP flavour under its lowercased class name
    (reference: message_passing.py:221-227)."""
    MESSAGE_PASSING_IMPLEMENTATIONS[cls.__name__.lower()] = cls
    return cls


def get_message_passing_class(name: str):
    cls = MESSAGE_PASSING_IMPLEMENTATIONS.get(name.lower())
    if cls is None:
        raise ValueError(
            f"Unknown message passing class '{name}'. Known: "
            f"{sorted(MESSAGE_PASSING_IMPLEMENTATIONS)}"
        )
    return cls


def calculate_type_to_num_incoming_edges(batch: GraphBatch) -> torch.Tensor:
    """f32 [L, V]: the per-type in-degree of every node (reference
    base.py:60-79). Padded edges target the pad row, so the real rows are
    exact without a mask. A batch from ``pad_batch_arrays`` carries it
    (``in_degrees``, counted on the host); otherwise the edge targets are
    counted on their device, targets outside [0, V) dropped."""
    if batch.in_degrees is not None:
        return batch.in_degrees
    v = batch.num_nodes_padded
    return torch.stack([
        torch.bincount(tgt.long()[(tgt >= 0) & (tgt < v)],
                       minlength=v).to(torch.float32)
        for tgt in batch.edge_targets])


class MessagePassing(nn.Module):
    """Template for one message-passing step: ``[V, D] -> [V, hidden_dim]``.

    Subclasses implement ``_fused_sum_aggregate`` (the [V, H] sum-aggregated
    messages) and may override ``_post_aggregate``; one whose update never
    applies the message activation (GGNN's GRU, RGIN's aggregation MLP)
    sets ``_apply_message_activation`` False, and then the activation's
    place is no reason to leave the fused path (reference base.py:140-142).
    """

    _apply_message_activation = True

    def __init__(self, num_edge_types: int, input_dim: int,
                 hidden_dim: int = 7,
                 aggregation_function: str = "sum",
                 message_activation_function: str = "relu",
                 message_activation_before_aggregation: bool = False,
                 edge_dtype: str = "float32",
                 dense_dtype: str = "float32"):
        super().__init__()
        if aggregation_function != "sum":
            raise NotImplementedError(
                f"aggregation_function={aggregation_function!r}: only 'sum' "
                "(the pair kernels' aggregation) is ported.")
        if (message_activation_before_aggregation
                and self._apply_message_activation):
            raise NotImplementedError(
                "message_activation_before_aggregation=True needs the "
                "per-edge segment path, which is not ported.")
        self.num_edge_types = num_edge_types
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.message_activation_function = message_activation_function
        # Dtype of the per-edge message stream the kernels gather; the
        # aggregation accumulates in float32.
        self.edge_dtype = getattr(torch, edge_dtype)

    @classmethod
    def get_default_hyperparameters(cls) -> Dict[str, Any]:
        return {
            "aggregation_function": "sum",
            "message_activation_function": "relu",
            "message_activation_before_aggregation": False,
            "hidden_dim": 7,
            "edge_dtype": "float32",
            "dense_dtype": "float32",
        }

    @classmethod
    def from_params(cls, params: Dict[str, Any], num_edge_types: int,
                    input_dim: int) -> "MessagePassing":
        """Build from a flat hyperparameter dict, ignoring keys that are not
        constructor arguments of ``cls``."""
        accepted = set(inspect.signature(cls.__init__).parameters)
        accepted -= {"self", "num_edge_types", "input_dim"}
        kwargs = {k: v for k, v in params.items() if k in accepted}
        return cls(num_edge_types=num_edge_types, input_dim=input_dim,
                   **kwargs)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for module in self.children():
            module.reset_parameters(generator)

    def _fused_sum_aggregate(self, node_states: torch.Tensor,
                             batch: GraphBatch,
                             training: bool) -> torch.Tensor:
        raise NotImplementedError

    def _check_batch(self, batch: GraphBatch) -> None:
        """Raise ``NotImplementedError`` when ``batch`` lacks the device
        plans this flavour's fused path reads."""
        raise NotImplementedError

    def _post_aggregate(self, aggregated: torch.Tensor,
                        node_states: torch.Tensor, batch: GraphBatch,
                        training: bool) -> torch.Tensor:
        """The (after-aggregation) message activation."""
        return get_activation_function(self.message_activation_function)(
            aggregated)

    def forward(self, node_states: torch.Tensor, batch: GraphBatch,
                training: bool = False) -> torch.Tensor:
        self._check_batch(batch)
        fused = self._fused_sum_aggregate(node_states, batch, training)
        return self._post_aggregate(fused, node_states, batch, training)
