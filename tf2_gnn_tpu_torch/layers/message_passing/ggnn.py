"""GGNN message passing (port of
``tf2_gnn_tpu/layers/message_passing/ggnn.py``).

``h'_v = GRU(sum_l sum_{(u,v) in A_l} 1/c_{v,l} * W_l h_u, h_v)``: RGCN's
messages (a source-only edge MLP, by default with 0 hidden layers and
in-degree normalisation), no message activation, and the node update by
one GRU cell ``gru_cell`` (``ops/gru.py``: Keras math, gates in the
Keras order, the flax parameter layout), which needs the node state
width to equal ``hidden_dim`` (reference ggnn.py:47-89).
"""
from typing import Any, Dict

import torch

from ...data.graph_batch import GraphBatch
from ...ops.gru import GRUCell
from .base import register_message_passing_implementation
from .gnn_edge_mlp import GNN_Edge_MLP


@register_message_passing_implementation
class GGNN(GNN_Edge_MLP):
    # The GRU is the update: no message activation anywhere.
    _apply_message_activation = False

    def __init__(self, num_edge_types: int, input_dim: int,
                 hidden_dim: int = 7,
                 aggregation_function: str = "sum",
                 message_activation_function: str = "relu",
                 message_activation_before_aggregation: bool = False,
                 edge_dtype: str = "float32",
                 dense_dtype: str = "float32",
                 use_target_state_as_input: bool = False,
                 normalize_by_num_incoming: bool = True,
                 num_edge_MLP_hidden_layers: int = 0,
                 fused_target_gather: bool = True):
        super().__init__(num_edge_types, input_dim, hidden_dim,
                         aggregation_function, message_activation_function,
                         message_activation_before_aggregation, edge_dtype,
                         dense_dtype, use_target_state_as_input,
                         normalize_by_num_incoming,
                         num_edge_MLP_hidden_layers, fused_target_gather)
        self.gru_cell = GRUCell(hidden_dim, hidden_dim)

    @classmethod
    def get_default_hyperparameters(cls) -> Dict[str, Any]:
        params = super().get_default_hyperparameters()
        params.update(
            {
                "use_target_state_as_input": False,
                "normalize_by_num_incoming": True,
                "num_edge_MLP_hidden_layers": 0,
            }
        )
        return params

    def _post_aggregate(self, aggregated: torch.Tensor,
                        node_states: torch.Tensor, batch: GraphBatch,
                        training: bool) -> torch.Tensor:
        if node_states.shape[-1] != self.hidden_dim:
            raise ValueError(
                "GGNN requires node state dim == hidden_dim "
                f"({node_states.shape[-1]} != {self.hidden_dim}).")
        return self.gru_cell(aggregated, node_states)
