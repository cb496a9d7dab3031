"""RGCN message passing (port of
``tf2_gnn_tpu/layers/message_passing/rgcn.py``).

``h'_v = act(sum_l sum_{(u,v) in A_l} 1/c_{v,l} * W_l h_u)``: a
GNN_Edge_MLP with a 0-hidden-layer MLP on the source state and in-degree
normalisation (reference rgcn.py:50-59).
"""
from typing import Any, Dict

from .base import register_message_passing_implementation
from .gnn_edge_mlp import GNN_Edge_MLP


@register_message_passing_implementation
class RGCN(GNN_Edge_MLP):

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
