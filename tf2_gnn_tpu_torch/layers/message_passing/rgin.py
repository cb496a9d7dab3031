"""RGIN message passing (port of
``tf2_gnn_tpu/layers/message_passing/rgin.py``).

``h'_v = act(MLP_aggr(sum_l sum_{(u,v) in A_l} MLP_l(h_u)))``: a
source-only edge MLP (by default one hidden layer), whose whole MLP runs in
node space before the joint streamed sum; then the optional aggregation
MLP ``aggregation_mlp`` (``layers/mlp.py``: ``num_aggr_MLP_hidden_layers``
hidden layers of ``hidden_dim``, no biases), then the message activation
(reference rgin.py:61-106).
"""
from typing import Any, Dict, Optional

import torch

from ...data.graph_batch import GraphBatch
from ...ops.activations import get_activation_function
from ..mlp import MLP
from .base import register_message_passing_implementation
from .gnn_edge_mlp import GNN_Edge_MLP


@register_message_passing_implementation
class RGIN(GNN_Edge_MLP):
    # The activation always runs after the (optional) aggregation MLP.
    _apply_message_activation = False

    def __init__(self, num_edge_types: int, input_dim: int,
                 hidden_dim: int = 7,
                 aggregation_function: str = "sum",
                 message_activation_function: str = "relu",
                 message_activation_before_aggregation: bool = False,
                 edge_dtype: str = "float32",
                 dense_dtype: str = "float32",
                 use_target_state_as_input: bool = False,
                 normalize_by_num_incoming: bool = False,
                 num_edge_MLP_hidden_layers: int = 1,
                 num_aggr_MLP_hidden_layers: Optional[int] = None):
        super().__init__(num_edge_types, input_dim, hidden_dim,
                         aggregation_function, message_activation_function,
                         message_activation_before_aggregation, edge_dtype,
                         dense_dtype, use_target_state_as_input,
                         normalize_by_num_incoming,
                         num_edge_MLP_hidden_layers)
        self.num_aggr_MLP_hidden_layers = num_aggr_MLP_hidden_layers
        if num_aggr_MLP_hidden_layers is not None:
            self.aggregation_mlp = MLP(
                hidden_dim, hidden_dim,
                hidden_layers=[hidden_dim] * num_aggr_MLP_hidden_layers)

    @classmethod
    def get_default_hyperparameters(cls) -> Dict[str, Any]:
        params = super().get_default_hyperparameters()
        params.update(
            {
                "use_target_state_as_input": False,
                "num_edge_MLP_hidden_layers": 1,
                "num_aggr_MLP_hidden_layers": None,
            }
        )
        return params

    def _post_aggregate(self, aggregated: torch.Tensor,
                        node_states: torch.Tensor, batch: GraphBatch,
                        training: bool) -> torch.Tensor:
        if self.num_aggr_MLP_hidden_layers is not None:
            aggregated = self.aggregation_mlp(aggregated, training=training)
        return get_activation_function(self.message_activation_function)(
            aggregated)
