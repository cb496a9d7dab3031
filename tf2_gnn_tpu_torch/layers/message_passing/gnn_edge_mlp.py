"""Edge-MLP message passing, source-only form (port of the pair branch of
``tf2_gnn_tpu/layers/message_passing/gnn_edge_mlp.py``).

``msg = MLP_l(h_src)``, optionally scaled by 1/(per-type in-degree of the
target + eps). The per-type MLP (N hidden layers of size hidden_dim with
ReLU, a final linear layer, no biases) is pointwise in the source node, so
it runs densely in node space for all types at once and the block-pair
streamed op gathers and sums its rows per edge.

The target-state forms (``use_target_state_as_input=True``) are not ported
and raise.
"""
from typing import Any, Dict, List

import torch

from ...data.graph_batch import GraphBatch
from ...ops.pair_spmm import pair_stream_joint
from .base import MessagePassing, register_message_passing_implementation
from .typed_linear import TypedLinear


@register_message_passing_implementation
class GNN_Edge_MLP(MessagePassing):

    def __init__(self, num_edge_types: int, input_dim: int,
                 hidden_dim: int = 7,
                 aggregation_function: str = "sum",
                 message_activation_function: str = "relu",
                 message_activation_before_aggregation: bool = False,
                 edge_dtype: str = "float32",
                 dense_dtype: str = "float32",
                 use_target_state_as_input: bool = True,
                 normalize_by_num_incoming: bool = False,
                 num_edge_MLP_hidden_layers: int = 1):
        super().__init__(num_edge_types, input_dim, hidden_dim,
                         aggregation_function, message_activation_function,
                         message_activation_before_aggregation, edge_dtype,
                         dense_dtype)
        if use_target_state_as_input:
            raise NotImplementedError(
                "use_target_state_as_input=True (target-state edge MLPs) is "
                "not ported; only the source-only form is.")
        self.normalize_by_num_incoming = normalize_by_num_incoming
        self.num_edge_MLP_hidden_layers = num_edge_MLP_hidden_layers
        sizes = self._edge_mlp_layer_sizes()
        dims = [input_dim] + sizes[:-1]
        for i, size in enumerate(sizes):
            self.add_module(f"edge_mlp_layer_{i}", TypedLinear(
                num_edge_types, dims[i], size, compute_dtype=dense_dtype))

    @classmethod
    def get_default_hyperparameters(cls) -> Dict[str, Any]:
        params = super().get_default_hyperparameters()
        params.update(
            {
                "use_target_state_as_input": True,
                "normalize_by_num_incoming": False,
                "num_edge_MLP_hidden_layers": 1,
                "fused_target_gather": True,
            }
        )
        return params

    def _edge_mlp_layer_sizes(self) -> List[int]:
        return ([self.hidden_dim] * self.num_edge_MLP_hidden_layers
                + [self.hidden_dim])

    def _fused_node_space_tables(self, node_states: torch.Tensor,
                                 batch: GraphBatch) -> torch.Tensor:
        """The per-type message MLP run densely in node space -> f32
        [L*V, H]. The reference casts these tables to ``edge_dtype`` here;
        the port casts inside the pair op (``pair_stream_joint``'s
        ``stream_dtype``) so that their gradient stays float32 as in the
        reference."""
        hidden = node_states  # [V, D] -> [L, V, *]
        for i in range(len(self._edge_mlp_layer_sizes())):
            hidden = getattr(self, f"edge_mlp_layer_{i}")(hidden)
            if i < self.num_edge_MLP_hidden_layers:
                hidden = torch.relu(hidden)
        return hidden.reshape(self.num_edge_types * hidden.shape[1], -1)

    def _pair_sum_aggregate(self, tables: torch.Tensor,
                            batch: GraphBatch) -> torch.Tensor:
        """Joint [V, H] sum over all types via the streamed pair op: the
        joint kernel forward, the stream kernel on the un-broadcast [V, H]
        cotangent backward."""
        return pair_stream_joint(tables, batch.pair_stream_joint,
                                 self.normalize_by_num_incoming,
                                 stream_dtype=self.edge_dtype)

    def _check_batch(self, batch: GraphBatch) -> None:
        if batch.pair_stream_joint is None:
            raise NotImplementedError(
                "this batch has no per-type pair plans on its device: build "
                "it with pair_plans_typed and move it with .to(device). The "
                "unfused segment path and the SPMD halo branches are not "
                "ported.")

    def _fused_sum_aggregate(self, node_states: torch.Tensor,
                             batch: GraphBatch,
                             training: bool) -> torch.Tensor:
        tables = self._fused_node_space_tables(node_states, batch)
        return self._pair_sum_aggregate(tables, batch)
