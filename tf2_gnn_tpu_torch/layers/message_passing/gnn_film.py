"""GNN-FiLM message passing (port of the factorised pair path of
``tf2_gnn_tpu/layers/message_passing/gnn_film.py``).

``msg' = gamma_l(h_tgt) * msg + beta_l(h_tgt)``, the FiLM modulation of
the (normalised) GNN_Edge_MLP message by parameters of the target state
and the edge type (reference gnn_film.py:23-84). The FiLM parameter MLP
(``film_mlp_layer_i``: ``film_parameter_MLP_hidden_layers`` hidden layers
with ReLU, then a linear to 2H, per type, no biases) runs in node space,
and since gamma and beta depend only on the target and the type, the
aggregated modulated messages factorise into node-space math:

    out[v] = sum_l gamma_l[v] * S_l[v] + deg_l[v] * beta_l[v],

with ``S_l`` the per-type aggregated messages of the source-only MLP or
of the 0-hidden target-state form (``GNN_Edge_MLP.
_pair_factorised_typed_sums``, the per-type streamed op over per-type pair
plans) and ``deg`` the per-type in-degree. The scatter-plan fallback
(reference :86-132) and the per-edge path (:134-150) are not ported; a
batch without per-type pair plans raises.
"""
from typing import Any, Dict, Sequence

import torch

from ...data.graph_batch import GraphBatch
from .base import (
    calculate_type_to_num_incoming_edges,
    register_message_passing_implementation,
)
from .gnn_edge_mlp import GNN_Edge_MLP
from .typed_linear import TypedLinear


@register_message_passing_implementation
class GNN_FiLM(GNN_Edge_MLP):

    def __init__(self, num_edge_types: int, input_dim: int,
                 hidden_dim: int = 7,
                 aggregation_function: str = "sum",
                 message_activation_function: str = "relu",
                 message_activation_before_aggregation: bool = False,
                 edge_dtype: str = "float32",
                 dense_dtype: str = "float32",
                 use_target_state_as_input: bool = False,
                 normalize_by_num_incoming: bool = False,
                 num_edge_MLP_hidden_layers: int = 0,
                 film_parameter_MLP_hidden_layers: Sequence[int] = ()):
        if use_target_state_as_input and num_edge_MLP_hidden_layers:
            raise NotImplementedError(
                "GNN-FiLM with use_target_state_as_input=True and "
                f"num_edge_MLP_hidden_layers={num_edge_MLP_hidden_layers} "
                "takes the per-edge path, which is not ported; with 0 "
                "hidden layers it factorises.")
        super().__init__(num_edge_types, input_dim, hidden_dim,
                         aggregation_function, message_activation_function,
                         message_activation_before_aggregation, edge_dtype,
                         dense_dtype, use_target_state_as_input,
                         normalize_by_num_incoming,
                         num_edge_MLP_hidden_layers)
        sizes = [int(s) for s in film_parameter_MLP_hidden_layers]
        self.num_film_hidden_layers = len(sizes)
        dims = [input_dim] + sizes
        for i, size in enumerate(sizes + [2 * hidden_dim]):
            self.add_module(f"film_mlp_layer_{i}", TypedLinear(
                num_edge_types, dims[i], size, compute_dtype=dense_dtype))

    @classmethod
    def get_default_hyperparameters(cls) -> Dict[str, Any]:
        params = super().get_default_hyperparameters()
        params.update(
            {
                "use_target_state_as_input": False,
                "normalize_by_num_incoming": False,
                "num_edge_MLP_hidden_layers": 0,
                "film_parameter_MLP_hidden_layers": [],
            }
        )
        return params

    def _film_parameter_tables(self, node_states: torch.Tensor
                               ) -> torch.Tensor:
        """The FiLM parameter MLP run densely in node space -> f32
        [L, V, 2H] (gamma, then beta)."""
        film = node_states
        for i in range(self.num_film_hidden_layers + 1):
            film = getattr(self, f"film_mlp_layer_{i}")(film)
            if i < self.num_film_hidden_layers:
                film = torch.relu(film)
        return film.to(torch.float32)

    def _check_batch(self, batch: GraphBatch) -> None:
        self._check_typed_batch(batch, "GNN-FiLM")

    def _fused_sum_aggregate(self, node_states: torch.Tensor,
                             batch: GraphBatch,
                             training: bool) -> torch.Tensor:
        typed = self._pair_factorised_typed_sums(node_states, batch)
        film = self._film_parameter_tables(node_states)
        gamma = film[..., :self.hidden_dim]
        beta = film[..., self.hidden_dim:]
        deg = calculate_type_to_num_incoming_edges(batch)  # [L, V]
        return (gamma * typed + deg[..., None] * beta).sum(dim=0)
