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
_pair_factorised_typed_sums``: the per-type streamed op over per-type pair
plans, or ``pair_typed_gather_scatter`` over a merged-target plan) and
``deg`` the per-type in-degree. On scatter plans a source-only FiLM
gathers its messages and gamma and beta per edge and sums ``gamma * msg +
beta`` by target (reference :86-132, ``_scatter_film``). The per-edge path
(:134-150), which the reference takes elsewhere, is not ported: there the
layer raises.
"""
from typing import Any, Dict, Sequence

import torch

from ...data.graph_batch import GraphBatch
from ...ops.sorted_spmm import (
    plan_gather_src,
    plan_gather_tgt_typed,
    plan_scatter,
)
from .base import (
    UNFUSED_PATH,
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
                 film_parameter_MLP_hidden_layers: Sequence[int] = (),
                 fused_target_gather: bool = True):
        if use_target_state_as_input and num_edge_MLP_hidden_layers:
            raise NotImplementedError(
                "GNN-FiLM with use_target_state_as_input=True and "
                f"num_edge_MLP_hidden_layers={num_edge_MLP_hidden_layers} "
                f"takes the per-edge path, {UNFUSED_PATH}; with 0 hidden "
                "layers it factorises.")
        super().__init__(num_edge_types, input_dim, hidden_dim,
                         aggregation_function, message_activation_function,
                         message_activation_before_aggregation, edge_dtype,
                         dense_dtype, use_target_state_as_input,
                         normalize_by_num_incoming,
                         num_edge_MLP_hidden_layers, fused_target_gather)
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

    def _route(self, batch: GraphBatch) -> str:
        """The fused route of the reference's ``_fused_sum_aggregate``
        (gnn_film.py:63-132): the factorised form over per-type or
        merged-target pair plans, else the scatter-plan form of a
        source-only FiLM with ``fused_target_gather``; raises where the
        reference takes its per-edge path."""
        if batch.pair_plans_typed is not None or (
                batch.pair_merged is not None and batch.pair_targets_merged):
            return "factorised"
        if (batch.scatter_merged is not None and self.fused_target_gather
                and not self.use_target_state_as_input):
            return "scatter_film"
        raise NotImplementedError(
            "GNN-FiLM needs per-type pair plans or a merged-target pair plan "
            "(the factorised form), or, source-only with "
            "fused_target_gather=True, scatter plans; on this batch the "
            f"reference takes {UNFUSED_PATH}.")

    def _scatter_film(self, node_states: torch.Tensor,
                      batch: GraphBatch) -> torch.Tensor:
        """The source-only FiLM over the scatter plan (reference
        gnn_film.py:86-132): each slot's message gathered by merged source
        (times its 1/deg scale when normalising), gamma and beta gathered
        from the type-minor [V*L, 2H] FiLM table in the edge dtype, and
        ``gamma * msg + beta`` summed by target (B12)."""
        plan = batch.scatter_merged
        v, num_types = batch.num_nodes_padded, self.num_edge_types
        tables = self._fused_node_space_tables(node_states, batch)
        film = self._film_parameter_tables(node_states)    # [L, V, 2H]
        film_tl = film[:, :v].transpose(0, 1).reshape(v * num_types, -1)
        msgs = plan_gather_src(tables, plan, self.edge_dtype).float()
        film_g = plan_gather_tgt_typed(film_tl, plan,
                                       self.edge_dtype).float()
        if self.normalize_by_num_incoming:
            msgs = msgs * plan.inv_fwd[:, None]
        gamma = film_g[:, :self.hidden_dim]
        beta = film_g[:, self.hidden_dim:]
        return plan_scatter(gamma * msgs + beta, plan)

    def _fused_sum_aggregate(self, node_states: torch.Tensor,
                             batch: GraphBatch,
                             training: bool) -> torch.Tensor:
        if self._route(batch) == "scatter_film":
            return self._scatter_film(node_states, batch)
        typed = self._pair_factorised_typed_sums(node_states, batch)
        film = self._film_parameter_tables(node_states)
        gamma = film[..., :self.hidden_dim]
        beta = film[..., self.hidden_dim:]
        deg = calculate_type_to_num_incoming_edges(batch)  # [L, V]
        return (gamma * typed + deg[..., None] * beta).sum(dim=0)
