"""Edge-MLP message passing (port of the pair branches of
``tf2_gnn_tpu/layers/message_passing/gnn_edge_mlp.py``).

``msg = MLP_l(h_src [|| h_tgt])``, optionally scaled by 1/(per-type
in-degree of the target + eps); the per-type MLP has N hidden layers of
size hidden_dim with ReLU, a final linear layer and no biases. Two forms
are ported:

* source-only (``use_target_state_as_input=False``, RGCN's form): the MLP
  is pointwise in the source node, so it runs densely in node space for
  all types at once, and its rows are gathered and summed per edge by the
  block-pair streamed op over per-type pair plans, or, on a batch with
  scatter plans instead, by ``typed_gather_scatter``, the scatter-plan
  route (``ops/sorted_spmm.py``);
* target-state input with ONE hidden layer, the reference's default
  (``_pair_target_state_one_hidden``): the first layer splits into source
  and target halves run in node space, ``A = W1_src h`` over all rows and
  ``B = W1_tgt h`` in merged-target layout, and since the layers are
  bias-free the second linear commutes with the sum over edges:

      out[v] = sum_l W2_l @ R[l*V + v],
      R[t]   = sum over edges e=(u -> t) of s_e * relu(A[src_e] + B[t]),

  which the relu-pair op (``ops/pair_edge_mlp.py``) computes over a
  merged-target plan, with ``s_e`` 1 or the plan's 1/deg scales.

The target-state forms with 0 or with 2 or more hidden layers, the
target-state forms on scatter plans, and the source-only form on merged
pair plans are not ported and raise.
"""
from typing import Any, Dict, List

import torch

from ...data.graph_batch import GraphBatch
from ...ops.pair_edge_mlp import (
    pair_edge_mlp_applicable,
    pair_relu_mlp_aggregate,
)
from ...ops.pair_spmm import pair_stream_joint, pair_unit_scales
from ...ops.sorted_spmm import typed_gather_scatter
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
        if use_target_state_as_input and num_edge_MLP_hidden_layers != 1:
            raise NotImplementedError(
                "use_target_state_as_input=True with "
                f"num_edge_MLP_hidden_layers={num_edge_MLP_hidden_layers} is "
                "not ported; the target-state form with one hidden layer "
                "is.")
        self.use_target_state_as_input = use_target_state_as_input
        self.normalize_by_num_incoming = normalize_by_num_incoming
        self.num_edge_MLP_hidden_layers = num_edge_MLP_hidden_layers
        if use_target_state_as_input:
            for name, dims in (("edge_mlp_src_0", (input_dim, hidden_dim)),
                               ("edge_mlp_tgt_0", (input_dim, hidden_dim)),
                               ("edge_mlp_layer_1", (hidden_dim,
                                                     hidden_dim))):
                self.add_module(name, TypedLinear(
                    num_edge_types, *dims, compute_dtype=dense_dtype))
            return
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
        the port casts inside the aggregation op (its ``stream_dtype``) so
        that their gradient stays float32 as in the reference."""
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

    def _sorted_sum_aggregate(self, tables: torch.Tensor,
                              batch: GraphBatch) -> torch.Tensor:
        """Joint [V, H] sum over all types via the scatter-plan route: one
        gather of the merged source rows and B13 forward, the cotangent's
        gather by target and B13 backward, with the plan's 1/deg scales or
        unit scales (sentinel slots are skipped either way)."""
        plan = batch.scatter_merged
        if self.normalize_by_num_incoming:
            scale_fwd, scale_bwd = plan.inv_fwd, plan.inv_bwd
        else:
            scale_fwd = torch.ones_like(plan.inv_fwd)
            scale_bwd = torch.ones_like(plan.inv_bwd)
        return typed_gather_scatter(tables, plan, scale_fwd, scale_bwd,
                                    stream_dtype=self.edge_dtype)

    def _pair_target_state_one_hidden(self, node_states: torch.Tensor,
                                      batch: GraphBatch) -> torch.Tensor:
        """The target-state one-hidden form over the merged-target plan:
        the relu-pair op's per-type aggregates [L*V, H], the second linear
        per type, the sum over types."""
        num_types = self.num_edge_types
        v = batch.num_nodes_padded
        plan = batch.pair_merged
        out_rows = num_types * v
        rows_a = num_types * node_states.shape[0]
        if not pair_edge_mlp_applicable(rows_a, out_rows, self.edge_dtype):
            raise NotImplementedError(
                "this batch's shapes fall outside the reference's relu-pair "
                "budget; its scatter-plan fallback "
                "(_fused_target_state_one_hidden, over the sorted-scatter "
                "kernels B12 and B13) is not ported.")
        if self.normalize_by_num_incoming:
            scales = (plan.inv_fwd, plan.inv_bwd, plan.inv_ovf)
        else:
            scales = pair_unit_scales(plan, out_rows)
        src_half = self.edge_mlp_src_0(node_states)       # [L, S, H]
        tgt_half = self.edge_mlp_tgt_0(node_states[:v])   # [L, V, H]
        typed_sums = pair_relu_mlp_aggregate(
            src_half.reshape(rows_a, -1), tgt_half.reshape(out_rows, -1),
            plan, *scales, out_rows, stream_dtype=self.edge_dtype)
        return self.edge_mlp_layer_1(
            typed_sums.reshape(num_types, v, -1)).sum(dim=0)

    def _check_batch(self, batch: GraphBatch) -> None:
        if self.use_target_state_as_input:
            if batch.pair_merged is None or not batch.pair_targets_merged:
                raise NotImplementedError(
                    "this batch has no merged-target pair plans on its "
                    "device: build it with pair_plans (merge_targets=True) "
                    "and move it with .to(device). The scatter-plan and "
                    "unfused segment paths are not ported.")
            return
        if batch.pair_stream_joint is None and batch.pair_merged is not None:
            raise NotImplementedError(
                "the source-only edge MLP over merged pair plans "
                "(pair_typed_gather_scatter) is not ported: build the batch "
                "with pair_plans_typed or with scatter_plans.")
        if batch.pair_stream_joint is None and batch.scatter_merged is None:
            raise NotImplementedError(
                "this batch has neither per-type pair plans nor scatter "
                "plans on its device: build it with pair_plans_typed or "
                "scatter_plans and move it with .to(device). The unfused "
                "segment path and the SPMD halo branches are not ported.")

    def _fused_sum_aggregate(self, node_states: torch.Tensor,
                             batch: GraphBatch,
                             training: bool) -> torch.Tensor:
        if self.use_target_state_as_input:
            return self._pair_target_state_one_hidden(node_states, batch)
        tables = self._fused_node_space_tables(node_states, batch)
        if batch.pair_stream_joint is not None:
            return self._pair_sum_aggregate(tables, batch)
        return self._sorted_sum_aggregate(tables, batch)
