"""Edge-MLP message passing (port of the pair branches of
``tf2_gnn_tpu/layers/message_passing/gnn_edge_mlp.py``), the base of RGCN,
GGNN, RGIN and GNN-FiLM.

``msg = MLP_l(h_src [|| h_tgt])``, optionally scaled by 1/(per-type
in-degree of the target + eps); the per-type MLP has N hidden layers of
size hidden_dim with ReLU, a final linear layer and no biases. Three forms
are ported:

* source-only (``use_target_state_as_input=False``, RGCN's form): the MLP
  is pointwise in the source node, so it runs densely in node space for
  all types at once, and its rows are gathered and summed per edge by the
  block-pair streamed op over per-type pair plans (the joint sum, K2 and
  K1), or, on a batch with scatter plans instead, by
  ``typed_gather_scatter``, the scatter-plan route (``ops/sorted_spmm.py``);
* target-state input with ONE hidden layer, the reference's default
  (``_pair_target_state_one_hidden``): the first layer splits into source
  and target halves run in node space, ``A = W1_src h`` over all rows and
  ``B = W1_tgt h`` in merged-target layout, and since the layers are
  bias-free the second linear commutes with the sum over edges:

      out[v] = sum_l W2_l @ R[l*V + v],
      R[t]   = sum over edges e=(u -> t) of s_e * relu(A[src_e] + B[t]),

  which the relu-pair op (``ops/pair_edge_mlp.py``) computes over a
  merged-target plan, with ``s_e`` 1 or the plan's 1/deg scales;
* target-state input with 0 hidden layers (``_pair_factorised_typed_sums``):
  the one linear of a concat splits into halves, and the target half is
  constant over a target's edges of one type:

      sum over type-l edges into v of s_l(v) * (W_src h_u + W_tgt h_v)
        = S_l[v] + c_l(v) * (W_tgt h_v),

  with ``S_l`` the per-type aggregate of the source half (the per-type
  streamed op over per-type pair plans, K1 in both directions) and
  ``c_l(v) = deg_l(v) * s_l(v)``: deg/(deg + eps) with 1/deg, else deg.
  GNN-FiLM modulates these per-type sums (``gnn_film.py``); this flavour
  sums them over types.

The target-state forms with 2 or more hidden layers, the target-state
forms on scatter plans, the per-type aggregates over merged plans and the
source-only form on merged pair plans are not ported and raise.
"""
from typing import Any, Dict, List

import torch

from ...data.graph_batch import GraphBatch
from ...ops.pair_edge_mlp import (
    pair_edge_mlp_applicable,
    pair_relu_mlp_aggregate,
)
from ...ops.pair_spmm import (
    pair_stream_joint,
    pair_stream_typed,
    pair_unit_scales,
)
from ...ops.sorted_spmm import typed_gather_scatter
from ...utils.constants import SMALL_NUMBER
from .base import (
    MessagePassing,
    calculate_type_to_num_incoming_edges,
    register_message_passing_implementation,
)
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
        if use_target_state_as_input and num_edge_MLP_hidden_layers > 1:
            raise NotImplementedError(
                "use_target_state_as_input=True with "
                f"num_edge_MLP_hidden_layers={num_edge_MLP_hidden_layers} "
                "needs per-edge matmuls (the unfused segment path), which "
                "are not ported; the target-state forms with 0 hidden layers "
                "(over per-type pair plans) and with one hidden layer are.")
        self.use_target_state_as_input = use_target_state_as_input
        self.normalize_by_num_incoming = normalize_by_num_incoming
        self.num_edge_MLP_hidden_layers = num_edge_MLP_hidden_layers
        if use_target_state_as_input:
            names = [("edge_mlp_src_0", input_dim), ("edge_mlp_tgt_0",
                                                     input_dim)]
            if num_edge_MLP_hidden_layers:
                names.append(("edge_mlp_layer_1", hidden_dim))
            for name, dim in names:
                self.add_module(name, TypedLinear(
                    num_edge_types, dim, hidden_dim,
                    compute_dtype=dense_dtype))
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

    @property
    def _reads_typed_sums(self) -> bool:
        """Whether the layer sums per-type aggregates (over per-type
        plans' ``pair_stream_typed``) rather than the joint sum."""
        return (self.use_target_state_as_input
                and self.num_edge_MLP_hidden_layers == 0)

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

    def _pair_typed_aggregates(self, tables: torch.Tensor,
                               batch: GraphBatch) -> torch.Tensor:
        """Per-type aggregates ``S_l[v]`` = sum over type-l edges into v of
        the (scaled) ``tables[l*V + u]``, f32 [L, V, H], via the per-type
        streamed op (K1 in both directions)."""
        out = pair_stream_typed(tables, batch.pair_stream_typed,
                                self.normalize_by_num_incoming,
                                stream_dtype=self.edge_dtype)
        return out.reshape(self.num_edge_types, batch.num_nodes_padded, -1)

    def _pair_factorised_typed_sums(self, node_states: torch.Tensor,
                                    batch: GraphBatch) -> torch.Tensor:
        """f32 [L, V, H] per-type aggregated (normalised) messages over
        per-type plans: of the source-only MLP of any depth, or of the
        0-hidden target-state form, ``S_l + c_l * W_tgt h`` (the module
        docstring's factorisation)."""
        if not self.use_target_state_as_input:
            return self._pair_typed_aggregates(
                self._fused_node_space_tables(node_states, batch), batch)
        v = batch.num_nodes_padded
        src_half = self.edge_mlp_src_0(node_states)       # [L, S, H]
        tgt_half = self.edge_mlp_tgt_0(node_states[:v])   # [L, V, H]
        agg = self._pair_typed_aggregates(
            src_half.reshape(self.num_edge_types * src_half.shape[1], -1),
            batch)
        deg = calculate_type_to_num_incoming_edges(batch)  # [L, V]
        if self.normalize_by_num_incoming:
            coeff = deg / (deg + SMALL_NUMBER)
        else:
            coeff = deg
        return agg + coeff[..., None] * tgt_half

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

    @staticmethod
    def _check_typed_batch(batch: GraphBatch, form: str) -> None:
        """Raise unless ``batch`` has per-type pair plans, which the
        per-type aggregates of ``form`` read."""
        if batch.pair_stream_typed is not None:
            return
        if batch.pair_merged is not None:
            raise NotImplementedError(
                f"{form} over merged pair plans (the per-type aggregates of "
                "pair_typed_gather_scatter, over B3) is not ported: build "
                "the batch with pair_plans_typed.")
        raise NotImplementedError(
            f"{form} needs per-type pair plans on the batch's device: build "
            "it with pair_plans_typed and move it with .to(device). Its "
            "scatter-plan fallback and the unfused segment path are not "
            "ported.")

    def _check_batch(self, batch: GraphBatch) -> None:
        if self._reads_typed_sums:
            self._check_typed_batch(
                batch, "the target-state edge MLP with 0 hidden layers")
            return
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
        if self._reads_typed_sums:
            return self._pair_factorised_typed_sums(node_states,
                                                    batch).sum(dim=0)
        if self.use_target_state_as_input:
            return self._pair_target_state_one_hidden(node_states, batch)
        tables = self._fused_node_space_tables(node_states, batch)
        if batch.pair_stream_joint is not None:
            return self._pair_sum_aggregate(tables, batch)
        return self._sorted_sum_aggregate(tables, batch)
