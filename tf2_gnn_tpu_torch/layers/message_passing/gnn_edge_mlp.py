"""Edge-MLP message passing (port of the fused branches of
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
  K1), by ``pair_typed_gather_scatter`` over a merged pair plan (B3 both
  ways; with merged targets the per-type sums are then summed over
  types), or, on a batch with scatter plans instead, by
  ``typed_gather_scatter``, the scatter-plan route (``ops/sorted_spmm.py``);
* target-state input with ONE hidden layer, the reference's default
  (``_pair_target_state_one_hidden``): the first layer splits into source
  and target halves run in node space, ``A = W1_src h`` over all rows and
  ``B = W1_tgt h`` in merged-target layout, and since the layers are
  bias-free the second linear commutes with the sum over edges:

      out[v] = sum_l W2_l @ R[l*V + v],
      R[t]   = sum over edges e=(u -> t) of s_e * relu(A[src_e] + B[t]),

  which the relu-pair op (``ops/pair_edge_mlp.py``) computes over a
  merged-target plan, with ``s_e`` 1 or the plan's 1/deg scales; where the
  relu-pair gate fails, or the batch has scatter plans instead, the
  scatter-plan form (``_scatter_target_state_one_hidden``) computes R from
  per-edge gathers of A and B, a relu and L type-masked scatters (B12);
* target-state input with 0 hidden layers (``_pair_factorised_typed_sums``):
  the one linear of a concat splits into halves, and the target half is
  constant over a target's edges of one type:

      sum over type-l edges into v of s_l(v) * (W_src h_u + W_tgt h_v)
        = S_l[v] + c_l(v) * (W_tgt h_v),

  with ``S_l`` the per-type aggregate of the source half (the per-type
  streamed op over per-type pair plans, K1 in both directions, or
  ``pair_typed_gather_scatter`` over a merged-target plan, B3) and
  ``c_l(v) = deg_l(v) * s_l(v)``: deg/(deg + eps) with 1/deg, else deg.
  GNN-FiLM modulates these per-type sums (``gnn_film.py``); this flavour
  sums them over types. On scatter plans the messages are gathered per
  edge and scattered instead (``_scatter_target_state_zero_hidden``, B12).

``_route`` picks, per batch, the first fused route that the reference's
``_fused_sum_aggregate`` takes; the scatter-plan forms of the
target-state input need ``fused_target_gather`` (the reference's A/B
switch). Where the reference takes none, its unfused per-edge path runs,
which is not ported: the layer raises, as it does for the target-state
forms with 2 or more hidden layers.
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
    pair_typed_gather_scatter,
    pair_unit_scales,
)
from ...ops.sorted_spmm import (
    plan_gather_src,
    plan_gather_tgt_typed,
    plan_scatter,
    typed_gather_scatter,
)
from ...utils.constants import SMALL_NUMBER
from .base import (
    UNFUSED_PATH,
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
                 num_edge_MLP_hidden_layers: int = 1,
                 fused_target_gather: bool = True):
        super().__init__(num_edge_types, input_dim, hidden_dim,
                         aggregation_function, message_activation_function,
                         message_activation_before_aggregation, edge_dtype,
                         dense_dtype)
        if use_target_state_as_input and num_edge_MLP_hidden_layers > 1:
            raise NotImplementedError(
                "use_target_state_as_input=True with "
                f"num_edge_MLP_hidden_layers={num_edge_MLP_hidden_layers} "
                f"needs per-edge matmuls, {UNFUSED_PATH}; the target-state "
                "forms with 0 hidden layers and with one hidden layer are "
                "ported.")
        self.use_target_state_as_input = use_target_state_as_input
        self.normalize_by_num_incoming = normalize_by_num_incoming
        self.num_edge_MLP_hidden_layers = num_edge_MLP_hidden_layers
        self.fused_target_gather = fused_target_gather
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

    def _fused_node_space_tables(self, node_states: torch.Tensor,
                                 batch: GraphBatch) -> torch.Tensor:
        """The per-type message MLP run densely in node space -> f32
        [L*V, H]. The reference casts these tables to ``edge_dtype`` (and
        pads them to 128 columns for its pair kernels); the port casts
        inside the aggregation op (its ``stream_dtype``) so that their
        gradient stays float32 as in the reference, and its row owners
        take any width."""
        hidden = node_states  # [V, D] -> [L, V, *]
        for i in range(len(self._edge_mlp_layer_sizes())):
            hidden = getattr(self, f"edge_mlp_layer_{i}")(hidden)
            if i < self.num_edge_MLP_hidden_layers:
                hidden = torch.relu(hidden)
        return hidden.reshape(self.num_edge_types * hidden.shape[1], -1)

    def _pair_sum_aggregate(self, tables: torch.Tensor,
                            batch: GraphBatch) -> torch.Tensor:
        """Joint [V, H] sum over all types via the pair kernels: over
        per-type plans the joint streamed op (the joint kernel K2 forward,
        K1 on the un-broadcast [V, H] cotangent backward); over a merged
        plan ``pair_typed_gather_scatter`` (B3 both ways), whose per-type
        sums over merged targets are summed over the type axis (reference
        gnn_edge_mlp.py:209-226)."""
        if batch.pair_stream_joint is not None:
            return pair_stream_joint(tables, batch.pair_stream_joint,
                                     self.normalize_by_num_incoming,
                                     stream_dtype=self.edge_dtype)
        out = pair_typed_gather_scatter(tables, batch.pair_merged,
                                        self.normalize_by_num_incoming,
                                        stream_dtype=self.edge_dtype)
        if batch.pair_targets_merged:
            out = out.reshape(self.num_edge_types, batch.num_nodes_padded,
                              -1).sum(dim=0)
        return out

    def _pair_typed_aggregates(self, tables: torch.Tensor,
                               batch: GraphBatch) -> torch.Tensor:
        """Per-type aggregates ``S_l[v]`` = sum over type-l edges into v of
        the (scaled) ``tables[l*V + u]``, f32 [L, V, H]: the per-type
        streamed op over per-type plans (K1 in both directions), or
        ``pair_typed_gather_scatter`` over a merged-target plan (B3 in
        both directions)."""
        if batch.pair_stream_typed is not None:
            out = pair_stream_typed(tables, batch.pair_stream_typed,
                                    self.normalize_by_num_incoming,
                                    stream_dtype=self.edge_dtype)
        else:
            out = pair_typed_gather_scatter(tables, batch.pair_merged,
                                            self.normalize_by_num_incoming,
                                            stream_dtype=self.edge_dtype)
        return out.reshape(self.num_edge_types, batch.num_nodes_padded, -1)

    def _pair_factorised_typed_sums(self, node_states: torch.Tensor,
                                    batch: GraphBatch) -> torch.Tensor:
        """f32 [L, V, H] per-type aggregated (normalised) messages over
        per-type or merged-target plans: of the source-only MLP of any
        depth, or of the 0-hidden target-state form, ``S_l + c_l * W_tgt
        h`` (the module docstring's factorisation)."""
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

    def _scatter_target_halves(self, node_states: torch.Tensor,
                               batch: GraphBatch) -> torch.Tensor:
        """The per-slot sum of the first layer's halves over the scatter
        plan, in f32: ``W_src h`` gathered by merged source plus ``W_tgt
        h`` gathered from its TYPE-MINOR layout [V*L, H] (row ``t * L +
        l``, whose gradient B12 sums over the forward plan itself), each
        gathered in the edge dtype and added there, as in the reference
        (gnn_edge_mlp.py:398-417, 605-621)."""
        plan = batch.scatter_merged
        v = batch.num_nodes_padded
        src_half = self.edge_mlp_src_0(node_states)       # [L, S, H]
        tgt_half = self.edge_mlp_tgt_0(node_states[:v])   # [L, V, H]
        src_flat = src_half.reshape(self.num_edge_types * src_half.shape[1],
                                    -1)
        tgt_tl = tgt_half.transpose(0, 1).reshape(v * self.num_edge_types,
                                                  -1)
        return (plan_gather_src(src_flat, plan, self.edge_dtype)
                + plan_gather_tgt_typed(tgt_tl, plan,
                                        self.edge_dtype)).float()

    def _scatter_target_state_one_hidden(self, node_states: torch.Tensor,
                                         batch: GraphBatch) -> torch.Tensor:
        """The target-state one-hidden form over the scatter plan
        (reference ``_fused_target_state_one_hidden``, gnn_edge_mlp.py:
        369-440): ``R_l[v]`` = the sum over type-l slots into v of
        ``scale * relu(A[src] + B[tgt])`` by L type-masked scatters (B12,
        the stream in the edge dtype), then the second linear per type and
        the sum over types."""
        plan = batch.scatter_merged
        r = torch.relu(self._scatter_target_halves(node_states, batch))
        if self.normalize_by_num_incoming:
            r = r * plan.inv_fwd[:, None]
        typed_sums = torch.stack([
            plan_scatter(torch.where((plan.type_fwd == l)[:, None], r, 0.0),
                         plan, self.edge_dtype)
            for l in range(self.num_edge_types)])   # [L, V, H] f32
        return self.edge_mlp_layer_1(typed_sums).sum(dim=0)

    def _scatter_target_state_zero_hidden(self, node_states: torch.Tensor,
                                          batch: GraphBatch) -> torch.Tensor:
        """The 0-hidden target-state form over the scatter plan (reference
        gnn_edge_mlp.py:593-628): each slot's message ``W_src h_u + W_tgt
        h_t`` in f32, times its 1/deg scale when normalising, summed by
        target (B12)."""
        plan = batch.scatter_merged
        msgs = self._scatter_target_halves(node_states, batch)
        if self.normalize_by_num_incoming:
            msgs = msgs * plan.inv_fwd[:, None]
        return plan_scatter(msgs, plan)

    def _route(self, batch: GraphBatch) -> str:
        """The fused route the reference's ``_fused_sum_aggregate``
        (gnn_edge_mlp.py:512-628) takes on ``batch``: per-type pair plans
        first, then a merged pair plan, then scatter plans. Its budget
        gates of the pair kernels (the TPU's VMEM) are not kept, since the
        row owners take any shape; the relu-pair op's gate is. Raises
        ``NotImplementedError`` where the reference would take its unfused
        path."""
        typed = batch.pair_plans_typed is not None
        merged = batch.pair_merged is not None
        merged_targets = merged and batch.pair_targets_merged
        scatter = batch.scatter_merged is not None
        target_scatter = scatter and self.fused_target_gather
        if not self.use_target_state_as_input:
            if typed:
                return "pair_joint"
            if merged:
                return "pair_merged"
            if scatter:
                return "scatter_sum"
            raise NotImplementedError(
                "this batch has neither pair plans nor scatter plans on its "
                "device: build it with pair_plans_typed, pair_plans or "
                "scatter_plans and move it with .to(device). The reference "
                f"takes {UNFUSED_PATH} there (the SPMD halo branches are not "
                "ported either).")
        if self.num_edge_MLP_hidden_layers == 1:
            v = batch.num_nodes_padded
            if merged_targets and pair_edge_mlp_applicable(
                    self.num_edge_types * v, self.num_edge_types * v,
                    self.edge_dtype):
                return "relu_pair"
            if target_scatter:
                return "scatter_one_hidden"
            raise NotImplementedError(
                "the target-state edge MLP with one hidden layer needs a "
                "merged-target pair plan inside the relu-pair budget, or "
                "scatter plans with fused_target_gather=True; on this batch "
                f"the reference takes {UNFUSED_PATH}.")
        if typed or merged_targets:
            return "factorised"
        if target_scatter:
            return "scatter_zero_hidden"
        raise NotImplementedError(
            "the target-state edge MLP with 0 hidden layers needs per-type "
            "pair plans, a merged-target pair plan, or scatter plans with "
            "fused_target_gather=True (a merged plan with local targets "
            f"gives no per-type sums); on this batch the reference takes "
            f"{UNFUSED_PATH}.")

    def _check_batch(self, batch: GraphBatch) -> None:
        self._route(batch)

    def _fused_sum_aggregate(self, node_states: torch.Tensor,
                             batch: GraphBatch,
                             training: bool) -> torch.Tensor:
        route = self._route(batch)
        if route == "factorised":
            return self._pair_factorised_typed_sums(node_states,
                                                    batch).sum(dim=0)
        if route == "relu_pair":
            return self._pair_target_state_one_hidden(node_states, batch)
        if route == "scatter_one_hidden":
            return self._scatter_target_state_one_hidden(node_states, batch)
        if route == "scatter_zero_hidden":
            return self._scatter_target_state_zero_hidden(node_states, batch)
        tables = self._fused_node_space_tables(node_states, batch)
        if route == "scatter_sum":
            return self._sorted_sum_aggregate(tables, batch)
        return self._pair_sum_aggregate(tables, batch)
