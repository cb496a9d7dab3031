"""RGAT message passing, relational multi-head graph attention (port of
``tf2_gnn_tpu/layers/message_passing/rgat.py``: the single-chip
pair-attention route over merged or per-type plans, under either softmax
stabiliser, the sorted fallback over scatter plans, and the unfused
per-edge path).

Per edge type l and head k the attention logit of an edge u -> v is
``LeakyReLU(a_l_k . concat(W_l h_u, W_l h_v))``, normalised by a softmax
per target over all edge types jointly; the message is the head's slice of
``W_l h_u`` and heads are concatenated. Since ``a . concat(s, t) = a_src . s
+ a_tgt . t``, the logits come from two node-space score tables, and the
pair-attention op (``ops/pair_attention.py``) does the rest on the plan: a
merged plan takes ``pair_attention``, per-type plans (``pair_plans_typed``,
on the device as ``GraphBatch.pair_typed``) take ``pair_attention_typed``,
one launch of each kernel per edge type. Where the pair-attention gate
fails or the batch has no pair plans, the sorted fallback runs on the
batch's scatter plan (``ops/sorted_spmm.py``): gathers of the source
bundle and the target scores, the exact per-target max (B15) and one pass
for the denominators and weighted sums (B14).

Where the reference's gate sends a batch off both (no plans, an
aggregation other than sum, the activation before the aggregation, or a
batch outside the pair path without scatter plans; ``_route`` names
``"unfused"``), the per-edge path runs (reference rgat.py:309-376): per
type the gathered source messages and the leaky_relu (slope 0.2) of the
gathered score halves, in f32 whatever the edge dtype; then ``exp`` of the
segment log-softmax per (target, head) over all types jointly, the
weighted segment sum and the activation (after the aggregation, whatever
``message_activation_before_aggregation`` says, as in the reference).
"""
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...data.graph_batch import GraphBatch
from ...ops.activations import get_activation_function
from ...ops.pair_attention import (
    NEG,
    TILE,
    pair_attention,
    pair_attention_applicable,
    pair_attention_typed,
)
from ...ops.segment import segment_log_softmax, segment_sum
from ...ops.sorted_spmm import (
    attention_scatter,
    plan_gather_src,
    plan_gather_tgt_typed,
    sorted_segment_max,
)
from ...utils.constants import SMALL_NUMBER
from ...utils.init import glorot_uniform_batched_
from .base import MessagePassing, register_message_passing_implementation
from .typed_linear import TypedLinear


@register_message_passing_implementation
class RGAT(MessagePassing):

    def __init__(self, num_edge_types: int, input_dim: int,
                 hidden_dim: int = 7,
                 aggregation_function: str = "sum",
                 message_activation_function: str = "relu",
                 message_activation_before_aggregation: bool = False,
                 edge_dtype: str = "float32",
                 dense_dtype: str = "float32",
                 num_heads: int = 3,
                 attention_stabiliser: str = "bound"):
        super().__init__(num_edge_types, input_dim, hidden_dim,
                         aggregation_function, message_activation_function,
                         message_activation_before_aggregation, edge_dtype,
                         dense_dtype)
        if hidden_dim % num_heads:
            raise ValueError(f"hidden_dim {hidden_dim} must be divisible by "
                             f"num_heads {num_heads}.")
        self.num_heads = num_heads
        # "bound": the node-space upper bound on the per-(target, head) max
        # logit (the reference's default); "exact": the max kernel (B11).
        # The sorted route always takes the exact max (B15).
        self.attention_stabiliser = attention_stabiliser
        self.edge_weights = TypedLinear(num_edge_types, input_dim, hidden_dim,
                                        compute_dtype=dense_dtype)
        self.edge_attention_parameters = nn.Parameter(torch.empty(
            num_edge_types, num_heads, 2 * (hidden_dim // num_heads)))

    @classmethod
    def get_default_hyperparameters(cls) -> Dict[str, Any]:
        params = super().get_default_hyperparameters()
        params.update({"num_heads": 3, "attention_stabiliser": "bound"})
        return params

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        glorot_uniform_batched_(self.edge_attention_parameters, generator)

    def _padded_heads(self) -> int:
        """Heads padded up to the next divisor of TILE (the reference's
        kernels need TILE % K == 0); pad heads carry neutral scores."""
        k = self.num_heads
        while TILE % k:
            k += 1
        return k

    def _pair_attention_applicable_static(self, batch: GraphBatch) -> bool:
        """The reference's shape-only gate of the pair-attention path
        (rgat.py:55-83): source rows are one type's ``pair_src_space``
        (the padded nodes on one chip, the ext rows under SPMD-halo); under
        SPMD the path needs the halo form and a merged plan."""
        if batch.pair_targets_merged:
            return False
        if batch.spmd_axis is not None and (
                not batch.halo_mode or batch.pair_plans is None):
            return False
        if batch.pair_plans is None and batch.pair_plans_typed is None:
            return False
        k_pad = self._padded_heads()
        head_dim = self.hidden_dim // self.num_heads
        vs = batch.pair_src_space
        rows = vs if batch.pair_plans is None else batch.num_edge_types * vs
        return pair_attention_applicable(
            rows, batch.num_nodes_padded, head_dim * k_pad, k_pad,
            self.edge_dtype, self.edge_dtype, src_space=vs)

    def _halo_overlap_capable(self, batch: GraphBatch) -> bool:
        """Only the pair-attention route assembles its ext tables from
        LOCAL states; the sorted route reads the exchanged ext states."""
        return self._pair_attention_applicable_static(batch)

    def _route(self, batch: GraphBatch) -> str:
        """The route of the reference's ``_fused_sum_aggregate``
        (rgat.py:211-222): ``"pair_attention"`` where the pair-attention
        gate holds, else ``"sorted"`` on scatter plans, else
        ``"unfused"``; a batch without plans, an aggregation other than
        sum or the activation before the aggregation go unfused first."""
        if not self._fused_plan_applicable(batch):
            return "unfused"
        if self._pair_attention_applicable_static(batch):
            return "pair_attention"
        return "unfused" if batch.scatter_merged is None else "sorted"

    def _pair_attention_aggregate(self, node_states: torch.Tensor,
                                  batch: GraphBatch) -> torch.Tensor:
        num_types = batch.num_edge_types
        v = batch.num_nodes_padded
        heads = self.num_heads
        head_dim = self.hidden_dim // heads
        k_pad = self._padded_heads()

        if (batch.spmd_axis is not None and batch.halo_mode
                and node_states.shape[0] == batch.num_nodes_padded):
            # LOCAL states under SPMD-halo: the boundary rows received raw
            # and transformed apart (the per-type map is row-wise), the ext
            # table [local | halo | pad] assembled here (rgat.py:113-131).
            transformed = self._ext_tables(node_states, batch,
                                           self.edge_weights)
        else:
            transformed = self.edge_weights(node_states)  # [L, Vs, H]
        vs = transformed.shape[1]
        attention = self.edge_attention_parameters
        per_head = transformed.reshape(num_types, vs, heads, head_dim)
        src_scores = torch.einsum("lvkd,lkd->lvk", per_head,
                                  attention[:, :, :head_dim])
        tgt_scores = torch.einsum("lvkd,lkd->lvk", per_head,
                                  attention[:, :, head_dim:])
        if k_pad != heads:
            # Pad heads: source half 0, target half NEG, zero messages.
            src_scores = F.pad(src_scores, (0, k_pad - heads))
            tgt_scores = F.pad(tgt_scores, (0, k_pad - heads), value=NEG)
            per_head = F.pad(per_head, (0, 0, 0, k_pad - heads))
        # HK-MAJOR message layout: column hd * K + k.
        table_hk = per_head.permute(0, 1, 3, 2).reshape(
            num_types * vs, head_dim * k_pad)
        scores = torch.cat(
            [src_scores.reshape(num_types * vs, k_pad),
             tgt_scores.reshape(num_types * vs, k_pad)], dim=1)
        # The casts to the stream dtype stay outside the autograd op, so
        # the gradients of both come back rounded to it, as in the
        # reference (its custom VJP returns them in the stream dtype).
        table_hk = table_hk.to(self.edge_dtype)
        scores = scores.to(self.edge_dtype)

        if batch.pair_merged is not None:
            denom, weighted = pair_attention(
                table_hk, scores, batch.pair_merged, v, k_pad,
                self.attention_stabiliser, vs if vs != v else None)
        else:
            # Row-split form: one launch per edge type, the stabiliser
            # spanning all of them.
            denom, weighted = pair_attention_typed(
                table_hk, scores, batch.pair_typed, v, k_pad,
                self.attention_stabiliser)
        # Where-guarded division, not + eps: the reference's softmax has no
        # epsilon, and targets without in-edges contribute exactly 0.
        denom_t = denom.repeat(1, head_dim)
        has_edges = denom_t > 0.0
        weighted = torch.where(
            has_edges,
            weighted / torch.where(has_edges, denom_t,
                                   torch.ones_like(denom_t)),
            torch.zeros_like(weighted))
        # Drop pad heads and restore the concat-head layout.
        out = weighted.reshape(v, head_dim, k_pad)[:, :, :heads]
        return out.permute(0, 2, 1).reshape(v, self.hidden_dim)

    def _sorted_attention_aggregate(self, node_states: torch.Tensor,
                                    batch: GraphBatch) -> torch.Tensor:
        """The sorted fallback over the batch's scatter plan, line for line
        with the reference: one bundled source gather of the hk-major
        messages and source scores in the stream dtype, read in f32; the
        type-minor target gather of the f32 target scores; the per-target
        max of the detached logits (B15); expd zeroed on sentinels; the
        denominators and weighted sums in one pass (B14); and ``+ eps``
        division, unlike the pair route's where-guarded one."""
        plan = batch.scatter_merged
        num_types = self.num_edge_types
        v = batch.num_nodes_padded
        vr = node_states.shape[0]
        heads = self.num_heads
        head_dim = self.hidden_dim // heads

        transformed = self.edge_weights(node_states)  # [L, Vr, H]
        attention = self.edge_attention_parameters
        per_head = transformed.reshape(num_types, vr, heads, head_dim)
        src_scores = torch.einsum("lvkd,lkd->lvk", per_head,
                                  attention[:, :, :head_dim])
        tgt_scores = torch.einsum("lvkd,lkd->lvk", per_head,
                                  attention[:, :, head_dim:])
        # One bundled source gather, [L*Vr, H + K], messages in HK-MAJOR
        # head layout (column hk * K + k). The cast to the stream dtype is
        # inside the gather op, so the bundle's gradient leaves it in f32.
        transformed_hk = per_head.permute(0, 1, 3, 2).reshape(
            num_types * vr, self.hidden_dim)
        src_bundle = self._globalize_tables(torch.cat(
            [transformed_hk, src_scores.reshape(num_types * vr, heads)],
            dim=1), batch, num_types)
        bundle_g = plan_gather_src(src_bundle, plan, self.edge_dtype).float()
        msgs = bundle_g[:, :self.hidden_dim]
        src_score_g = bundle_g[:, self.hidden_dim:]
        tgt_score_g = plan_gather_tgt_typed(
            tgt_scores[:, :v].permute(1, 0, 2).reshape(v * num_types, heads),
            plan)
        logits = F.leaky_relu(src_score_g + tgt_score_g, negative_slope=0.2)
        # The stabiliser is never differentiated (its true gradient is 0).
        # B15 reads the forward compact form that B14 reads after it.
        maxes = sorted_segment_max(logits.detach(), plan.rel_tgt,
                                   plan.tgt_blocks, v,
                                   compact=plan.sum_rows("fwd", v))
        shifted = logits - maxes.index_select(0, plan.tgtabs_idx)
        expd = torch.where(plan.fwd_sentinel[:, None], 0.0,
                           torch.exp(shifted))
        denom, weighted = attention_scatter(expd, msgs, plan)
        weighted = weighted / (denom.repeat(1, head_dim) + SMALL_NUMBER)
        # Back to the reference's concat-head (k-major) layout.
        return weighted.reshape(v, head_dim, heads).permute(0, 2, 1).reshape(
            v, self.hidden_dim)

    def _fused_sum_aggregate(self, node_states: torch.Tensor,
                             batch: GraphBatch,
                             training: bool) -> Optional[torch.Tensor]:
        route = self._route(batch)
        if route == "pair_attention":
            return self._pair_attention_aggregate(node_states, batch)
        if route == "sorted":
            return self._sorted_attention_aggregate(node_states, batch)
        return None

    def _compute_messages_per_type(
            self, node_states: torch.Tensor, batch: GraphBatch,
            training: bool) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per type, the [E_l, K, H/K] source messages and the [E_l, K]
        attention logits (reference rgat.py:309-350)."""
        heads = self.num_heads
        head_dim = self.hidden_dim // heads
        transformed = self.edge_weights(node_states).reshape(
            self.num_edge_types, -1, heads, head_dim)
        attention = self.edge_attention_parameters
        src_scores = torch.einsum("lvkd,lkd->lvk", transformed,
                                  attention[:, :, :head_dim])
        tgt_scores = torch.einsum("lvkd,lkd->lvk", transformed,
                                  attention[:, :, head_dim:])
        results = []
        for l in range(self.num_edge_types):
            logits = F.leaky_relu(
                batch.gather_source_rows(src_scores[l], l)
                + batch.gather_target_rows(tgt_scores[l], l),
                negative_slope=0.2)
            results.append((batch.gather_source_rows(transformed[l], l),
                            logits))
        return results

    def _compute_new_node_embeddings(
            self, node_states: torch.Tensor,
            messages_per_type: List[Tuple[torch.Tensor, torch.Tensor]],
            batch: GraphBatch, training: bool) -> torch.Tensor:
        """The softmax per (target, head) over all types jointly, as
        ``exp(segment_log_softmax)``, the weighted sum per target, then
        the activation (reference rgat.py:352-376)."""
        segments = batch.aggregation_segments
        messages = torch.cat([m for m, _ in messages_per_type], dim=0)
        logits = torch.cat([s for _, s in messages_per_type], dim=0)
        targets = torch.cat(batch.edge_targets, dim=0)
        attention = torch.exp(segment_log_softmax(logits, targets, segments))
        aggregated = batch.slice_aggregated(segment_sum(
            attention[:, :, None] * messages, targets, segments))
        return get_activation_function(self.message_activation_function)(
            aggregated.reshape(batch.num_nodes_padded, self.hidden_dim))
