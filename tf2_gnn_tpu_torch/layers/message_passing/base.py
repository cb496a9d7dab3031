"""Message-passing template + registry (port of
``tf2_gnn_tpu/layers/message_passing/base.py``).

A layer maps node states ``[V, D] -> [V, hidden_dim]``. Where the batch
carries plans that a flavour's fused route reads, node-space transforms
run densely first, a hand-written kernel aggregates them over the edges
(``_fused_sum_aggregate``), and ``_post_aggregate`` applies the message
activation. Where the reference's ``_fused_sum_aggregate`` returns None
(a batch without plans, an aggregation other than sum, the activation
before the aggregation, a flavour's form that no fused route computes),
the unfused per-edge path runs, as in the reference: the flavour's
per-edge messages of each type (``_compute_messages_per_type``, gathers
and per-edge products in PyTorch ops), then ``_compute_new_node_embeddings``
concatenates them, applies the activation before the aggregation where
asked, and aggregates them over the edge targets by the configured
segment op. Which path a batch takes is decided from its plans and the
hyperparameters alone, never from whether a kernel builds.

On one shard of a node-partitioned graph (``batch.spmd_axis``) in halo
mode, the layer first makes the ext source rows ``[local | halo slabs |
pad]`` that the shard's ext-local edge sources index (reference
base.py:191-290): ``_halo_recv`` receives the boundary rows (one
all_to_all of the rows each shard asked for, or one ppermute a ring
distance), and ``_exchange_halo`` appends them to the local states. A
flavour whose fused route takes LOCAL states and assembles its ext source
tables itself (``_halo_overlap_capable``: the source-only edge MLPs, RGAT
on the pair-attention route) receives the raw boundary rows and
transforms them apart from the local rows; any other route reads the
exchanged ext states for its source side, the local rows for its target
side. Without a halo, a fused route's source tables are all_gather-ed
over the mesh axis (``_globalize_tables``), so global sources resolve.
The backward of each collective carries the boundary rows' gradients
back to their owners.
"""
import inspect
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ...data.graph_batch import GraphBatch
from ...ops.activations import get_activation_function
from ...ops.segment import gather_rows, get_aggregation_function
from ...utils.constants import SMALL_NUMBER

MESSAGE_PASSING_IMPLEMENTATIONS: Dict[str, type] = {}


def register_message_passing_implementation(cls):
    """Register an MP flavour under its lowercased class name
    (reference: message_passing.py:221-227)."""
    MESSAGE_PASSING_IMPLEMENTATIONS[cls.__name__.lower()] = cls
    return cls


def get_message_passing_class(name: str):
    cls = MESSAGE_PASSING_IMPLEMENTATIONS.get(name.lower())
    if cls is None:
        raise ValueError(
            f"Unknown message passing class '{name}'. Known: "
            f"{sorted(MESSAGE_PASSING_IMPLEMENTATIONS)}"
        )
    return cls


def get_known_message_passing_classes():
    return sorted(MESSAGE_PASSING_IMPLEMENTATIONS.keys())


def calculate_type_to_num_incoming_edges(batch: GraphBatch) -> torch.Tensor:
    """f32 [L, V]: the per-type in-degree of every node (reference
    base.py:60-79). Padded edges target the pad row, so the real rows are
    exact without a mask. A batch from ``pad_batch_arrays`` carries it
    (``in_degrees``, counted on the host); otherwise the edge targets are
    counted on their device, targets outside [0, V) dropped."""
    if batch.in_degrees is not None:
        return batch.in_degrees
    v = batch.num_nodes_padded
    return torch.stack([
        torch.bincount(tgt.long()[(tgt >= 0) & (tgt < v)],
                       minlength=v).to(torch.float32)
        for tgt in batch.edge_targets])


class MessagePassing(nn.Module):
    """Template for one message-passing step: ``[V, D] -> [V, hidden_dim]``.

    Subclasses implement ``_fused_sum_aggregate`` (the [V, H] sum-aggregated
    messages, or None where no fused route applies) and
    ``_compute_messages_per_type`` (the unfused path's per-type per-edge
    messages), and may override ``_compute_new_node_embeddings`` (RGAT's
    softmax) and ``_post_aggregate``; one whose update never applies the
    message activation (GGNN's GRU, RGIN's aggregation MLP) sets
    ``_apply_message_activation`` False, and then the activation's place
    is no reason to leave the fused path (reference base.py:140-142).
    """

    _apply_message_activation = True

    def __init__(self, num_edge_types: int, input_dim: int,
                 hidden_dim: int = 7,
                 aggregation_function: str = "sum",
                 message_activation_function: str = "relu",
                 message_activation_before_aggregation: bool = False,
                 edge_dtype: str = "float32",
                 dense_dtype: str = "float32"):
        super().__init__()
        # Fails early on an unknown name, as the reference's first call does.
        get_aggregation_function(aggregation_function)
        self.num_edge_types = num_edge_types
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.aggregation_function = aggregation_function
        self.message_activation_function = message_activation_function
        self.message_activation_before_aggregation = (
            message_activation_before_aggregation)
        # Dtype of the per-edge message stream the kernels gather; the
        # aggregation accumulates in float32.
        self.edge_dtype = getattr(torch, edge_dtype)

    @classmethod
    def get_default_hyperparameters(cls) -> Dict[str, Any]:
        return {
            "aggregation_function": "sum",
            "message_activation_function": "relu",
            "message_activation_before_aggregation": False,
            "hidden_dim": 7,
            "edge_dtype": "float32",
            "dense_dtype": "float32",
        }

    @classmethod
    def from_params(cls, params: Dict[str, Any], num_edge_types: int,
                    input_dim: int) -> "MessagePassing":
        """Build from a flat hyperparameter dict, ignoring keys that are not
        constructor arguments of ``cls``."""
        accepted = set(inspect.signature(cls.__init__).parameters)
        accepted -= {"self", "num_edge_types", "input_dim"}
        kwargs = {k: v for k, v in params.items() if k in accepted}
        return cls(num_edge_types=num_edge_types, input_dim=input_dim,
                   **kwargs)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for module in self.children():
            module.reset_parameters(generator)

    def _fused_plan_applicable(self, batch: GraphBatch) -> bool:
        """The reference's gate before any fused route (gnn_edge_mlp.py:
        134-142, rgat.py:211-218): the batch carries plans, the
        aggregation is the sum, and the activation, if this flavour
        applies one, comes after it."""
        return not (
            (batch.scatter_merged is None and batch.pair_merged is None
             and batch.pair_plans_typed is None)
            or (batch.spmd_axis is not None and batch.spmd_num_shards is None)
            or self.aggregation_function != "sum"
            or (self._apply_message_activation
                and self.message_activation_before_aggregation))

    def _fused_sum_aggregate(self, node_states: torch.Tensor,
                             batch: GraphBatch,
                             training: bool) -> Optional[torch.Tensor]:
        """The [V, H] sum-aggregated messages over a fused route, or None
        where the reference takes its unfused path."""
        return None

    def _compute_messages_per_type(self, node_states: torch.Tensor,
                                   batch: GraphBatch,
                                   training: bool) -> List[Any]:
        """The unfused path's messages: one entry per edge type, [E_l, H]
        (or a flavour's own tuple, as RGAT's)."""
        raise NotImplementedError

    def _compute_new_node_embeddings(self, node_states: torch.Tensor,
                                     messages_per_type: List[Any],
                                     batch: GraphBatch,
                                     training: bool) -> torch.Tensor:
        """All types' messages concatenated in f32, the activation before
        the configured segment aggregation over the edge targets where
        asked, then ``_post_aggregate`` (reference base.py:145-167)."""
        aggregation = get_aggregation_function(self.aggregation_function)
        messages = torch.cat(messages_per_type, dim=0).to(torch.float32)
        targets = torch.cat(batch.edge_targets, dim=0)
        if (self._apply_message_activation
                and self.message_activation_before_aggregation):
            messages = get_activation_function(
                self.message_activation_function)(messages)
        aggregated = batch.slice_aggregated(
            aggregation(messages, targets, batch.aggregation_segments))
        return self._post_aggregate(aggregated, node_states, batch, training)

    def _post_aggregate(self, aggregated: torch.Tensor,
                        node_states: torch.Tensor, batch: GraphBatch,
                        training: bool) -> torch.Tensor:
        """The (after-aggregation) message activation; GGNN's GRU and
        RGIN's MLP override it."""
        if (self._apply_message_activation
                and not self.message_activation_before_aggregation):
            aggregated = get_activation_function(
                self.message_activation_function)(aggregated)
        return aggregated

    def _halo_overlap_capable(self, batch: GraphBatch) -> bool:
        """True where the flavour's fused route takes LOCAL node states
        under SPMD-halo and assembles its ext source tables itself."""
        return False

    @staticmethod
    def _globalize_tables(tables_flat: torch.Tensor, batch: GraphBatch,
                          num_types: int) -> torch.Tensor:
        """Under SPMD without a halo, the per-type tables [L*V, ...]
        all_gather-ed over the mesh axis into [L*V*S, ...] (type-major),
        so the plans' global merged sources resolve; else as they are."""
        if batch.spmd_axis is None or batch.halo_mode:
            return tables_flat
        from ...parallel.collectives import all_gather

        v = batch.num_nodes_padded
        per_type = tables_flat.reshape(num_types, v, -1).transpose(0, 1)
        gathered = all_gather(per_type.contiguous(), batch.spmd_axis)
        return gathered.transpose(0, 1).reshape(
            num_types * v * batch.spmd_num_shards, -1)

    @staticmethod
    def _ext_tables(node_states: torch.Tensor, batch: GraphBatch,
                    transform=None) -> torch.Tensor:
        """``transform`` (row-wise; default none) of the ext states
        ``[local | halo slabs | pad]``, ``halo_ext_nodes`` rows on the
        second-to-last axis: the local rows and the received boundary rows
        transformed apart, then zero rows."""
        def apply(x):
            return x if transform is None else transform(x)

        local = apply(node_states)
        parts = [local]
        halo = MessagePassing._halo_recv(node_states, batch)
        if halo is not None:
            parts.append(apply(halo))
        pad = batch.halo_ext_nodes - sum(p.shape[-2] for p in parts)
        if pad:
            parts.append(local.new_zeros(local.shape[:-2]
                                         + (pad, local.shape[-1])))
        return torch.cat(parts, dim=-2) if len(parts) > 1 else local

    @staticmethod
    def _exchange_halo(node_states: torch.Tensor,
                       batch: GraphBatch) -> torch.Tensor:
        """The ext state table ``[local | halo slabs | pad]`` of
        ``halo_ext_nodes`` rows that ext-local sources index."""
        return MessagePassing._ext_tables(node_states, batch)

    @staticmethod
    def _halo_recv(node_states: torch.Tensor,
                   batch: GraphBatch) -> Optional[torch.Tensor]:
        """The boundary rows this shard receives, without the local rows:
        per ring distance the ppermute of the rows its send list names, or
        the all_to_all of the dense send lists (one [max_send] block a
        shard). None where the ring has no active distance (then no shard
        calls a collective)."""
        from ...parallel.collectives import all_to_all, ppermute

        axis = batch.spmd_axis
        if batch.halo_ring_send is not None:
            parts = [ppermute(gather_rows(node_states, idx), axis, k)
                     for k, idx in zip(batch.halo_ring_dists,
                                       batch.halo_ring_send)]
            if not parts:
                return None
            return torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]
        idx = batch.halo_send_idx                 # [S, max_send]
        send = gather_rows(node_states, idx.reshape(-1))
        return all_to_all(send, axis)

    def forward(self, node_states: torch.Tensor, batch: GraphBatch,
                training: bool = False) -> torch.Tensor:
        halo = batch.spmd_axis is not None and batch.halo_mode
        if halo and self._halo_overlap_capable(batch):
            # The fused route assembles its ext source tables from the
            # local states and the raw boundary rows.
            fused = self._fused_sum_aggregate(node_states, batch, training)
            if fused is not None:
                return self._post_aggregate(fused, node_states, batch,
                                            training)
            src_states = self._exchange_halo(node_states, batch)
        else:
            # The source side reads [local | halo] rows; the aggregation
            # and the update stay local.
            src_states = (self._exchange_halo(node_states, batch) if halo
                          else node_states)
            fused = self._fused_sum_aggregate(src_states, batch, training)
            if fused is not None:
                return self._post_aggregate(fused, node_states, batch,
                                            training)
        messages = self._compute_messages_per_type(src_states, batch,
                                                   training)
        return self._compute_new_node_embeddings(node_states, messages,
                                                 batch, training)

    def _normalize_by_incoming(self, messages: torch.Tensor, edge_type: int,
                               batch: GraphBatch,
                               in_degrees: torch.Tensor) -> torch.Tensor:
        """Each message over the in-degree of its target for this type,
        plus ``SMALL_NUMBER`` (reference base.py:305-317)."""
        per_edge = gather_rows(in_degrees[edge_type],
                               batch.edge_targets[edge_type])
        return messages * (1.0 / (per_edge + SMALL_NUMBER))[:, None]
