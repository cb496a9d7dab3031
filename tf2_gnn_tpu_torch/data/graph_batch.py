"""Statically-shaped padded graph batches (port of
``tf2_gnn_tpu/data/graph_batch.py``).

The padding contract is the JAX package's, unchanged:

* nodes padded to ``num_nodes_padded`` rows (zeros),
* each edge type padded to its ``edge_budgets[l]`` with edges pointing
  pad-node -> pad-node, so padded messages scatter ONLY into the pad row,
* graphs padded to ``num_graphs_padded`` segments; pad nodes map to the
  last graph slot.

``pad_batch_arrays`` and the label pads are the same numpy code, and
``pad_batch_arrays`` fills the per-type in-degrees (``host_in_degrees``).
The ``GraphBatch`` here is a plain dataclass holding the fields the
message-passing flavours and the node- and graph-level task heads read,
and the SPMD fields of one shard of a node-partitioned graph
(``parallel/spmd.py::partition_graph``): the mesh axis, the halo send
lists and ring distances, the ext row count and the node order's
restore map. ``stack`` and ``shard`` put a leading shard axis on every
array field and take it off again. ``.to(device)`` moves every
array field to a device and builds, once per batch, the device forms of
the merged pair plan (``pair_merged``) and the scatter plan
(``scatter_merged``). The per-type plans have three device forms, each
read by other models: the concatenated streamed plan for the joint sum
over types (``pair_stream_joint``: RGCN, GGNN, RGIN and the source-only
GNN_Edge_MLP), the same concatenation for per-type aggregates
(``pair_stream_typed``: GNN-FiLM and the 0-hidden target-state
GNN_Edge_MLP) and the plans one by one (``pair_typed``, RGAT). Each is
built and moved at its first read and kept with the batch, so a batch
moves only the form its model reads. The unfused per-edge path's sums
read the edge arrays' orders (``ops/segment.py::SegmentOrder``) the same
way: the concatenated targets' (``aggregation_order``) at a layer's first
aggregation, and each type's sources or targets over a table's rows at
the first gather that needs a gradient, each built on the batch's device
once and kept.
"""
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.pair_spmm import (
    MergedPlan,
    StreamJointPlan,
    StreamTypedPlan,
    stream_joint_plan,
    stream_typed_plan,
)
from ..ops.segment import SegmentOrder, gather_rows
from ..ops.sorted_spmm import ScatterPlan
from ..utils.device import as_tensor, resolve_device


@dataclasses.dataclass(frozen=True)
class PaddingConfig:
    """Static shape budgets for one batch stream (fixed per dataset+fold)."""

    num_nodes: int
    num_graphs: int
    edge_budgets: Tuple[int, ...]
    # Static chunk budgets of the merged pair plan (ops/pair_spmm.py), and
    # its overflow slots; None when the dataset builds no pair plans.
    pair_chunks_fwd: Optional[int] = None
    pair_chunks_bwd: Optional[int] = None
    pair_overflow: Optional[int] = None
    # Per-type (fwd, bwd) chunk budgets when the dataset builds one pair
    # plan per edge type (``pair_per_type``).
    pair_chunks_typed: Optional[Tuple[Tuple[int, int], ...]] = None
    # The plans' groups (chunks sharing one output block; chosen per
    # dataset by ops/pair_spmm.py::choose_pair_groups).
    pair_group_fwd: Optional[int] = None
    pair_group_bwd: Optional[int] = None

    @property
    def num_edge_types(self) -> int:
        return len(self.edge_budgets)


@dataclasses.dataclass
class GraphBatch:
    """One padded mega-graph (a batch of disconnected graphs).

    Shapes (V = padded node count, L = edge types, E_l = per-type edge
    budget, G = padded graph count, D = node feature dim):

    * ``node_features``: f32 [V, D]
    * ``edge_sources`` / ``edge_targets``: tuple of L int32 [E_l]
    * ``node_to_graph``: int32 [V] (pad nodes -> G - 1)
    * ``num_nodes`` / ``num_graphs``: python ints (real counts)
    * ``num_edges``: int32 [L] (real counts per type)
    * ``in_degrees``: f32 [L, V] per-type in-degree over the padded edge
      lists (``host_in_degrees``; the pad row counts the padded edges),
      or None
    * ``pair_plans_typed``: one 13-array ``PairPlans.astuple()`` per edge
      type (ops/pair_spmm.py), or None; host (numpy) plan data
    * ``pair_stream_joint`` (property): the per-type plans concatenated
      into the streamed layout on the batch's device, for the joint sum
      over types, or None
    * ``pair_stream_typed`` (property): the same concatenation for the
      per-type aggregates (``out_rows`` L * V), or None
    * ``pair_typed`` (property): the per-type plans as they are, one
      ``MergedPlan`` per type (``out_rows`` V, sources in that type's
      [V]-row slab) on the batch's device, as RGAT's per-type attention
      reads them, or None
    * ``pair_plans``: one merged 13-array ``PairPlans.astuple()`` over all
      edge types (sources in the stacked ``l * V + u`` row space), or None;
      host (numpy) plan data. ``pair_targets_merged``: it was built with
      ``merge_targets=True``
    * ``pair_merged``: ``pair_plans`` on the batch's device (``.to`` builds
      it, with ``out_rows`` L * V for merged targets, else V)
    * ``scatter_plans``: the 12-array ``MergedScatterPlan.astuple()`` of the
      scatter-plan route (ops/sorted_spmm.py), or None; host (numpy) plan
      data. ``scatter_merged``: it on the batch's device (``.to`` builds
      it)

    A batch without any plan takes the unfused per-edge path
    (``gather_source_rows``, ``gather_target_rows``, then a segment
    aggregation over ``aggregation_segments``).

    One shard of a node-partitioned graph (``parallel/spmd.py``, JAX
    graph_batch.py:83-147) also carries:

    * ``spmd_axis``: the mesh axis the shards span (graph-level
      reductions psum over it), and ``spmd_num_shards``; edge targets are
      local, padded slots at the discard row V, one past the last;
    * in halo mode (``halo_mode``), EXT-LOCAL edge sources into the
      ``halo_ext_nodes`` rows ``[local | halo slabs | pad]``, which each
      layer fills by a boundary exchange: ``halo_send_idx`` int32
      [S, max_send], the local rows sent to each shard by one all_to_all,
      or ``halo_ring_send`` (one int32 [m_i] a ring distance
      ``halo_ring_dists[i]``, one ppermute each); without them, GLOBAL
      edge sources, resolved by an all_gather of the source table
      (``gather_source_rows``);
    * ``node_restore``: int32 [rows], the original node id at each local
      row (-1 on padding) where the partitioner reordered the nodes.

    A stacked batch (``stack`` of per-shard or per-device batches) holds
    every array field with a leading shard axis, ``num_nodes`` and
    ``num_graphs`` as int32 [S]; ``shard(index)`` takes one shard back.

    Array fields hold numpy arrays after ``pad_batch_arrays`` and tensors
    after ``.to(device)``.
    """

    node_features: object
    edge_sources: Tuple[object, ...]
    edge_targets: Tuple[object, ...]
    node_to_graph: object
    num_nodes: int
    num_edges: object
    num_graphs: int
    num_graphs_padded: int
    in_degrees: object = None
    pair_plans_typed: Optional[Tuple[Tuple[object, ...], ...]] = None
    pair_plans: Optional[Tuple[object, ...]] = None
    pair_targets_merged: bool = False
    pair_merged: Optional[MergedPlan] = None
    scatter_plans: Optional[Tuple[object, ...]] = None
    scatter_merged: Optional[ScatterPlan] = None
    spmd_axis: Optional[str] = None
    spmd_num_shards: Optional[int] = None
    halo_send_idx: object = None
    halo_ext_nodes: Optional[int] = None
    halo_ring_send: Optional[Tuple[object, ...]] = None
    halo_ring_dists: Optional[Tuple[int, ...]] = None
    node_restore: object = None
    # The per-type plans' device forms, by name, built at first read. A
    # batch replaced in its node features alone, by a tensor with the same
    # rows on the same device, shares them (``replace``); any other
    # replaced or moved batch starts with none.
    _typed_forms: Dict[str, object] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    # The edge arrays' segment orders, by (arrays, edge type, segments),
    # built at first read and shared as ``_typed_forms`` are.
    _edge_orders: Dict[tuple, SegmentOrder] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def num_nodes_padded(self) -> int:
        return int(self.node_features.shape[-2])

    @property
    def halo_mode(self) -> bool:
        """True when sources are EXT-LOCAL ids resolved by a per-layer
        boundary exchange (dense all_to_all or ppermute ring)."""
        return (self.halo_send_idx is not None
                or self.halo_ring_send is not None)

    @property
    def pair_src_space(self) -> int:
        """Rows of ONE edge type's source table for the plans: the ext row
        space under SPMD-halo, else the padded node count."""
        if self.halo_mode and self.halo_ext_nodes is not None:
            return self.halo_ext_nodes
        return self.num_nodes_padded

    @property
    def scatter_src_space(self) -> int:
        """Rows of one edge type's source table for the scatter plans: the
        global row count ``V * S`` under SPMD without a halo (global
        sources, all_gather-ed tables), else ``pair_src_space``."""
        if self.spmd_axis is not None and not self.halo_mode:
            return self.num_nodes_padded * self.spmd_num_shards
        return self.pair_src_space

    @property
    def num_edge_types(self) -> int:
        return len(self.edge_sources)

    @property
    def pad_node_index(self) -> int:
        return self.num_nodes_padded - 1

    @property
    def node_mask(self) -> torch.Tensor:
        """f32 [V]: 1.0 for real nodes, 0.0 for padding."""
        device = (self.node_features.device
                  if isinstance(self.node_features, torch.Tensor) else None)
        return (torch.arange(self.num_nodes_padded, device=device)
                < self.num_nodes).to(torch.float32)

    @property
    def graph_mask(self) -> torch.Tensor:
        """f32 [G]: 1.0 for real graphs, 0.0 for padding."""
        device = (self.node_features.device
                  if isinstance(self.node_features, torch.Tensor) else None)
        return (torch.arange(self.num_graphs_padded, device=device)
                < self.num_graphs).to(torch.float32)

    def edge_mask(self, edge_type: int) -> torch.Tensor:
        """f32 [E_l]: 1.0 for the real edges of type ``edge_type``."""
        device = (self.node_features.device
                  if isinstance(self.node_features, torch.Tensor) else None)
        budget = self.edge_sources[edge_type].shape[0]
        real = self.num_edges[edge_type]
        if not isinstance(real, torch.Tensor):
            real = int(real)
        return (torch.arange(budget, device=device) < real).to(torch.float32)

    # The unfused per-edge path's views (reference graph_batch.py:174-207).
    @property
    def aggregation_segments(self) -> int:
        """Segment count of the scatter-reduces over edge targets: the
        node rows, plus under SPMD the trailing discard row of the padded
        edge slots."""
        return self.num_nodes_padded + (1 if self.spmd_axis is not None
                                        else 0)

    def slice_aggregated(self, aggregated: torch.Tensor) -> torch.Tensor:
        """The node rows of an ``[aggregation_segments, ...]`` array (the
        SPMD discard row dropped)."""
        if self.spmd_axis is None:
            return aggregated
        return aggregated[:self.num_nodes_padded]

    def _edge_order(self, key: tuple, num_segments: int,
                    ids) -> Optional[SegmentOrder]:
        """The order of the edge ids ``ids()`` over ``num_segments``, built
        at its first read and kept under ``key``; None while the edge
        arrays are host arrays."""
        if not (self.edge_targets
                and isinstance(self.edge_targets[0], torch.Tensor)):
            return None
        key = key + (num_segments,)
        if key not in self._edge_orders:
            self._edge_orders[key] = SegmentOrder.build(ids(), num_segments)
        return self._edge_orders[key]

    @property
    def aggregation_order(self) -> Optional[SegmentOrder]:
        """The order of every type's edge targets, concatenated in type
        order, over ``aggregation_segments``: the unfused path's sums of
        its messages."""
        return self._edge_order(
            ("targets", None), self.aggregation_segments,
            lambda: torch.cat(self.edge_targets, dim=0))

    def _gather(self, table: torch.Tensor, name: str,
                edge_type: int) -> torch.Tensor:
        ids = getattr(self, name)[edge_type]
        order = (self._edge_order((name, edge_type), table.shape[0],
                                  lambda: ids)
                 if table.requires_grad else None)
        return gather_rows(table, ids, order)

    def gather_source_rows(self, table: torch.Tensor,
                           edge_type: int) -> torch.Tensor:
        """Per-edge rows of a node-space ``table`` ([V, ...], or the ext
        rows in halo mode) at the sources of type ``edge_type``'s edges
        (padded edges clamp). Under SPMD without a halo the table is first
        all_gather-ed over the mesh axis, so GLOBAL sources resolve. The
        gradient sums over the sources' order."""
        if self.spmd_axis is not None and not self.halo_mode:
            from ..parallel.collectives import all_gather

            table = all_gather(table, self.spmd_axis)
        return self._gather(table, "edge_sources", edge_type)

    def gather_target_rows(self, table: torch.Tensor,
                           edge_type: int) -> torch.Tensor:
        """Per-edge rows of ``table`` at the targets of type
        ``edge_type``'s edges; the gradient sums over the targets'
        order."""
        return self._gather(table, "edge_targets", edge_type)

    def _typed_form(self, name: str, build):
        if (self.pair_plans_typed is None
                or not isinstance(self.node_features, torch.Tensor)):
            return None
        if name not in self._typed_forms:
            self._typed_forms[name] = build(self.node_features.device)
        return self._typed_forms[name]

    @property
    def pair_stream_joint(self) -> Optional[StreamJointPlan]:
        v, vs = self.num_nodes_padded, self.pair_src_space
        return self._typed_form("joint", lambda dev: stream_joint_plan(
            self.pair_plans_typed, vs, v).to(dev))

    @property
    def pair_stream_typed(self) -> Optional[StreamTypedPlan]:
        v, vs = self.num_nodes_padded, self.pair_src_space
        return self._typed_form("stream_typed", lambda dev: stream_typed_plan(
            self.pair_plans_typed, vs, v).to(dev))

    @property
    def pair_typed(self) -> Optional[Tuple[MergedPlan, ...]]:
        v = self.num_nodes_padded
        return self._typed_form("typed", lambda dev: tuple(
            MergedPlan.from_host(p, v).to(dev)
            for p in self.pair_plans_typed))

    def replace(self, **changes) -> "GraphBatch":
        """``dataclasses.replace``. Where only the node features change, to
        a tensor with the same rows on the same device, the new batch
        shares the per-type plans' device forms and the edge orders, so a
        model that swaps in its own input features builds them once for
        the batch."""
        new = dataclasses.replace(self, **changes)
        old, feats = self.node_features, changes.get("node_features")
        if (changes.keys() == {"node_features"}
                and isinstance(old, torch.Tensor)
                and isinstance(feats, torch.Tensor)
                and feats.shape[-2] == old.shape[-2]
                and feats.device == old.device):
            new._typed_forms = self._typed_forms
            new._edge_orders = self._edge_orders
        return new

    def to(self, device="cuda") -> "GraphBatch":
        """Every array field as a tensor on ``device``; the host plans stay
        host data and their device forms move instead (the merged plans as
        a ``MergedPlan``, the scatter plans as a ``ScatterPlan``; the
        per-type plans' forms at their first read)."""
        dev = resolve_device(device)
        merged = self.pair_merged
        if merged is None and self.pair_plans is not None:
            v = self.num_nodes_padded
            merged = MergedPlan.from_host(
                self.pair_plans,
                self.num_edge_types * v if self.pair_targets_merged else v)
        scatter = self.scatter_merged
        if scatter is None and self.scatter_plans is not None:
            scatter = ScatterPlan.from_host(self.scatter_plans,
                                            self.num_nodes_padded,
                                            self.num_edge_types,
                                            self.scatter_src_space)

        def move(x):
            return None if x is None else as_tensor(x, dev)

        return dataclasses.replace(
            self,
            node_features=as_tensor(self.node_features, dev),
            edge_sources=tuple(as_tensor(s, dev) for s in self.edge_sources),
            edge_targets=tuple(as_tensor(t, dev) for t in self.edge_targets),
            node_to_graph=as_tensor(self.node_to_graph, dev),
            num_edges=as_tensor(self.num_edges, dev),
            in_degrees=move(self.in_degrees),
            pair_merged=None if merged is None else merged.to(dev),
            scatter_merged=None if scatter is None else scatter.to(dev),
            halo_send_idx=move(self.halo_send_idx),
            halo_ring_send=(None if self.halo_ring_send is None else tuple(
                as_tensor(x, dev) for x in self.halo_ring_send)),
            node_restore=move(self.node_restore),
        )

    def array_fields(self) -> List[Tuple[str, object]]:
        """(path, array) of every array field that a shard axis stacks, in
        a fixed order; tuple members by index (``edge_sources[0]``,
        ``pair_plans_typed[1][3]``). The device forms of the plans are
        not among them: stack and shard host batches."""
        out = []

        def walk(path, x):
            if isinstance(x, (tuple, list)):
                for i, item in enumerate(x):
                    walk(f"{path}[{i}]", item)
            elif x is not None:
                out.append((path, x))

        for name in ARRAY_FIELDS:
            walk(name, getattr(self, name))
        return out

    def map_arrays(self, fn) -> "GraphBatch":
        """A batch whose array fields (``array_fields``) are ``fn(x)``,
        the tuple structure kept."""
        def walk(x):
            if isinstance(x, (tuple, list)):
                return tuple(walk(item) for item in x)
            return None if x is None else fn(x)

        return dataclasses.replace(self, **{
            name: walk(getattr(self, name)) for name in ARRAY_FIELDS})

    def shard(self, index) -> "GraphBatch":
        """Shard ``index`` (an int, or a tuple for a batch stacked twice)
        of a stacked batch: every array field at that leading index, and
        ``num_nodes`` / ``num_graphs`` as python ints."""
        index = index if isinstance(index, tuple) else (index,)
        one = self.map_arrays(lambda x: np.asarray(x)[index])
        return dataclasses.replace(one, num_nodes=int(one.num_nodes),
                                   num_graphs=int(one.num_graphs))

    @staticmethod
    def stack(batches: Sequence["GraphBatch"]) -> "GraphBatch":
        """The host batches stacked along a new leading axis, every array
        field (``num_nodes`` and ``num_graphs`` as int32 arrays); the
        other fields are the first batch's."""
        first = batches[0]
        fields = [b.array_fields() for b in batches]
        counts = ("num_nodes", "num_graphs")   # python ints on one batch
        stacked = iter([np.stack([np.asarray(
            f[i][1], np.int32 if f[i][0] in counts else None)
            for f in fields]) for i in range(len(fields[0]))])
        return first.map_arrays(lambda _: next(stacked))


# The array fields of a batch, which a shard axis stacks: the JAX
# GraphBatch's pytree leaves, in its field order.
ARRAY_FIELDS = ("node_features", "edge_sources", "edge_targets",
                "node_to_graph", "num_nodes", "num_edges", "num_graphs",
                "scatter_plans", "pair_plans", "pair_plans_typed",
                "in_degrees", "halo_send_idx", "halo_ring_send",
                "node_restore")


def pad_batch_arrays(
    node_features: np.ndarray,
    adjacency_lists: Sequence[np.ndarray],
    node_to_graph: np.ndarray,
    num_graphs: int,
    config: PaddingConfig,
) -> GraphBatch:
    """Pad ragged numpy batch arrays up to ``config``'s budgets (numpy; the
    output's arrays stay on the host until ``.to(device)``)."""
    num_real_nodes = node_features.shape[0]
    v_pad = config.num_nodes
    if num_real_nodes > v_pad - 1:
        raise ValueError(
            f"Batch has {num_real_nodes} nodes but padded budget {v_pad} requires "
            f"at most {v_pad - 1} (one pad node is reserved as scatter sink)."
        )
    if num_graphs > config.num_graphs - 1:
        raise ValueError(
            f"Batch has {num_graphs} graphs but padded budget {config.num_graphs} "
            f"requires at most {config.num_graphs - 1}."
        )
    if len(adjacency_lists) != config.num_edge_types:
        raise ValueError(
            f"Batch has {len(adjacency_lists)} edge types, config expects "
            f"{config.num_edge_types}."
        )

    feat = np.zeros((v_pad, node_features.shape[1]), dtype=np.float32)
    feat[:num_real_nodes] = node_features

    n2g = np.full((v_pad,), config.num_graphs - 1, dtype=np.int32)
    n2g[:num_real_nodes] = node_to_graph

    pad_node = v_pad - 1
    sources: List[np.ndarray] = []
    targets: List[np.ndarray] = []
    real_edge_counts: List[int] = []
    for edge_type, adj in enumerate(adjacency_lists):
        budget = config.edge_budgets[edge_type]
        count = adj.shape[0]
        if count > budget:
            raise ValueError(
                f"Edge type {edge_type} has {count} edges, over budget {budget}."
            )
        src = np.full((budget,), pad_node, dtype=np.int32)
        tgt = np.full((budget,), pad_node, dtype=np.int32)
        if count:
            src[:count] = adj[:, 0]
            tgt[:count] = adj[:, 1]
        sources.append(src)
        targets.append(tgt)
        real_edge_counts.append(count)

    return GraphBatch(
        node_features=feat,
        edge_sources=tuple(sources),
        edge_targets=tuple(targets),
        node_to_graph=n2g,
        num_nodes=int(num_real_nodes),
        num_edges=np.asarray(real_edge_counts, dtype=np.int32),
        num_graphs=int(num_graphs),
        num_graphs_padded=config.num_graphs,
        in_degrees=host_in_degrees(targets, v_pad),
    )


def host_in_degrees(padded_targets: Sequence[np.ndarray],
                    num_nodes_padded: int) -> np.ndarray:
    """f32 [L, V] per-type in-degree over the FULL padded target arrays
    (padded edges land on the pad row; discard-row targets, index V, are
    dropped)."""
    deg = np.zeros((len(padded_targets), num_nodes_padded), np.float32)
    for l, tgt in enumerate(padded_targets):
        counts = np.bincount(np.asarray(tgt).reshape(-1),
                             minlength=num_nodes_padded + 1)
        deg[l] = counts[:num_nodes_padded]
    return deg


def pad_node_label_array(values: np.ndarray, num_nodes_padded: int) -> np.ndarray:
    """Zero-pad a per-node label array [V_real, ...] up to [V_pad, ...]."""
    out = np.zeros((num_nodes_padded,) + values.shape[1:], dtype=values.dtype)
    out[: values.shape[0]] = values
    return out


def pad_graph_label_array(values: np.ndarray,
                          num_graphs_padded: int) -> np.ndarray:
    """Zero-pad a per-graph label array [G_real, ...] up to [G_pad, ...]."""
    values = np.asarray(values)
    out = np.zeros((num_graphs_padded,) + values.shape[1:], dtype=values.dtype)
    out[: values.shape[0]] = values
    return out
