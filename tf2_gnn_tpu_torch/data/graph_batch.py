"""Statically-shaped padded graph batches (port of
``tf2_gnn_tpu/data/graph_batch.py``).

The padding contract is the JAX package's, unchanged:

* nodes padded to ``num_nodes_padded`` rows (zeros),
* each edge type padded to its ``edge_budgets[l]`` with edges pointing
  pad-node -> pad-node, so padded messages scatter ONLY into the pad row,
* graphs padded to ``num_graphs_padded`` segments; pad nodes map to the
  last graph slot.

``pad_batch_arrays`` and the label pads are the same numpy code. The
``GraphBatch`` here is a plain dataclass holding only the fields the RGCN,
RGAT and GNN_Edge_MLP node-classification paths read; the SPMD and halo
fields are not ported yet. ``.to(device)`` moves every array field to a
device and builds, once per batch, the device forms of the host plans: the
concatenated streamed plan of the per-type plans (``pair_stream_joint``),
the merged pair plan (``pair_merged``) and the scatter plan
(``scatter_merged``).
"""
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.pair_spmm import MergedPlan, StreamJointPlan, stream_joint_plan
from ..ops.sorted_spmm import ScatterPlan
from ..utils.device import as_tensor, resolve_device


@dataclasses.dataclass(frozen=True)
class PaddingConfig:
    """Static shape budgets for one batch stream (fixed per dataset+fold)."""

    num_nodes: int
    num_graphs: int
    edge_budgets: Tuple[int, ...]

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
    * ``pair_plans_typed``: one 13-array ``PairPlans.astuple()`` per edge
      type (ops/pair_spmm.py), or None; host (numpy) plan data
    * ``pair_stream_joint``: the per-type plans concatenated into the
      streamed layout on the batch's device (``.to`` builds it)
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
    pair_plans_typed: Optional[Tuple[Tuple[object, ...], ...]] = None
    pair_stream_joint: Optional[StreamJointPlan] = None
    pair_plans: Optional[Tuple[object, ...]] = None
    pair_targets_merged: bool = False
    pair_merged: Optional[MergedPlan] = None
    scatter_plans: Optional[Tuple[object, ...]] = None
    scatter_merged: Optional[ScatterPlan] = None

    @property
    def num_nodes_padded(self) -> int:
        return int(self.node_features.shape[0])

    @property
    def num_edge_types(self) -> int:
        return len(self.edge_sources)

    @property
    def node_mask(self) -> torch.Tensor:
        """f32 [V]: 1.0 for real nodes, 0.0 for padding."""
        device = (self.node_features.device
                  if isinstance(self.node_features, torch.Tensor) else None)
        return (torch.arange(self.num_nodes_padded, device=device)
                < self.num_nodes).to(torch.float32)

    def replace(self, **changes) -> "GraphBatch":
        return dataclasses.replace(self, **changes)

    def to(self, device="cuda") -> "GraphBatch":
        """Every array field as a tensor on ``device``; the host plans stay
        host data and their device forms move instead (the per-type plans
        as their streamed concatenation, the merged plans as a
        ``MergedPlan``, the scatter plans as a ``ScatterPlan``)."""
        dev = resolve_device(device)
        joint = self.pair_stream_joint
        if joint is None and self.pair_plans_typed is not None:
            v = self.num_nodes_padded
            joint = stream_joint_plan(self.pair_plans_typed, v, v)
        merged = self.pair_merged
        if merged is None and self.pair_plans is not None:
            v = self.num_nodes_padded
            merged = MergedPlan(
                *self.pair_plans,
                out_rows=(self.num_edge_types * v if self.pair_targets_merged
                          else v))
        scatter = self.scatter_merged
        if scatter is None and self.scatter_plans is not None:
            scatter = ScatterPlan.from_host(self.scatter_plans,
                                            self.num_nodes_padded,
                                            self.num_edge_types)
        return dataclasses.replace(
            self,
            node_features=as_tensor(self.node_features, dev),
            edge_sources=tuple(as_tensor(s, dev) for s in self.edge_sources),
            edge_targets=tuple(as_tensor(t, dev) for t in self.edge_targets),
            node_to_graph=as_tensor(self.node_to_graph, dev),
            num_edges=as_tensor(self.num_edges, dev),
            pair_stream_joint=None if joint is None else joint.to(dev),
            pair_merged=None if merged is None else merged.to(dev),
            scatter_merged=None if scatter is None else scatter.to(dev),
        )


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
