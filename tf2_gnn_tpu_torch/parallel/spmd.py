"""SPMD node-partitioned execution of one giant graph across ranks (port of
``tf2_gnn_tpu/parallel/spmd.py``).

* each shard owns a contiguous node range (features, labels, node states);
* each edge lives on the shard that owns its TARGET node;
* per layer, the shards exchange the boundary rows their edges read (a
  halo: one all_to_all, or one ppermute a ring distance), or without a
  halo all_gather the source tables, and aggregate locally; padded edge
  slots scatter into a per-shard discard row;
* graph-level readouts and per-node losses psum their partial sums (the
  layers read ``GraphBatch.spmd_axis``).

``partition_graph`` (numpy) is array-identical to the JAX package's for
every halo form, reorder and plan kind, over the port's own planners. Each
rank runs the steps in its own process on its shard
(``distribute_batch``). The per-shard backward gives each shard the
partial gradient of the replicated loss times S (the transpose of psum is
psum); the mean over the shards completes it exactly.
"""
import math
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.graph_batch import GraphBatch, host_in_degrees
from ..utils.shapes import round_up as _round_up
from . import collectives
from .data_parallel import (
    _detached,
    local_grads,
    mean_gradients,
    rank_generator,
)


class ReorderEngaged(UserWarning):
    """partition_graph(reorder='auto') permuted the node order (see the
    ``reorder`` doc — route per-node outputs through restore_node_order)."""


def partition_graph(
    node_features: np.ndarray,
    adjacency_lists: Sequence[np.ndarray],
    node_to_graph: np.ndarray,
    num_graphs: int,
    num_shards: int,
    axis_name: str = "nodes",
    node_alignment: int = 8,
    edge_alignment: int = 64,
    node_labels: Optional[Dict[str, np.ndarray]] = None,
    graph_labels: Optional[Dict[str, np.ndarray]] = None,
    num_graphs_padded: Optional[int] = None,
    build_scatter_plans: bool = False,
    build_pair_plans: bool = False,
    pair_merge_targets: bool = False,
    pair_per_type: bool = False,
    halo="auto",
    reorder="auto",
) -> Tuple[GraphBatch, Dict[str, np.ndarray]]:
    """Host-side partitioner: giant graph -> stacked per-shard GraphBatch.

    Returns a GraphBatch whose array fields carry a leading shard axis
    (``distribute_batch`` gives each rank its own) plus stacked labels.
    ``edge_targets`` become local to the target's owning shard, with padded
    slots -> the discard row.

    With ``halo`` enabled (default ``"auto"``) the partitioner also plans
    the boundary-only exchange: per (owner, consumer) pair it lists the
    rows the consumer's edges actually reference, ``edge_sources`` are
    remapped to EXT-LOCAL ids into per-slab halo rows, and every layer
    moves only those boundary rows (bytes ~ boundary * D) instead of
    all_gathering the full node table (bytes ~ S * V * D). Two wire forms,
    chosen by byte count under ``"auto"`` (or forced with ``halo="dense"``
    / ``halo="ring"``): a dense all_to_all padded per (owner, consumer)
    pair, or one ppermute per active ring distance padded per DISTANCE —
    the win for locality-sorted graphs, where only neighbouring shards
    exchange. ``halo=False`` keeps GLOBAL source ids + the per-layer
    all_gather.

    ``reorder`` applies the RCM locality pass (``parallel/reorder.py``)
    BEFORE cutting contiguous ranges: ``"auto"`` (default) relabels only
    when it strictly shrinks the boundary row count; ``True`` forces it;
    ``False`` disables it. When applied, node features / labels /
    node_to_graph are permuted consistently and the returned batch carries
    ``node_restore`` — feed per-node OUTPUTS through
    ``restore_node_order(out, batch)`` to get them back in the caller's
    original node order. ``"auto"``'s engagement emits a
    ``ReorderEngaged`` warning; pass ``reorder=True`` or ``reorder=False``
    to silence it.
    """
    num_nodes = node_features.shape[0]
    if build_pair_plans and not halo:
        raise ValueError(
            "build_pair_plans requires a halo form (the pair kernels consume "
            "ext-local source ids; the legacy all_gather path has no ext row "
            "space). Use build_scatter_plans for halo=False."
        )
    if build_scatter_plans or build_pair_plans:
        # The plans tile node rows in BLOCK_NODES blocks.
        from ..ops.sorted_spmm import BLOCK_NODES

        node_alignment = max(node_alignment, BLOCK_NODES)
    nodes_per_shard = _round_up(
        int(math.ceil(num_nodes / num_shards)), node_alignment
    )
    if num_graphs_padded is None:
        num_graphs_padded = num_graphs + 1

    node_restore = None
    if reorder and num_shards > 1:
        from .reorder import apply_node_permutation, locality_reorder

        perm = locality_reorder(adjacency_lists, num_nodes)
        if reorder == "auto":
            inv = np.empty((num_nodes,), np.int64)
            inv[perm] = np.arange(num_nodes)
            apply_it = (
                _boundary_row_count(adjacency_lists, nodes_per_shard, inv)
                < _boundary_row_count(adjacency_lists, nodes_per_shard, None)
            )
        else:
            apply_it = True
        if apply_it:
            if reorder == "auto":
                warnings.warn(
                    "partition_graph(reorder='auto') engaged RCM node "
                    "reordering (it shrinks the halo boundary for this "
                    "graph). Per-node outputs and returned node labels are "
                    "in the REORDERED layout; pass them through "
                    "restore_node_order(out, batch) to recover the input "
                    "node order. Silence with reorder=True (intentional) "
                    "or reorder=False (disable).",
                    ReorderEngaged, stacklevel=2,
                )
            (node_features, adjacency_lists, node_to_graph,
             node_labels) = apply_node_permutation(
                perm, node_features, adjacency_lists, node_to_graph,
                node_labels)
            # Original node id living at each (shard, local row); -1 pads.
            node_restore = np.full((num_shards, nodes_per_shard), -1,
                                   np.int32)
            for s in range(num_shards):
                lo = s * nodes_per_shard
                real = int(np.clip(num_nodes - lo, 0, nodes_per_shard))
                if real:
                    node_restore[s, :real] = perm[lo:lo + real]

    # Per-shard real node counts (contiguous ranges; each shard's real
    # nodes are a prefix of its rows).
    shard_real_nodes = [
        int(np.clip(num_nodes - s * nodes_per_shard, 0, nodes_per_shard))
        for s in range(num_shards)
    ]

    # Assign edges to the shard owning the target.
    num_types = len(adjacency_lists)
    shard_edges: List[List[np.ndarray]] = [
        [None] * num_types for _ in range(num_shards)
    ]
    for edge_type, adj in enumerate(adjacency_lists):
        adj = np.asarray(adj, dtype=np.int64).reshape(-1, 2)
        owner = adj[:, 1] // nodes_per_shard
        for s in range(num_shards):
            shard_edges[s][edge_type] = adj[owner == s]

    edge_budgets = tuple(
        _round_up(
            max(shard_edges[s][t].shape[0] for s in range(num_shards)),
            edge_alignment,
        )
        for t in range(num_types)
    )

    feat_dim = node_features.shape[1]
    features = np.zeros((num_shards, nodes_per_shard, feat_dim),
                        dtype=np.float32)
    n2g = np.full((num_shards, nodes_per_shard), num_graphs_padded - 1,
                  dtype=np.int32)
    sources = [
        np.zeros((num_shards, edge_budgets[t]), dtype=np.int32)
        for t in range(num_types)
    ]
    targets = [
        # Padded slots point at the discard row (index nodes_per_shard).
        np.full((num_shards, edge_budgets[t]), nodes_per_shard,
                dtype=np.int32)
        for t in range(num_types)
    ]
    num_edges = np.zeros((num_shards, num_types), dtype=np.int32)

    for s in range(num_shards):
        lo = s * nodes_per_shard
        real = shard_real_nodes[s]
        if real:
            features[s, :real] = node_features[lo:lo + real]
            n2g[s, :real] = node_to_graph[lo:lo + real]
        for t in range(num_types):
            e = shard_edges[s][t]
            count = e.shape[0]
            if count:
                sources[t][s, :count] = e[:, 0]
                targets[t][s, :count] = e[:, 1] - lo
            num_edges[s, t] = count

    halo_send_idx = None
    halo_ring_send = None
    halo_ring_dists = None
    ext_nodes = None
    if halo:
        # Per (consumer, owner): the sorted unique global rows the
        # consumer's edges reference on that owner. The owner's send list
        # to each destination is the same set in its local row ids.
        needed: List[List[np.ndarray]] = []
        for s in range(num_shards):
            lo, hi = s * nodes_per_shard, (s + 1) * nodes_per_shard
            all_src = np.concatenate(
                [sources[t][s, :num_edges[s, t]] for t in range(num_types)]
            ) if num_edges[s].sum() else np.zeros((0,), np.int64)
            remote = all_src[(all_src < lo) | (all_src >= hi)]
            uniq = np.unique(remote)
            needed.append([
                uniq[(uniq // nodes_per_shard) == r]
                for r in range(num_shards)
            ])
        max_send = max(
            [needed[s][r].shape[0] for s in range(num_shards)
             for r in range(num_shards)] + [1]
        )
        max_send = _round_up(max_send, 8)
        pad_row = nodes_per_shard - 1
        # The dense all_to_all pads EVERY (owner, consumer) pair to
        # max_send; the ring runs one ppermute per ACTIVE distance k (owner
        # r -> consumer (r+k) % S), padded per distance. Pick whichever
        # moves at most half the rows (ties -> dense).
        dist_sizes = []
        for k in range(1, num_shards):
            sizes = [needed[(r + k) % num_shards][r].shape[0]
                     for r in range(num_shards)]
            dist_sizes.append(_round_up(max(sizes), 8) if max(sizes) else 0)
        ring_rows = sum(dist_sizes)
        if halo in ("ring", "dense"):   # forced form
            use_ring = halo == "ring"
        else:
            use_ring = 2 * ring_rows <= num_shards * max_send
        if use_ring:
            active = [(k, m) for k, m in
                      zip(range(1, num_shards), dist_sizes) if m]
            halo_ring_dists = tuple(k for k, _ in active)
            ring_send = []
            dist_base = {}
            off = 0
            for k, m in active:
                idx = np.full((num_shards, m), pad_row, np.int32)
                for r in range(num_shards):
                    rows = (needed[(r + k) % num_shards][r]
                            - r * nodes_per_shard)
                    idx[r, :rows.shape[0]] = rows
                ring_send.append(idx)
                dist_base[k] = off
                off += m
            halo_ring_send = tuple(ring_send)
            ext_nodes = nodes_per_shard + (
                _round_up(off, node_alignment) if off else 0)
        else:
            halo_rows = num_shards * max_send
            ext_nodes = nodes_per_shard + _round_up(halo_rows,
                                                    node_alignment)
            # send list of OWNER r to DESTINATION d = needed[d][r], r-local.
            halo_send_idx = np.full((num_shards, num_shards, max_send),
                                    pad_row, dtype=np.int32)
            for r in range(num_shards):
                for d in range(num_shards):
                    rows = needed[d][r] - r * nodes_per_shard
                    halo_send_idx[r, d, :rows.shape[0]] = rows
        # Remap sources to ext-local ids: halo slot of global row g (owner
        # r) as seen by consumer s = Vp + slab base + position in
        # needed[s][r], the slab being the owner's (dense) or the ring
        # distance's.
        for s in range(num_shards):
            lo = s * nodes_per_shard
            for t in range(num_types):
                cnt = int(num_edges[s, t])
                col = sources[t][s]
                g_ = col[:cnt].astype(np.int64)
                owner = g_ // nodes_per_shard
                ext = g_ - lo  # local rows resolve directly
                for r in range(num_shards):
                    if r == s:
                        continue
                    mask = owner == r
                    if mask.any():
                        pos = np.searchsorted(needed[s][r], g_[mask])
                        base = (dist_base[(s - r) % num_shards] if use_ring
                                else r * max_send)
                        ext[mask] = nodes_per_shard + base + pos
                col[:cnt] = ext
                col[cnt:] = pad_row  # padded slots gather the local pad row

    scatter_plans = None
    if build_scatter_plans:
        from ..ops.sorted_spmm import build_merged_plans

        src_space = ext_nodes if halo else nodes_per_shard * num_shards
        per_shard_plans = []
        for s_ in range(num_shards):
            plan = build_merged_plans(
                [sources[t][s_] for t in range(num_types)],
                [targets[t][s_] for t in range(num_types)],
                [int(num_edges[s_, t]) for t in range(num_types)],
                nodes_per_shard,
                src_space=src_space,
            )
            per_shard_plans.append(plan.astuple())
        scatter_plans = tuple(
            np.stack([p[i] for p in per_shard_plans], axis=0)
            for i in range(len(per_shard_plans[0]))
        )

    pair_plans = None
    pair_plans_typed = None
    if build_pair_plans and pair_per_type:
        # Per-TYPE plans per shard over the ext rows: shared groups (from
        # the busiest shard, type 0) and per-type max budgets so the plans
        # stack on the shard axis.
        if pair_merge_targets:
            raise ValueError(
                "pair_per_type produces per-type aggregates natively; "
                "combine it with pair_merge_targets=False.")
        from ..ops.pair_spmm import build_pair_plans as _build_pair_plans
        from ..ops.pair_spmm import choose_pair_groups, measure_pair_chunks

        busiest = int(np.argmax(num_edges.sum(axis=1)))
        gf, gb = choose_pair_groups(
            [sources[0][busiest]], [targets[0][busiest]],
            [int(num_edges[busiest, 0])], nodes_per_shard,
            src_space=ext_nodes,
        )
        budgets = []
        for t in range(num_types):
            cf = cb = 0
            for s_ in range(num_shards):
                mf, mb = measure_pair_chunks(
                    [sources[t][s_]], [targets[t][s_]],
                    [int(num_edges[s_, t])], nodes_per_shard,
                    src_space=ext_nodes, group_fwd=gf, group_bwd=gb,
                )
                cf = max(cf, _round_up(mf, gf))
                cb = max(cb, _round_up(mb, gb))
            budgets.append((cf, cb))
        typed_stacked = []
        for t in range(num_types):
            per_shard = [
                _build_pair_plans(
                    [sources[t][s_]], [targets[t][s_]],
                    [int(num_edges[s_, t])], nodes_per_shard,
                    src_space=ext_nodes,
                    chunk_budget_fwd=budgets[t][0],
                    chunk_budget_bwd=budgets[t][1],
                    overflow_budget=0, overflow_size=0,
                    group_fwd=gf, group_bwd=gb,
                ).astuple()
                for s_ in range(num_shards)
            ]
            typed_stacked.append(tuple(
                np.stack([p[i] for p in per_shard], axis=0)
                for i in range(len(per_shard[0]))
            ))
        pair_plans_typed = tuple(typed_stacked)
    elif build_pair_plans:
        # Per-shard merged plans over the EXT-LOCAL source rows
        # ``l * ext_nodes + u``: every shard runs the single-chip kernels,
        # targets stay local. Groups come from the BUSIEST shard (the most
        # expensive shard gates the step), budgets are the per-shard
        # maxima, so no edge spills and overflow_size=0 keeps the stacked
        # shapes uniform.
        from ..ops.pair_spmm import build_pair_plans as _build_pair_plans
        from ..ops.pair_spmm import choose_pair_groups, measure_pair_chunks

        def shard_edges_args(s_):
            return (
                [sources[t][s_] for t in range(num_types)],
                [targets[t][s_] for t in range(num_types)],
                [int(num_edges[s_, t]) for t in range(num_types)],
            )

        busiest = int(np.argmax(num_edges.sum(axis=1)))
        gf, gb = choose_pair_groups(
            *shard_edges_args(busiest), nodes_per_shard, src_space=ext_nodes,
            merge_targets=pair_merge_targets,
        )
        cf = cb = 0
        for s_ in range(num_shards):
            mf, mb = measure_pair_chunks(
                *shard_edges_args(s_), nodes_per_shard, src_space=ext_nodes,
                merge_targets=pair_merge_targets,
                group_fwd=gf, group_bwd=gb,
            )
            cf = max(cf, _round_up(mf, gf))
            cb = max(cb, _round_up(mb, gb))
        per_shard_pair = []
        for s_ in range(num_shards):
            plans = _build_pair_plans(
                *shard_edges_args(s_), nodes_per_shard, src_space=ext_nodes,
                chunk_budget_fwd=cf, chunk_budget_bwd=cb,
                overflow_budget=0, overflow_size=0,
                merge_targets=pair_merge_targets,
                group_fwd=gf, group_bwd=gb,
            )
            per_shard_pair.append(plans.astuple())
        pair_plans = tuple(
            np.stack([p[i] for p in per_shard_pair], axis=0)
            for i in range(len(per_shard_pair[0]))
        )

    in_degrees = np.stack([
        host_in_degrees([targets[t][s] for t in range(num_types)],
                        nodes_per_shard)
        for s in range(num_shards)
    ], axis=0)  # [S, L, Vp] (discard-row targets dropped)

    batch = GraphBatch(
        node_features=features,
        edge_sources=tuple(sources),
        edge_targets=tuple(targets),
        node_to_graph=n2g,
        num_nodes=np.asarray(shard_real_nodes, dtype=np.int32),
        num_edges=num_edges,
        num_graphs=np.full((num_shards,), num_graphs, dtype=np.int32),
        num_graphs_padded=num_graphs_padded,
        spmd_axis=axis_name,
        spmd_num_shards=num_shards,
        scatter_plans=scatter_plans,
        pair_plans=pair_plans,
        pair_plans_typed=pair_plans_typed,
        pair_targets_merged=bool(pair_plans is not None
                                 and pair_merge_targets),
        in_degrees=in_degrees,
        halo_send_idx=halo_send_idx,
        halo_ext_nodes=ext_nodes,
        halo_ring_send=halo_ring_send,
        halo_ring_dists=halo_ring_dists,
        node_restore=node_restore,
    )

    labels: Dict[str, np.ndarray] = {}
    for key, values in (node_labels or {}).items():
        padded = np.zeros((num_shards, nodes_per_shard) + values.shape[1:],
                          dtype=values.dtype)
        for s in range(num_shards):
            lo, real = s * nodes_per_shard, shard_real_nodes[s]
            if real:
                padded[s, :real] = values[lo:lo + real]
        labels[key] = padded
    for key, values in (graph_labels or {}).items():
        padded = np.zeros((num_graphs_padded,) + values.shape[1:],
                          dtype=values.dtype)
        padded[:values.shape[0]] = values
        labels[key] = np.broadcast_to(
            padded, (num_shards,) + padded.shape
        ).copy()
    return batch, labels


def _boundary_row_count(adjacency_lists, nodes_per_shard: int,
                        relabel: Optional[np.ndarray]) -> int:
    """Unique (consumer shard, source node) pairs whose edge crosses a
    contiguous-range partition — exactly the rows a halo exchange must move
    per layer. ``relabel`` (inverse permutation) evaluates a candidate
    ordering without building anything."""
    parts = [np.asarray(a, np.int64).reshape(-1, 2)
             for a in adjacency_lists if np.asarray(a).size]
    if not parts:
        return 0
    edges = np.concatenate(parts, axis=0)
    if relabel is not None:
        edges = relabel[edges]
    own_src = edges[:, 0] // nodes_per_shard
    own_tgt = edges[:, 1] // nodes_per_shard
    cross = own_src != own_tgt
    if not cross.any():
        return 0
    span = int(edges[:, 0].max()) + 1
    return np.unique(own_tgt[cross] * span + edges[cross, 0]).size


def restore_node_order(outputs, batch: GraphBatch) -> np.ndarray:
    """Per-node outputs of a partitioned run, in the caller's ORIGINAL node
    order (host-side; [num_real_nodes, ...]).

    ``outputs`` is the stacked per-shard array ([S, rows, ...], as
    ``make_spmd_forward`` returns it), or its flattened form; ``batch`` the
    stacked host batch. When the batch was built with ``reorder``
    applied, ``batch.node_restore`` maps each (shard, row) back to the
    original id; otherwise real rows are per-shard prefixes of the
    identity layout.
    """
    if isinstance(outputs, torch.Tensor):
        outputs = outputs.detach().cpu().float().numpy()
    out = np.asarray(outputs)
    num_shards = batch.spmd_num_shards or 1
    if out.ndim >= 2 and out.shape[0] == num_shards:
        out = out.reshape((out.shape[0] * out.shape[1],) + out.shape[2:])
    if batch.node_restore is None:
        reals = np.atleast_1d(np.asarray(batch.num_nodes))
        rows = out.shape[0] // num_shards
        return np.concatenate([
            out[s * rows:s * rows + int(reals[s])]
            for s in range(num_shards)
        ])
    ids = np.asarray(batch.node_restore).reshape(-1)
    valid = ids >= 0
    restored = np.empty((int(ids.max()) + 1,) + out.shape[1:], out.dtype)
    restored[ids[valid]] = out[:ids.shape[0]][valid]
    return restored


def make_spmd_train_step(model, optimizer, mesh, axis_name: str = "nodes"
                         ) -> Callable:
    """Node-partitioned train step over ``mesh``: (TrainState, this rank's
    shard, labels) -> (TrainState, metrics), run by every rank in its own
    process.

    The per-shard backward gives partial gradients of the *global* loss;
    the loss is replicated (psum-ed inside the metrics) and the transpose
    of psum is psum, so each shard's cotangent carries a factor of S, and
    the mean of the gradients over the shards completes them to exactly
    the gradient of the one global loss. Parameters stay replicated."""
    generators: Dict[int, torch.Generator] = {}

    def train_step(state, batch: GraphBatch, labels):
        collectives.use_mesh(mesh)
        index = collectives.axis_index(axis_name)
        gen = generators.setdefault(id(state), rank_generator(state, index))
        metrics = local_grads(model, optimizer, batch, labels, gen)
        mean_gradients(model, axis_name)
        optimizer.step(state.step)
        state.step += 1
        return state, _detached(metrics)

    return train_step


def make_spmd_eval_step(model, mesh, axis_name: str = "nodes") -> Callable:
    """(this rank's shard, labels) -> the metrics, replicated on every
    rank; no dropout and no gradients."""

    def eval_step(batch: GraphBatch, labels):
        collectives.use_mesh(mesh)
        model.eval()
        with torch.no_grad():
            task_output = model(batch, False)
            return model.compute_task_metrics(batch, task_output, labels)

    return eval_step


def make_spmd_forward(model, mesh, axis_name: str = "nodes") -> Callable:
    """(this rank's shard) -> the task output of every shard, stacked
    [S, ...] on every rank (an all_gather of each output), as JAX's
    shard_mapped forward returns it; no dropout and no gradients."""

    def stacked(x):
        return collectives.all_gather(x.unsqueeze(0).contiguous(), axis_name)

    def forward(batch: GraphBatch):
        collectives.use_mesh(mesh)
        model.eval()
        with torch.no_grad():
            out = model(batch, False)
            if isinstance(out, tuple):
                return tuple(stacked(x) for x in out)
            return stacked(out)

    return forward
