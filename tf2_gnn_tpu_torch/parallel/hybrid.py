"""Hybrid 2-D parallelism: data-parallel replicas of node-partitioned
graphs (port of ``tf2_gnn_tpu/parallel/hybrid.py``).

Mesh ("data", "nodes"): each data-parallel replica owns one giant graph,
itself node-partitioned over the "nodes" axis (``parallel/spmd.py``). Per
step every (replica, shard) rank runs its own shard; graph and loss
reductions psum over "nodes" inside the model (``GraphBatch.spmd_axis``),
the replica's gradients are averaged over "nodes" (see spmd.py on the
transpose of psum), and the replicas' gradients are then combined
weighted by graph count over "data".
"""
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from ..data.graph_batch import GraphBatch
from . import collectives
from .data_parallel import (
    _combine_metrics,
    _detached,
    local_grads,
    mean_gradients,
    rank_generator,
    weight_gradients,
)


def make_hybrid_mesh(num_replicas: int, shards_per_replica: int,
                     devices: Sequence[int] = None):
    """2-D mesh ("data", "nodes") of ``num_replicas`` x
    ``shards_per_replica`` ranks in rank order (rank ``r * S + s`` is
    replica r's shard s); it becomes the current mesh."""
    import torch.distributed as dist

    needed = num_replicas * shards_per_replica
    world = dist.get_world_size()
    if world < needed:
        raise ValueError(
            f"Need {needed} devices for a {num_replicas}x{shards_per_replica} "
            f"mesh, have {world}."
        )
    return collectives.build_mesh((num_replicas, shards_per_replica),
                                  ("data", "nodes"), devices)


def stack_partitioned_batches(
    batches: Sequence[GraphBatch], labels: Sequence[Dict[str, np.ndarray]]
) -> Tuple[GraphBatch, Dict[str, np.ndarray]]:
    """Stack per-replica partitioned batches (each already carrying a
    leading "nodes"-shard axis from partition_graph) on a new leading
    "data" axis.

    Replicas must share their STATIC batch structure — halo wire form and
    slab sizes, plan shapes, reorder outcome. Per-replica graph content can
    make those diverge (e.g. ``reorder="auto"`` engaging on one replica
    only, or ring slabs sized by each replica's boundary); pin the
    partitioner's choices (``halo="dense"``/``"ring"``, ``reorder=False``)
    or pad to shared budgets when feeding a hybrid mesh.
    """
    def signature(b):
        static = tuple((name, getattr(b, name)) for name in (
            "num_graphs_padded", "pair_targets_merged", "spmd_axis",
            "spmd_num_shards", "halo_ext_nodes", "halo_ring_dists"))
        leaves = [(path, np.shape(x), np.asarray(x).dtype)
                  for path, x in b.array_fields()]
        return static, [path for path, _, _ in leaves], leaves

    ref_static, ref_paths, ref_leaves = signature(batches[0])
    for i, b in enumerate(batches[1:], start=1):
        static, paths, leaves = signature(b)
        mismatch = None
        if static != ref_static or paths != ref_paths:
            mismatch = "tree structure (halo form / plan presence)"
        else:
            for (path, shape, dtype), (_, rshape, rdtype) in zip(
                    leaves, ref_leaves):
                if shape != rshape or dtype != rdtype:
                    mismatch = (f"leaf {path}: {shape}/{dtype} vs replica "
                                f"0's {rshape}/{rdtype}")
                    break
        if mismatch is not None:
            raise ValueError(
                "stack_partitioned_batches: replica 0 and replica "
                f"{i} have different STATIC batch structure — {mismatch}. "
                "Partition every replica with pinned choices — e.g. "
                'halo="dense" or halo="ring", reorder=False — so the '
                "stacked [replica, shard, ...] arrays are uniform."
            )
    stacked_labels = {k: np.stack([np.asarray(l[k]) for l in labels])
                      for k in labels[0]}
    return GraphBatch.stack(batches), stacked_labels


def make_hybrid_train_step(model, optimizer, mesh) -> Callable:
    """(TrainState, this rank's shard of its replica's graph, labels) ->
    (TrainState, metrics); every rank runs it in its own process."""
    generators: Dict[int, torch.Generator] = {}

    def train_step(state, batch: GraphBatch, labels):
        collectives.use_mesh(mesh)
        replica = collectives.axis_index("data")
        shard = collectives.axis_index("nodes")
        index = replica * collectives.axis_size("nodes") + shard
        gen = generators.setdefault(id(state), rank_generator(state, index))
        metrics = local_grads(model, optimizer, batch, labels, gen)
        # Complete the replica's partial gradients over its node shards,
        # then combine the replicas weighted by graph count.
        mean_gradients(model, "nodes")
        local_graphs = float(batch.num_graphs)
        weight_gradients(model, "data", local_graphs)
        optimizer.step(state.step)
        state.step += 1
        return state, _combine_metrics(_detached(metrics), "data",
                                       local_graphs)

    return train_step
