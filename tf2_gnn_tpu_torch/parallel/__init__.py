"""Scale-out layer over ``torch.distributed`` (port of
``tf2_gnn_tpu/parallel``): one process a rank, a ``DeviceMesh`` whose
dimension names are the JAX axis names.

* ``data_parallel`` — DP over whole graphs: each rank trains on its own
  padded batch; gradients and metrics combine weighted by graph count.
* ``spmd`` — node-partitioned execution of ONE giant graph across the
  ranks: each owns a contiguous node range plus the edges targeting it;
  per layer only the host-planned boundary rows are exchanged (one
  all_to_all, or one ppermute a ring distance) and aggregation stays
  local.
* ``hybrid`` — data-parallel replicas of node-partitioned graphs on a 2-D
  ("data", "nodes") mesh.
* ``reorder`` — the RCM locality pass that shrinks the partition's
  boundary.
* ``multiprocess`` — joining the processes into one group, the global
  mesh, each rank's slice of the host's stacked batches, and parameters
  replicated from rank 0.
* ``collectives`` — psum, pmax, all_gather, all_to_all and ppermute, with
  JAX's transposes as their gradients, and their call and byte counts.
* ``launch`` — ``run_ranks``: one spawned process a rank, with a timeout.
"""
from .data_parallel import (
    make_dp_eval_step,
    make_dp_train_step,
    make_mesh,
    shard_batches,
    stack_batches,
)
from .multiprocess import (
    distribute_batch,
    global_mesh,
    initialize_multiprocess,
    replicate_to_mesh,
)
from .hybrid import (
    make_hybrid_mesh,
    make_hybrid_train_step,
    stack_partitioned_batches,
)
from .reorder import (
    apply_node_permutation,
    invert_permutation,
    locality_reorder,
)
from .spmd import (
    make_spmd_eval_step,
    make_spmd_forward,
    make_spmd_train_step,
    partition_graph,
    restore_node_order,
)

__all__ = [
    "distribute_batch",
    "global_mesh",
    "initialize_multiprocess",
    "replicate_to_mesh",
    "make_dp_eval_step",
    "make_dp_train_step",
    "make_hybrid_mesh",
    "make_hybrid_train_step",
    "make_mesh",
    "make_spmd_eval_step",
    "make_spmd_forward",
    "make_spmd_train_step",
    "partition_graph",
    "restore_node_order",
    "apply_node_permutation",
    "invert_permutation",
    "locality_reorder",
    "shard_batches",
    "stack_partitioned_batches",
    "stack_batches",
]
