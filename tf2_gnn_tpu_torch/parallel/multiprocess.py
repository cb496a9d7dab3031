"""Multi-process execution over ``torch.distributed`` (port of
``tf2_gnn_tpu/parallel/multiprocess.py``).

A JAX mesh lives inside one process; here each rank is a process of its
own. Every process calls ``initialize_multiprocess`` with the same
address and world size and its own rank, then builds the same mesh
(``make_mesh``, ``global_mesh`` or ``make_hybrid_mesh``); each takes its
slice of the host's stacked arrays (``distribute_batch``: the shard at its
mesh coordinates, moved to its device) and starts from rank 0's
parameters (``replicate_to_mesh``). The parallel steps then run unchanged
on every rank.

The backend is the caller's choice: ``"nccl"`` between cards, ``"gloo"``
for CPU processes (the tests) and for several ranks on one card, which
NCCL refuses.
"""
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.graph_batch import GraphBatch
from ..utils.device import as_tensor, resolve_device
from . import collectives


def initialize_multiprocess(coordinator_address: str, num_processes: int,
                            process_id: int, backend: str = "nccl",
                            device=None) -> None:
    """Join this process into a ``torch.distributed`` group of
    ``num_processes`` ranks as rank ``process_id``.

    ``coordinator_address``: ``"host:port"`` (taken as ``tcp://``), or an
    init URL (``tcp://...``, ``file://...``). ``device`` (default: the
    card) is where this rank's tensors live."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda":
        # The rank's card is current before the group and any DeviceMesh
        # exist (the communicators bind to it).
        torch.cuda.set_device(dev if dev.index is not None
                              else torch.cuda.current_device())
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    collectives.set_process_device(dev)


def global_mesh(axis_name: str = "data",
                devices: Optional[Sequence[int]] = None):
    """1-D mesh over every rank of the group (all processes)."""
    from .data_parallel import make_mesh

    return make_mesh(devices, axis_name)


def process_shard_counts(mesh) -> Tuple[int, int]:
    """(shards on this process, shards on the mesh): one rank a process."""
    return 1, int(mesh.size())


def _take(x, index: Tuple[int, ...], device: torch.device):
    if isinstance(x, GraphBatch):
        return x.shard(index).to(device)
    if isinstance(x, dict):
        return {k: _take(v, index, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_take(v, index, device) for v in x)
    if isinstance(x, torch.Tensor):
        return x[index].to(device)
    return as_tensor(np.asarray(x)[index], device)


def distribute_batch(mesh, tree: Any, axis_name="data") -> Any:
    """This rank's shard of host-stacked trees (a ``GraphBatch``, label
    dicts, arrays, or tuples of them), on its device.

    Each leaf's leading axis (or axes: pass a TUPLE of axis names for 2-D
    meshes, e.g. ``("data", "nodes")`` for hybrid [R, S, ...] stacks) runs
    over the mesh's coordinates on those axes; the rank takes the entry at
    its own coordinates."""
    names = ((axis_name,) if isinstance(axis_name, str)
             else tuple(axis_name))
    index = tuple(mesh.get_local_rank(name) for name in names)
    return _take(tree, index, collectives.process_device())


def replicate_to_mesh(mesh, tree: Any) -> Any:
    """Overwrite, in place, every parameter and buffer of a module (or
    every tensor of a dict, list or tuple) with global rank 0's, so all
    ranks start equal; returns ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    elif isinstance(tree, torch.Tensor):
        tensors = [tree]
    else:
        tensors = list(tree)
    for t in tensors:
        collectives.broadcast_(t, 0)
    return tree
