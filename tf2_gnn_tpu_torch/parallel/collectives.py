"""The collectives of the scale-out layer, over plain ``torch.distributed``.

A mesh axis is named as in the JAX package (``"data"``, ``"nodes"``); the
process group of each name comes from the current mesh (``use_mesh``: a
``torch.distributed.device_mesh.DeviceMesh`` whose dimension names are
the axis names), which the parallel steps set. One process runs one rank.

The collectives that carry a gradient are ``torch.autograd.Function``\\ s
with JAX's transposes written out:

* ``psum`` (``all_reduce`` SUM), whose transpose is ``psum`` again: a
  replicated loss reduced over S shards sends each shard a cotangent S
  times too large, which the SPMD step's ``pmean`` of the gradients
  removes, as in the JAX package (spmd.py:550-556);
* ``all_gather`` along axis 0, tiled, whose transpose is a reduce-scatter,
  done here as an ``all_to_all`` and a sum (gloo has no reduce-scatter);
* ``all_to_all`` of ``[S, m, ...]`` (block ``j`` to rank ``j``), its own
  transpose;
* ``ppermute`` by a ring distance ``k`` (rank ``i`` sends to ``(i + k) %
  S``), an ``all_to_all_single`` whose split sizes are nonzero only for
  the partner; its transpose is the inverse permutation ``(i + k) -> i``.

``pmax`` (``all_reduce`` MAX) takes values that carry no gradient, as
``jax.lax.pmax`` does. ``psum_flat`` reduces a list of plain tensors in one
call through one flat buffer (the steps' gradients and metrics).

Every call adds one to ``COUNTS[name]["calls"]`` and the bytes this rank
sends to ``COUNTS[name]["bytes"]``; ``reset_counts`` sets them to 0. A
CUDA tensor given to a gloo group is copied to the host, reduced or
exchanged there and copied back (``HOST_STAGED`` names the collectives
that did so), since gloo's CUDA support differs between collectives and
builds; an NCCL group takes CUDA tensors as they are.
"""
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

COLLECTIVES = ("psum", "pmax", "all_gather", "all_to_all", "ppermute",
               "broadcast")
COUNTS: Dict[str, Dict[str, int]] = {
    name: {"calls": 0, "bytes": 0} for name in COLLECTIVES}
# The collectives that staged a CUDA tensor through the host (gloo).
HOST_STAGED = set()

_MESH = None
_DEVICE: Optional[torch.device] = None


def set_process_device(device: Optional[torch.device]) -> None:
    """The device this rank's tensors live on (``initialize_multiprocess``
    sets it)."""
    global _DEVICE
    _DEVICE = device


def process_device() -> torch.device:
    """This rank's device: the one ``initialize_multiprocess`` was given,
    else the card."""
    if _DEVICE is None:
        from ..utils.device import resolve_device

        return resolve_device("cuda")
    return _DEVICE


def build_mesh(shape: Sequence[int], names: Sequence[str],
               devices: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` of ``shape`` over every rank in rank order (the
    ranks ``devices`` names, which must be all of them), with dimension
    names ``names``; it becomes the current mesh. Every rank builds it,
    in the same order as its other meshes (a 2-D mesh makes a group a
    dimension)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    size = 1
    for n in shape:
        size *= n
    if size != world or (devices is not None
                         and list(devices) != list(range(world))):
        raise ValueError(
            f"a mesh of shape {tuple(shape)} needs every rank of the "
            f"{world}-rank group, in rank order (one process a rank)")
    mesh = init_device_mesh(process_device().type, tuple(shape),
                            mesh_dim_names=tuple(names))
    use_mesh(mesh)
    return mesh


def reset_counts() -> None:
    for counts in COUNTS.values():
        counts["calls"] = 0
        counts["bytes"] = 0


def counts_snapshot() -> Dict[str, Dict[str, int]]:
    return {name: dict(c) for name, c in COUNTS.items()}


def use_mesh(mesh) -> None:
    """Make ``mesh`` the mesh whose dimension names the collectives take."""
    global _MESH
    _MESH = mesh


def current_mesh():
    if _MESH is None:
        raise RuntimeError("no mesh: build one with make_mesh, global_mesh "
                           "or make_hybrid_mesh first")
    return _MESH


def axis_group(axis: str):
    """The process group of mesh axis ``axis``."""
    return current_mesh().get_group(axis)


def axis_size(axis: str) -> int:
    return current_mesh().size(current_mesh().mesh_dim_names.index(axis))


def axis_index(axis: str) -> int:
    """This rank's coordinate on mesh axis ``axis``."""
    return current_mesh().get_local_rank(axis)


def _count(name: str, tensor: torch.Tensor) -> None:
    COUNTS[name]["calls"] += 1
    COUNTS[name]["bytes"] += tensor.numel() * tensor.element_size()


def _wire(name: str, group, tensor: torch.Tensor, fresh: bool = False):
    """(the tensor the collective takes, a function that brings a result
    back to ``tensor``'s device). A CUDA tensor on a gloo group goes
    through the host (a copy); ``fresh`` asks for a copy in any case, for
    a collective that writes its input in place."""
    if tensor.is_cuda and dist.get_backend(group) == "gloo":
        HOST_STAGED.add(name)
        return tensor.cpu(), lambda out: out.to(tensor.device)
    return (tensor.clone() if fresh else tensor), lambda out: out


def _all_reduce(name: str, x: torch.Tensor, op, axis: str) -> torch.Tensor:
    group = axis_group(axis)
    _count(name, x)
    out, back = _wire(name, group, x.detach().contiguous(), fresh=True)
    dist.all_reduce(out, op=op, group=group)
    return back(out)


def _all_to_all(name: str, x: torch.Tensor, axis: str,
                out_splits: Optional[List[int]] = None,
                in_splits: Optional[List[int]] = None,
                out_rows: Optional[int] = None) -> torch.Tensor:
    """``all_to_all_single`` over dimension 0 of ``x``, even splits by
    default."""
    group = axis_group(axis)
    x = x.detach().contiguous()
    rows = x.shape[0] if out_rows is None else out_rows
    src, back = _wire(name, group, x)
    out = src.new_empty((rows,) + tuple(x.shape[1:]))
    _count(name, x if in_splits is None else x[:sum(in_splits)])
    dist.all_to_all_single(out, src, out_splits, in_splits, group=group)
    return back(out)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce("psum", x, dist.ReduceOp.SUM, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce("psum", g, dist.ReduceOp.SUM, ctx.axis), None


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of ``x`` over mesh axis ``axis`` on every rank; its
    gradient is the psum of the cotangent."""
    return _PSum.apply(x, axis)


def pmax(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axis``, without a gradient."""
    return _all_reduce("pmax", x, dist.ReduceOp.MAX, axis)


def psum_flat(tensors: Sequence[torch.Tensor], axis: str
              ) -> List[torch.Tensor]:
    """Each of ``tensors`` (no gradient, one dtype) summed over ``axis``,
    in one call through one flat buffer."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    summed = _all_reduce("psum", flat, dist.ReduceOp.SUM, axis)
    out, start = [], 0
    for t in tensors:
        out.append(summed[start:start + t.numel()].reshape(t.shape))
        start += t.numel()
    return out


def _reduce_scatter(name: str, g: torch.Tensor, axis: str) -> torch.Tensor:
    """Rank i's rows of the sum over ranks of ``g`` [S * n, ...]: each rank
    sends its block j to rank j, then sums the S blocks it receives."""
    s = axis_size(axis)
    got = _all_to_all(name, g, axis)
    return got.reshape((s, g.shape[0] // s) + tuple(g.shape[1:])).sum(0)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        group = axis_group(axis)
        x = x.detach().contiguous()
        _count("all_gather", x)
        src, back = _wire("all_gather", group, x)
        parts = [torch.empty_like(src) for _ in range(axis_size(axis))]
        dist.all_gather(parts, src, group=group)
        return back(torch.cat(parts, dim=0))

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter("all_gather", g, ctx.axis), None


def all_gather(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Every rank's ``x`` [n, ...] along axis 0 in rank order (tiled):
    [S * n, ...]; the gradient is the reduce-scatter of the cotangent."""
    return _AllGather.apply(x, axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_to_all("all_to_all", x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all("all_to_all", g, ctx.axis), None


def all_to_all(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x`` [S, m, ...] (or [S * m, ...]): block ``j`` goes to rank ``j``,
    and block ``j`` of the result came from rank ``j`` (JAX's
    ``all_to_all(x, axis, 0, 0, tiled=False)``)."""
    return _AllToAll.apply(x, axis)


def _shift(name: str, x: torch.Tensor, axis: str, k: int) -> torch.Tensor:
    """Rank i sends ``x`` to rank (i + k) % S and returns what rank
    (i - k) % S sent."""
    s = axis_size(axis)
    i = axis_index(axis)
    rows = x.shape[0]
    in_splits = [0] * s
    out_splits = [0] * s
    in_splits[(i + k) % s] = rows
    out_splits[(i - k) % s] = rows
    return _all_to_all(name, x, axis, out_splits, in_splits, rows)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, k):
        ctx.axis, ctx.k = axis, k
        return _shift("ppermute", x, axis, k)

    @staticmethod
    def backward(ctx, g):
        return _shift("ppermute", g, ctx.axis, -ctx.k), None, None


def ppermute(x: torch.Tensor, axis: str, k: int) -> torch.Tensor:
    """The ring shift by distance ``k``: JAX's ``ppermute`` with ``perm =
    [(i, (i + k) % S)]``."""
    return _PPermute.apply(x, axis, k)


def broadcast_(tensor: torch.Tensor, src: int = 0) -> None:
    """Overwrite ``tensor`` in place with global rank ``src``'s."""
    _count("broadcast", tensor)
    with torch.no_grad():
        wire, _ = _wire("broadcast", None, tensor.detach())
        dist.broadcast(wire, src)
        if wire.device != tensor.device:
            tensor.copy_(wire)
