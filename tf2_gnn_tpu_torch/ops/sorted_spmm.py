"""Sorted-segment scatter over chunk-ordered edge streams, the scatter-plan
route (port of ``tf2_gnn_tpu/ops/spmm_pallas.py``).

Host half (the JAX package's layout byte for byte): the planner sorts
the edges by target and cuts them into chunks of ``CHUNK_EDGES``
slots whose targets share one block of ``BLOCK_NODES`` output rows;
``block_ids`` never decrease and trailing chunks repeat the last block.
``build_merged_plans`` plans all edge types at once, both ways: forward
slots by target over the [V] target rows, backward slots by merged source
``l * V + u`` over the [L*V] table rows, with the slot maps and the host
1/deg scales between them. ``plan_sorted_scatter`` cuts the chunks in the
port's C++ engine (``native/graphpack.cc``), as the JAX package does;
``plan_sorted_scatter_numpy``, vectorised numpy, is its plain version.
``build_dual_plans`` plans one edge type both ways (``EdgeScatterPlan``:
by target forward, by source backward).

Device half: four kernels, each a sorted segment reduction of a
chunk-ordered stream into ``out[block_ids[slot // 512] * R + rel[slot]]``
(``rel >= R`` marks a sentinel slot):

* ``sorted_segment_sum`` (B12), a sum; R is 128, or 128 * L for the
  type-minor transpose of ``plan_gather_tgt_typed``.
  ``sorted_segment_sum_gathered`` is the same kernel over a stream read
  through a row map: ``plan_gather_src``'s gradient, the cotangent's
  forward-slot rows summed by source, without writing the re-ordered
  stream;
* ``sorted_segment_sum_scaled`` (B13), the sum of ``msgs * scale``;
* ``sorted_segment_max`` (B15), a max (forward only; empty rows give 0);
* ``attention_scatter_sums`` (B14), the attention denominators and the
  expd-weighted sums of hk-major messages in one pass.

All four are hand-written CUDA. B12 launches the row-owner kernel of
``csrc/pair_stream.cu`` over the plan's compact form (``sorted_rows``, a
CSR of the valid slots by output row, which ``ScatterPlan.sum_rows``
builds at first read and keeps), and B14 and B15 its per-head and max
twins over the forward form; B13 is ``csrc/sorted_scatter.cu``'s.
Each wrapper runs its plain PyTorch version (``index_add_`` or
``scatter_reduce_``, accumulating in f32) on a CPU tensor and launches its
kernel on a CUDA tensor, or raises. The autograd ops
``typed_gather_scatter``, ``plan_gather_src``, ``plan_gather_tgt_typed``,
``plan_scatter``, ``attention_scatter`` and ``gather_scatter_sorted`` (one
edge type over its ``DualScatterPlan``, B12's gathered form both ways)
mirror the reference's custom VJPs; their other row gathers stay
``index_select``, as the reference's ``jnp.take`` calls sit outside its
kernels.
"""
import ctypes
import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..utils.constants import SMALL_NUMBER
from ..utils.device import as_tensor
from .pair_attention import _check
from .pair_edge_mlp import _device_type
from .pair_spmm import (
    _DTYPE_CODES,
    SlotRows,
    _launch_rows,
    _library,
    _require_compact,
    launch_head_rows,
    launch_max_rows,
)
from .segment import segment_logits_max, segment_sum

BLOCK_NODES = 128   # output rows per node block
CHUNK_EDGES = 512   # edge slots per chunk


# ---------------------------------------------------------------------------
# Host half: plans (numpy)


def plan_chunk_budget(edge_budget: int, num_nodes_padded: int) -> int:
    """Static number of chunks for ``edge_budget`` edges: the dense packing
    plus one partly filled chunk per node block, rounded up to 8."""
    dense = math.ceil(max(edge_budget, 1) / CHUNK_EDGES)
    boundaries = math.ceil(num_nodes_padded / BLOCK_NODES)
    return math.ceil((dense + boundaries) / 8) * 8


def plan_sorted_scatter(targets: np.ndarray, num_edges_real: int,
                        num_nodes_padded: int, num_chunks: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side scatter plan for one edge stream: (``perm``, ``rel_tgt``,
    ``block_ids``). ``perm`` int32 [num_chunks * CHUNK_EDGES] holds each
    slot's edge index (-1 on sentinels), ``rel_tgt`` the target relative to
    the chunk's node block (``BLOCK_NODES`` on sentinels), ``block_ids``
    int32 [num_chunks] the non-decreasing block of each chunk. Targets at
    index >= ``num_edges_real`` are ignored. A new chunk starts at every
    change of block and after every ``CHUNK_EDGES`` edges of one block.
    The C++ planner (``native.scatter_plan``) cuts the chunks;
    ``plan_sorted_scatter_numpy`` is its plain version."""
    if not native.binding_on():
        native.PLANNED["scatter numpy"] += 1
        return plan_sorted_scatter_numpy(targets, num_edges_real,
                                         num_nodes_padded, num_chunks)
    real = np.asarray(targets[:num_edges_real], dtype=np.int64)
    order = np.argsort(real, kind="stable")
    slots = num_chunks * CHUNK_EDGES
    perm = np.empty((slots,), dtype=np.int32)
    rel_tgt = np.empty((slots,), dtype=np.int32)
    block_ids = np.empty((num_chunks,), dtype=np.int32)
    used = native.scatter_plan(real[order].astype(np.int32),
                               order.astype(np.int32), num_chunks,
                               CHUNK_EDGES, BLOCK_NODES, perm, rel_tgt,
                               block_ids)
    if used < 0:
        raise ValueError(
            f"Scatter plan overflow: needs more than {num_chunks} chunks.")
    native.PLANNED["scatter binding"] += 1
    return perm, rel_tgt, block_ids


def plan_sorted_scatter_numpy(targets: np.ndarray, num_edges_real: int,
                              num_nodes_padded: int, num_chunks: int
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``plan_sorted_scatter``'s numpy form (vectorised), the plain version
    of the C++ planner."""
    real = np.asarray(targets[:num_edges_real], dtype=np.int64)
    order = np.argsort(real, kind="stable")
    sorted_tgt = real[order]
    n = sorted_tgt.shape[0]

    slots = num_chunks * CHUNK_EDGES
    perm = np.full((slots,), -1, dtype=np.int32)
    rel_tgt = np.full((slots,), BLOCK_NODES, dtype=np.int32)
    block_ids = np.zeros((num_chunks,), dtype=np.int32)
    if n == 0:
        return perm, rel_tgt, block_ids

    block = sorted_tgt // BLOCK_NODES
    run_start = np.concatenate(([True], block[1:] != block[:-1]))
    run_first = np.flatnonzero(run_start)
    pos_in_run = np.arange(n) - np.repeat(run_first,
                                          np.diff(np.append(run_first, n)))
    new_chunk = run_start | (pos_in_run % CHUNK_EDGES == 0)
    chunk = np.cumsum(new_chunk) - 1
    used = int(chunk[-1]) + 1
    if used > num_chunks:
        raise ValueError(
            f"Scatter plan overflow: needs more than {num_chunks} chunks.")
    slot = chunk * CHUNK_EDGES + pos_in_run % CHUNK_EDGES
    perm[slot] = order
    rel_tgt[slot] = sorted_tgt - block * BLOCK_NODES
    block_ids[chunk[new_chunk]] = block[new_chunk]
    # Keep block_ids non-decreasing through the unused tail.
    block_ids[used:] = block_ids[used - 1]
    return perm, rel_tgt, block_ids


def apply_plan_to_sources(sources: np.ndarray, perm: np.ndarray,
                          pad_source: int) -> np.ndarray:
    """Chunk-ordered source ids: sources[perm], sentinels -> pad_source."""
    out = np.full(perm.shape, pad_source, dtype=np.int32)
    valid = perm >= 0
    out[valid] = np.asarray(sources)[perm[valid]]
    return out


class EdgeScatterPlan(NamedTuple):
    """Host-built dual plan for one edge type's gather/scatter (reference
    spmm_pallas.py:130-152). Forward: edges chunked by TARGET
    (``src_by_tgt`` / ``rel_tgt`` / ``tgt_blocks``); backward: the same
    edges chunked by SOURCE (``tgt_by_src`` / ``rel_src`` /
    ``src_blocks``), so the gradient is a sorted sum too."""

    src_by_tgt: np.ndarray
    rel_tgt: np.ndarray
    tgt_blocks: np.ndarray
    tgt_by_src: np.ndarray
    rel_src: np.ndarray
    src_blocks: np.ndarray

    def astuple(self) -> Tuple[np.ndarray, ...]:
        return tuple(self)


def build_dual_plans(sources: np.ndarray, targets: np.ndarray,
                     num_edges_real: int, num_nodes_padded: int,
                     num_chunks: int) -> EdgeScatterPlan:
    """Forward (by-target) and backward (by-source) scatter plans of one
    edge type (reference spmm_pallas.py:155-175); sentinel slots point at
    the pad row."""
    pad = num_nodes_padded - 1
    perm_t, rel_tgt, tgt_blocks = plan_sorted_scatter(
        targets, num_edges_real, num_nodes_padded, num_chunks)
    src_by_tgt = apply_plan_to_sources(sources, perm_t, pad_source=pad)
    perm_s, rel_src, src_blocks = plan_sorted_scatter(
        sources, num_edges_real, num_nodes_padded, num_chunks)
    tgt_by_src = apply_plan_to_sources(targets, perm_s, pad_source=pad)
    return EdgeScatterPlan(src_by_tgt, rel_tgt, tgt_blocks, tgt_by_src,
                           rel_src, src_blocks)


PLAN_FIELDS = ("src_merged", "rel_tgt", "tgt_blocks", "type_fwd", "tgtabs_fwd",
               "tgtabs_by_src", "rel_src", "src_blocks", "type_bwd",
               "bwd_to_fwd_slot", "inv_fwd", "inv_bwd")


class MergedScatterPlan(NamedTuple):
    """Host plan over ALL edge types of a batch (the reference's
    ``MergedScatterPlan``, fields in ``PLAN_FIELDS`` order).

    Forward slots are sorted by target over the [V] target rows; sources
    are merged table rows ``l * src_space + u``. Backward slots are sorted
    by merged source over the [L * src_space] table rows, carrying the
    absolute target (``tgtabs_by_src``). ``bwd_to_fwd_slot`` maps each
    backward slot to the forward slot of the same edge (sentinels to the
    first sentinel forward slot); ``inv_fwd`` / ``inv_bwd`` are the
    per-slot 1/(per-type in-degree + eps) scales, 0 on sentinels."""

    src_merged: np.ndarray
    rel_tgt: np.ndarray
    tgt_blocks: np.ndarray
    type_fwd: np.ndarray
    tgtabs_fwd: np.ndarray
    tgtabs_by_src: np.ndarray
    rel_src: np.ndarray
    src_blocks: np.ndarray
    type_bwd: np.ndarray
    bwd_to_fwd_slot: np.ndarray
    inv_fwd: np.ndarray
    inv_bwd: np.ndarray

    def astuple(self) -> Tuple[np.ndarray, ...]:
        return tuple(self)


def build_merged_plans(sources_per_type, targets_per_type, counts_per_type,
                       num_nodes_padded: int,
                       src_space: int = None) -> MergedScatterPlan:
    """Merged dual plan over all edge types (see ``MergedScatterPlan``).
    ``src_space`` is one type's source row count (default: V)."""
    v = num_nodes_padded
    if src_space is None:
        src_space = v
    num_types = len(sources_per_type)
    srcs, tgts, types = [], [], []
    for l in range(num_types):
        c = int(counts_per_type[l])
        srcs.append(np.asarray(sources_per_type[l][:c], dtype=np.int64)
                    + l * src_space)
        tgts.append(np.asarray(targets_per_type[l][:c], dtype=np.int64))
        types.append(np.full((c,), l, dtype=np.int64))
    all_src = np.concatenate(srcs) if srcs else np.zeros((0,), np.int64)
    all_tgt = np.concatenate(tgts) if tgts else np.zeros((0,), np.int64)
    all_type = np.concatenate(types) if types else np.zeros((0,), np.int64)
    n = all_src.shape[0]
    total_budget = sum(int(np.asarray(sources_per_type[l]).shape[0])
                       for l in range(num_types))

    c_fwd = plan_chunk_budget(total_budget, v)
    perm_f, rel_tgt, tgt_blocks = plan_sorted_scatter(all_tgt, n, v, c_fwd)
    src_merged = apply_plan_to_sources(all_src, perm_f, pad_source=0)
    type_fwd = apply_plan_to_sources(all_type, perm_f, pad_source=0)
    tgtabs_fwd = apply_plan_to_sources(all_tgt, perm_f, pad_source=0)

    c_bwd = plan_chunk_budget(total_budget, num_types * src_space)
    perm_b, rel_src, src_blocks = plan_sorted_scatter(
        all_src, n, num_types * src_space, c_bwd)
    tgtabs_by_src = apply_plan_to_sources(all_tgt, perm_b, pad_source=0)
    type_bwd = apply_plan_to_sources(all_type, perm_b, pad_source=0)

    # Forward slot of each edge, re-ordered into backward slots.
    fwd_slot_of_edge = np.zeros((max(n, 1),), dtype=np.int64)
    valid_f = perm_f >= 0
    fwd_slot_of_edge[perm_f[valid_f]] = np.nonzero(valid_f)[0]
    sentinel_fwd = int(np.nonzero(~valid_f)[0][0]) if (~valid_f).any() else 0
    bwd_to_fwd_slot = np.full(perm_b.shape, sentinel_fwd, dtype=np.int32)
    valid_b = perm_b >= 0
    bwd_to_fwd_slot[valid_b] = fwd_slot_of_edge[perm_b[valid_b]]

    deg = np.zeros((num_types * v,), np.float32)
    if n:
        np.add.at(deg, (all_type * v + all_tgt).astype(np.int64), 1.0)
    inv = (1.0 / (deg + SMALL_NUMBER)).astype(np.float32)
    inv_fwd = (inv[np.minimum(type_fwd.astype(np.int64) * v + tgtabs_fwd,
                              inv.shape[0] - 1)] * valid_f).astype(np.float32)
    inv_bwd = (inv[np.minimum(type_bwd.astype(np.int64) * v + tgtabs_by_src,
                              inv.shape[0] - 1)] * valid_b).astype(np.float32)
    return MergedScatterPlan(src_merged, rel_tgt, tgt_blocks, type_fwd,
                             tgtabs_fwd, tgtabs_by_src, rel_src, src_blocks,
                             type_bwd, bwd_to_fwd_slot, inv_fwd, inv_bwd)


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """A ``MergedScatterPlan`` as the ops read it on a device (the
    counterpart of the reference's ``PlanView``): the twelve plan arrays,
    plus what the reference derives from them inside its ops, computed once
    per batch on the host (``from_host``) and moved with ``.to(device)``:

    * int64 row indices of every ``jnp.take(..., mode="clip")``, clipped
      into their tables: ``src_idx`` into the [L*V] merged source rows,
      ``tgtabs_idx`` and ``tgt_by_src_idx`` into the [V] target rows,
      ``bwd_to_fwd_idx`` into the forward slots, ``tgt_typed_idx`` into the
      type-minor [V*L] table of ``plan_gather_tgt_typed``;
    * the sentinel masks of both slot orders, and ``rel_typed``, the
      type-minor relative rows ``rel * L + type`` (sentinel 128 * L) of
      ``plan_gather_tgt_typed``'s gradient.

    B12's compact forms (``sum_rows``) are built on the device at their
    first read and kept (a moved plan starts without them).
    """

    src_merged: object
    rel_tgt: object
    tgt_blocks: object
    type_fwd: object
    tgtabs_fwd: object
    tgtabs_by_src: object
    rel_src: object
    src_blocks: object
    type_bwd: object
    bwd_to_fwd_slot: object
    inv_fwd: object
    inv_bwd: object
    src_idx: object
    tgtabs_idx: object
    tgt_by_src_idx: object
    bwd_to_fwd_idx: object
    tgt_typed_idx: object
    rel_typed: object
    fwd_sentinel: object
    bwd_sentinel: object
    num_nodes: int
    num_types: int
    _rows: Dict[object, SlotRows] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @classmethod
    def from_host(cls, arrays, num_nodes: int, num_types: int,
                  src_space: int = None) -> "ScatterPlan":
        """The device form of a host plan tuple (``PLAN_FIELDS`` order)
        over ``num_types`` edge types and ``num_nodes`` padded nodes, with
        ``src_space`` source rows a type (default: ``num_nodes``; under
        SPMD the ext or global rows the plan was built over)."""
        p = MergedScatterPlan(*(np.asarray(a) for a in arrays))
        v, nt = num_nodes, num_types
        src_space = v if src_space is None else src_space

        def clip(idx, rows):
            return np.clip(idx.astype(np.int64), 0, rows - 1)

        fwd_sentinel = p.rel_tgt >= BLOCK_NODES
        rel_typed = np.where(
            fwd_sentinel, BLOCK_NODES * nt,
            p.rel_tgt.astype(np.int64) * nt + p.type_fwd).astype(np.int32)
        return cls(
            *p, src_idx=clip(p.src_merged, nt * src_space),
            tgtabs_idx=clip(p.tgtabs_fwd, v),
            tgt_by_src_idx=clip(p.tgtabs_by_src, v),
            bwd_to_fwd_idx=clip(p.bwd_to_fwd_slot, p.rel_tgt.shape[0]),
            tgt_typed_idx=clip(p.tgtabs_fwd.astype(np.int64) * nt
                               + p.type_fwd, v * nt),
            rel_typed=rel_typed, fwd_sentinel=fwd_sentinel,
            bwd_sentinel=p.rel_src >= BLOCK_NODES, num_nodes=v,
            num_types=nt)

    def to(self, device) -> "ScatterPlan":
        """Every array as a tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: as_tensor(getattr(self, f.name), device)
            for f in dataclasses.fields(self) if f.type is object})

    def sum_rows(self, form: str, out_rows: int) -> SlotRows:
        """The compact form (``sorted_rows``) into ``out_rows`` rows, in
        one of its call forms: ``"fwd"``, the forward slots by target
        (B12 in ``plan_scatter``, B14 in ``attention_scatter``, B15 in the
        sorted RGAT's stabiliser);
        ``"fwd_typed"``, the forward slots by type-minor
        row ``rel * L + type`` (R = 128 * L, ``plan_gather_tgt_typed``'s
        gradient); ``"bwd"``, the backward slots by merged source, each
        reading its own stream row; ``"bwd_fused"``, the same rows, each
        entry reading the forward slot ``bwd_to_fwd_idx[slot]`` of the
        cotangent (``plan_gather_src``'s gradient)."""
        key = (form, out_rows)
        if key not in self._rows:
            fused = dict(stream_row=self.bwd_to_fwd_idx,
                         stream_rows=self.rel_tgt.numel())
            rel, blocks, block_rows, kwargs = {
                "fwd": (self.rel_tgt, self.tgt_blocks, BLOCK_NODES, {}),
                "fwd_typed": (self.rel_typed, self.tgt_blocks,
                              BLOCK_NODES * self.num_types, {}),
                "bwd": (self.rel_src, self.src_blocks, BLOCK_NODES, {}),
                "bwd_fused": (self.rel_src, self.src_blocks, BLOCK_NODES,
                              fused),
            }[form]
            self._rows[key] = sorted_rows(rel, blocks, out_rows, block_rows,
                                          **kwargs)
        return self._rows[key]


@dataclasses.dataclass(frozen=True)
class DualScatterPlan:
    """An ``EdgeScatterPlan`` on a device, as ``gather_scatter_sorted``
    reads it: the six plan arrays, the int64 row indices of both gathers
    clipped into the [num_nodes] rows, the sentinel masks, and B12's two
    compact forms (``fwd_rows``, ``bwd_rows``: each entry reads its row
    of the table, or of the cotangent, through the plan's gather), built
    at their first read and kept."""

    src_by_tgt: object
    rel_tgt: object
    tgt_blocks: object
    tgt_by_src: object
    rel_src: object
    src_blocks: object
    src_idx: object
    tgt_idx: object
    fwd_sentinel: object
    bwd_sentinel: object
    num_nodes: int
    _rows: Dict[object, SlotRows] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @classmethod
    def from_host(cls, plan: EdgeScatterPlan,
                  num_nodes: int) -> "DualScatterPlan":
        p = EdgeScatterPlan(*(np.asarray(a) for a in plan))
        return cls(*p,
                   src_idx=np.clip(p.src_by_tgt.astype(np.int64), 0,
                                   num_nodes - 1),
                   tgt_idx=np.clip(p.tgt_by_src.astype(np.int64), 0,
                                   num_nodes - 1),
                   fwd_sentinel=p.rel_tgt >= BLOCK_NODES,
                   bwd_sentinel=p.rel_src >= BLOCK_NODES,
                   num_nodes=num_nodes)

    def to(self, device) -> "DualScatterPlan":
        return dataclasses.replace(self, **{
            f.name: as_tensor(getattr(self, f.name), device)
            for f in dataclasses.fields(self) if f.type is object})

    @property
    def fwd_rows(self) -> SlotRows:
        if "fwd" not in self._rows:
            self._rows["fwd"] = sorted_rows(
                self.rel_tgt, self.tgt_blocks, self.num_nodes, BLOCK_NODES,
                stream_row=self.src_idx, stream_rows=self.num_nodes)
        return self._rows["fwd"]

    @property
    def bwd_rows(self) -> SlotRows:
        if "bwd" not in self._rows:
            self._rows["bwd"] = sorted_rows(
                self.rel_src, self.src_blocks, self.num_nodes, BLOCK_NODES,
                stream_row=self.tgt_idx, stream_rows=self.num_nodes)
        return self._rows["bwd"]


# ---------------------------------------------------------------------------
# The four sorted-scatter kernels (B12, B14 and B15 in csrc/pair_stream.cu,
# B13 in csrc/sorted_scatter.cu), their plain versions and wrappers.

# Launch counts of the CUDA kernels of this module: each wrapper adds one
# where it launches its kernel, and nowhere else.
LAUNCHES = {"sorted_segment_sum": 0, "sorted_segment_sum_scaled": 0,
            "sorted_segment_max": 0, "attention_scatter_sums": 0}

_SOURCE = "sorted_scatter.cu"


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _block_rows(num_nodes: int, block_rows: Optional[int]) -> int:
    r = BLOCK_NODES if block_rows is None else block_rows
    if num_nodes % r != 0:
        raise ValueError(f"num_nodes {num_nodes} not a multiple of {r}.")
    return r


def _segment_ids(rel, block_ids, num_nodes: int, block_rows: int):
    """Output row of every slot, ``block_ids[slot // CHUNK_EDGES] * R +
    rel``, with sentinel slots (``rel`` outside [0, R)) sent to the
    discard row ``num_nodes``."""
    rel = rel.reshape(-1).long()
    chunk = torch.arange(rel.shape[0], device=rel.device) // CHUNK_EDGES
    rows = block_ids.long()[chunk] * block_rows + rel
    valid = (rel >= 0) & (rel < block_rows) & (rows < num_nodes)
    return torch.where(valid, rows, torch.full_like(rows, num_nodes))


def sorted_rows(rel, block_ids, num_nodes: int, block_rows: int,
                stream_row=None, stream_rows: int = None) -> SlotRows:
    """The compact form of a sorted plan, as B12's kernel reads it: the
    valid slots (``rel`` in [0, R), output row ``block_ids[slot // 512] *
    R + rel`` below ``num_nodes``) as a CSR by output row, sorted stably,
    so each row's entries keep slot order whatever the order inside a
    chunk. Each entry's ``src_row`` is its stream row: the slot
    itself, or ``stream_row[slot]`` where a row map is given, into a
    stream of ``stream_rows`` rows (default: one per slot). Built with
    torch ops on the plan's device."""
    seg = _segment_ids(rel, block_ids, num_nodes, block_rows)
    kept = torch.nonzero(seg < num_nodes).reshape(-1)
    rows = seg[kept]
    slot = kept[torch.sort(rows, stable=True).indices]
    counts = torch.bincount(rows, minlength=num_nodes)
    row_ptr = torch.cat([counts.new_zeros((1,)), torch.cumsum(counts, 0)])
    if stream_row is None:
        src, stream_rows = slot, rel.numel()
    else:
        src = stream_row.reshape(-1).long()[slot]
    return SlotRows(row_ptr.to(torch.int32), src.to(torch.int32),
                    slot.to(torch.int32), stream_rows, num_nodes,
                    rel.numel())


def sorted_segment_sum_plain(msgs, rel, block_ids, num_nodes: int,
                             block_rows: int = None):
    """Plain PyTorch version of B12: f32 [num_nodes, H], the sum of the
    f32 rows of ``msgs`` per output row."""
    r = _block_rows(num_nodes, block_rows)
    return segment_sum(msgs.float(), _segment_ids(rel, block_ids, num_nodes,
                                                  r), num_nodes)


def stream_scale(msgs, scale):
    """B13's per-slot scale as the reference's kernel applies it: rounded
    to bf16 (and read as f32 from there on) for a bf16 stream, which
    ``_scaled_scatter_kernel`` does to ``onehot * scale`` before its
    product (spmm_pallas.py:360-363); as it is for an f32 stream."""
    if msgs.dtype == torch.bfloat16:
        return scale.to(torch.bfloat16).float()
    return scale


def sorted_segment_sum_scaled_plain(msgs, scale, rel, block_ids,
                                    num_nodes: int):
    """Plain PyTorch version of B13: the sum of ``msgs * scale`` (f32),
    with the scale of ``stream_scale`` (idempotent, so the wrapper's
    rounded scale passes unchanged)."""
    r = _block_rows(num_nodes, None)
    scale = stream_scale(msgs, scale)
    return segment_sum(msgs.float() * scale.reshape(-1, 1).float(),
                       _segment_ids(rel, block_ids, num_nodes, r), num_nodes)


def _gathered_stream(g, stream_row, sentinel):
    """The rows ``g[stream_row]``, zero where ``sentinel``."""
    g_b = g.index_select(0, stream_row)
    return g_b.masked_fill_(sentinel[:, None], 0.0)


def sorted_segment_sum_gathered_plain(g, stream_row, sentinel, rel,
                                      block_ids, num_nodes: int):
    """Plain PyTorch version of B12's gathered form: the stream
    ``g[stream_row]`` written out, its sentinel slots zeroed, then B12's
    plain sum over it (R = 128)."""
    return sorted_segment_sum_plain(_gathered_stream(g, stream_row, sentinel),
                                    rel, block_ids, num_nodes)


def sorted_segment_max_plain(vals, rel, block_ids, num_nodes: int):
    """Plain PyTorch version of B15: f32 [num_nodes, K], the max per output
    row from a -inf fill; rows left non-finite (no slot) become 0."""
    r = _block_rows(num_nodes, None)
    return segment_logits_max(vals.float(),
                              _segment_ids(rel, block_ids, num_nodes, r),
                              num_nodes)


def attention_scatter_sums_plain(expd, msgs, rel, block_ids, num_nodes: int):
    """Plain PyTorch version of B14: (denom f32 [num_nodes, K], weighted
    f32 [num_nodes, H]) with ``denom[v, k] = sum of expd[s, k]`` and
    ``weighted[v, c] = sum of msgs[s, c] * expd[s, c % K]`` (hk-major
    columns) over the slots of row v."""
    r = _block_rows(num_nodes, None)
    seg = _segment_ids(rel, block_ids, num_nodes, r)
    expd = expd.float()
    head_dim = msgs.shape[1] // expd.shape[1]
    return (segment_sum(expd, seg, num_nodes),
            segment_sum(msgs.float() * expd.repeat(1, head_dim), seg,
                        num_nodes))


def _launch_scaled(msgs, scale, rel, block_ids, num_nodes: int):
    """Launch B13 (``csrc/sorted_scatter.cu``) on the current stream into
    a fresh zero-filled f32 [num_nodes, H] output (R = 128). ``msgs``
    [slots, H] f32 or bf16 may be a row-strided view (its columns
    contiguous); ``scale`` is the f32 per-slot scale."""
    from .cuda_build import load_library

    lib = load_library(_SOURCE)
    entry = "sorted_segment_sum_scaled_launch"
    dev = msgs.device
    r = _block_rows(num_nodes, None)
    i32 = (torch.int32,)
    _check(entry, dev, rel=(rel, i32), block_ids=(block_ids, i32),
           scale=(scale, (torch.float32,)))
    if msgs.dtype not in _DTYPE_CODES:
        raise TypeError(f"{entry}: msgs must be f32 or bf16, got "
                        f"{msgs.dtype}")
    if msgs.dim() != 2 or msgs.stride(1) != 1 or msgs.stride(0) < msgs.shape[1]:
        raise ValueError(f"{entry}: msgs must be 2-D with contiguous rows")
    slots, h = msgs.shape
    num_chunks = block_ids.numel()
    if (num_chunks == 0 or rel.numel() != slots
            or num_chunks * CHUNK_EDGES != slots or h == 0):
        raise ValueError(f"{entry}: inconsistent plan shapes (msgs "
                         f"{tuple(msgs.shape)}, rel {rel.numel()}, "
                         f"{num_chunks} chunks)")
    if scale.numel() != slots:
        raise ValueError(f"{entry}: the scale must be a contiguous f32 "
                         f"[{slots}]")
    out = torch.zeros((num_nodes, h), dtype=torch.float32, device=dev)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [i, i, p, i64, i, p, p, p, i, i, p, i64, p]
    err = fn(dev.index or 0, _DTYPE_CODES[msgs.dtype], msgs.data_ptr(),
             msgs.stride(0), h, scale.data_ptr(),
             rel.data_ptr(), block_ids.data_ptr(), num_chunks, r,
             out.data_ptr(), num_nodes,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        lib.sorted_scatter_error_string.restype = ctypes.c_char_p
        lib.sorted_scatter_error_string.argtypes = [ctypes.c_int]
        msg = lib.sorted_scatter_error_string(err).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {err} ({msg})")
    return out


def sorted_segment_sum(msgs, rel, block_ids, num_nodes: int,
                       block_rows: int = None,
                       compact: Optional[SlotRows] = None):
    """B12: ``out[block_ids[slot // 512] * R + rel[slot]] += msgs[slot]``
    over the valid slots (``rel < R``), f32 [num_nodes, H]; R is
    ``block_rows`` (default 128) and must divide ``num_nodes``. ``msgs``
    [slots, H] f32 or bf16, possibly a row-strided view. On the card it
    reads only the plan's ``compact`` form (``sorted_rows``, from
    ``ScatterPlan.sum_rows``) and the stream's valid rows; on the CPU the
    plain version reads the plan arrays."""
    if _device_type("sorted_segment_sum", msgs) == "cpu":
        return sorted_segment_sum_plain(msgs, rel, block_ids, num_nodes,
                                        block_rows)
    _require_compact("sorted_segment_sum", compact)
    _block_rows(num_nodes, block_rows)
    out = _launch_rows("sorted_segment_sum_launch", msgs, None, compact,
                       num_nodes)
    LAUNCHES["sorted_segment_sum"] += 1
    return out


def sorted_segment_sum_gathered(g, stream_row, sentinel, rel, block_ids,
                                num_nodes: int,
                                compact: Optional[SlotRows] = None):
    """B12 over the stream ``where(sentinel, 0, g[stream_row])``, R = 128:
    ``plan_gather_src``'s gradient (``_pgs_bwd``, spmm_pallas.py:584-590),
    the cotangent ``g`` [forward slots, H] (f32 or bf16) re-ordered into
    backward slots and summed by merged source. On the card one launch of
    B12's kernel reads g's rows directly through the ``compact`` form
    (``ScatterPlan.sum_rows("bwd_fused", ...)``), whose entries carry
    ``stream_row[slot]``, so the re-ordered stream is never written; it
    counts as a launch of B12. On the CPU the unfused composite runs: the
    re-ordered stream, then B12's wrapper (its plain version there)."""
    if _device_type("sorted_segment_sum_gathered", g) == "cpu":
        return sorted_segment_sum(_gathered_stream(g, stream_row, sentinel),
                                  rel, block_ids, num_nodes)
    _require_compact("sorted_segment_sum_gathered", compact)
    _block_rows(num_nodes, None)
    out = _launch_rows("sorted_segment_sum_launch", g, None, compact,
                       num_nodes)
    LAUNCHES["sorted_segment_sum"] += 1
    return out


def sorted_segment_sum_scaled(msgs, scale, rel, block_ids, num_nodes: int):
    """B13: the sum of ``msgs[slot] * scale[slot]`` per output row (R =
    128), f32 [num_nodes, H]; ``msgs`` f32 or bf16, ``scale`` f32, one
    value per slot. With bf16 ``msgs`` the scale is rounded to bf16 once,
    here, before either route (``stream_scale``), so the kernel and the
    plain version see the same value."""
    device = _device_type("sorted_segment_sum_scaled", msgs)
    scale = stream_scale(msgs, scale)
    if device == "cpu":
        return sorted_segment_sum_scaled_plain(msgs, scale, rel, block_ids,
                                               num_nodes)
    out = _launch_scaled(msgs, scale, rel, block_ids, num_nodes)
    LAUNCHES["sorted_segment_sum_scaled"] += 1
    return out


def sorted_segment_max(vals, rel, block_ids, num_nodes: int,
                       compact: Optional[SlotRows] = None):
    """B15: the per-row, per-column max of the f32 ``vals`` [slots, K],
    f32 [num_nodes, K]; rows that no slot reaches and other non-finite
    maxes become 0. Forward only. ``vals`` may be a row-strided view. On
    the card it reads only the plan's ``compact`` form
    (``ScatterPlan.sum_rows("fwd", num_nodes)``: each entry's row is its
    slot) and the valid slots' values, through ``csrc/pair_stream.cu``'s
    max row owner; on the CPU the plain version reads the plan arrays."""
    if _device_type("sorted_segment_max", vals) == "cpu":
        return sorted_segment_max_plain(vals, rel, block_ids, num_nodes)
    _require_compact("sorted_segment_max", compact)
    _library()
    entry = "sorted_segment_max_launch"
    _block_rows(num_nodes, None)
    if vals.dtype != torch.float32 or vals.dim() != 2:
        raise TypeError(f"{entry}: needs 2-D f32 values, got {vals.dtype} "
                        f"{tuple(vals.shape)}")
    if compact.num_slots != vals.shape[0]:
        raise ValueError(f"{entry}: the compact form is over "
                         f"{compact.num_slots} slots, vals has "
                         f"{vals.shape[0]}")
    out = launch_max_rows(entry, vals, vals.shape[1], compact, num_nodes)
    LAUNCHES["sorted_segment_max"] += 1
    return out


def attention_scatter_sums(expd, msgs, rel, block_ids, num_nodes: int,
                           compact: Optional[SlotRows] = None):
    """B14: (denom f32 [num_nodes, K], weighted f32 [num_nodes, H]) in one
    pass (see ``attention_scatter_sums_plain``). ``expd`` f32 [slots, K]
    with K <= 32 dividing H, ``msgs`` f32 [slots, H] in hk-major layout,
    possibly a row-strided view. On the card it reads only the plan's
    ``compact`` form (``ScatterPlan.sum_rows("fwd", num_nodes)``: each
    entry's stream row is its slot), the valid slots' rows and their expd,
    through ``csrc/pair_stream.cu``'s per-head row owner; on the CPU the
    plain version reads the plan arrays."""
    if _device_type("attention_scatter_sums", expd) == "cpu":
        return attention_scatter_sums_plain(expd, msgs, rel, block_ids,
                                            num_nodes)
    _require_compact("attention_scatter_sums", compact)
    _library()
    entry = "attention_scatter_launch"
    _block_rows(num_nodes, None)
    if msgs.dtype != torch.float32 or expd.dim() != 2:
        raise TypeError(f"{entry}: needs f32 msgs and a 2-D expd, got "
                        f"{msgs.dtype} msgs and expd of {tuple(expd.shape)}")
    slots, k = expd.shape
    if msgs.shape[0] != slots or compact.num_slots != slots:
        raise ValueError(f"{entry}: expd has {slots} slots, msgs "
                         f"{msgs.shape[0]} and the compact form "
                         f"{compact.num_slots}")
    out = launch_head_rows(entry, msgs, expd, 1, k, k, compact, num_nodes)
    LAUNCHES["attention_scatter_sums"] += 1
    return out


# ---------------------------------------------------------------------------
# The differentiable ops, each the reference's custom VJP. Gradients leave
# each op in f32 where the reference's do: a bf16 stream is cast INSIDE the
# op, so PyTorch's engine does not round the f32 gradient of the f32 input
# to bf16.


class TypedGatherScatter(torch.autograd.Function):
    """``out[v] = sum over edges e=(u -> v, type l) of scale_e *
    tables[l*V + u]`` over all types in one pass (``typed_gather_scatter``,
    spmm_pallas.py:295-339): the forward gathers the merged source rows
    (``index_select``) and runs B13 with the forward scales; the backward
    gathers the cotangent by target in backward slot order and runs B13
    over the [L*V] table rows with the backward scales. Only the plan is
    kept for the backward, never the gathered stream."""

    @staticmethod
    def forward(ctx, tables_flat, plan: ScatterPlan, scale_fwd, scale_bwd,
                stream_dtype):
        tables = tables_flat.to(stream_dtype)
        msgs = tables.index_select(0, plan.src_idx)
        out = sorted_segment_sum_scaled(msgs, scale_fwd, plan.rel_tgt,
                                        plan.tgt_blocks, plan.num_nodes)
        ctx.plan, ctx.rows = plan, tables_flat.shape[0]
        ctx.save_for_backward(scale_bwd)
        return out

    @staticmethod
    def backward(ctx, g):
        (scale_bwd,) = ctx.saved_tensors
        plan = ctx.plan
        g_msgs = g.float().index_select(0, plan.tgt_by_src_idx)
        d_tables = sorted_segment_sum_scaled(g_msgs, scale_bwd, plan.rel_src,
                                             plan.src_blocks, ctx.rows)
        return d_tables, None, None, None, None


def typed_gather_scatter(tables_flat, plan: ScatterPlan, scale_fwd, scale_bwd,
                         stream_dtype: torch.dtype = None) -> torch.Tensor:
    """The joint [V, H] f32 sum over every edge type of the scaled rows of
    the stacked tables ``tables_flat`` [L*V, H], gathered in
    ``stream_dtype`` (default: the tables' dtype)."""
    return TypedGatherScatter.apply(tables_flat, plan, scale_fwd, scale_bwd,
                                    stream_dtype or tables_flat.dtype)


class GatherScatterSorted(torch.autograd.Function):
    """``out[v] = sum over edges (u -> v) of table[u]``, f32 [V, H]
    (reference ``gather_scatter_sorted``, spmm_pallas.py:512-568): B12
    over the forward plan, each entry reading its source row of the table
    (the gathered form: the per-slot stream is never written). The
    backward is the exact transpose, ``d_table[u] = sum over edges (u ->
    v) of g[v]``: B12 again over the backward plan (edges chunked by
    source), each entry reading its target's cotangent row. The table is
    cast to the stream dtype inside the op, so its gradient leaves in f32
    (the reference's custom VJP returns it unrounded)."""

    @staticmethod
    def forward(ctx, table, plan: DualScatterPlan, stream_dtype):
        ctx.plan = plan
        return sorted_segment_sum_gathered(
            table.to(stream_dtype).contiguous(), plan.src_idx,
            plan.fwd_sentinel, plan.rel_tgt, plan.tgt_blocks,
            plan.num_nodes, compact=plan.fwd_rows)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        return sorted_segment_sum_gathered(
            g.contiguous(), plan.tgt_idx, plan.bwd_sentinel, plan.rel_src,
            plan.src_blocks, plan.num_nodes,
            compact=plan.bwd_rows), None, None


def gather_scatter_sorted(table, plan: DualScatterPlan,
                          stream_dtype: torch.dtype = None) -> torch.Tensor:
    """The f32 [V, H] sum, per target, of the source rows of ``table``
    [V, H] over one edge type's dual plan, gathered in ``stream_dtype``
    (f32 or bf16; default: the table's dtype)."""
    return GatherScatterSorted.apply(table, plan, stream_dtype or table.dtype)


class PlanGatherSrc(torch.autograd.Function):
    """``msgs[slot] = tables[src_merged[slot]]`` in ``stream_dtype``
    (``plan_gather_src``, spmm_pallas.py:569-593). The backward sums the
    cotangent, re-ordered into backward (source-sorted) slots with the
    sentinels zeroed, by table row (B12's gathered form, one pass on the
    card): an f32 gradient, read from a stream in the cotangent's dtype
    (the caller's cast of the output to f32 rounds it to ``stream_dtype``
    on the way back, as the transpose of ``astype`` does in the
    reference)."""

    @staticmethod
    def forward(ctx, tables, plan: ScatterPlan, stream_dtype):
        ctx.plan, ctx.rows = plan, tables.shape[0]
        return tables.to(stream_dtype).index_select(0, plan.src_idx)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        d_tables = sorted_segment_sum_gathered(
            g, plan.bwd_to_fwd_idx, plan.bwd_sentinel, plan.rel_src,
            plan.src_blocks, ctx.rows,
            compact=plan.sum_rows("bwd_fused", ctx.rows))
        return d_tables, None, None


def plan_gather_src(tables, plan: ScatterPlan,
                    stream_dtype: torch.dtype = None) -> torch.Tensor:
    """The forward-slot rows of the merged table ``tables`` [L*V, F], in
    ``stream_dtype`` (default: the table's dtype)."""
    return PlanGatherSrc.apply(tables, plan, stream_dtype or tables.dtype)


class PlanGatherTgtTyped(torch.autograd.Function):
    """Per-slot rows of a TYPE-MINOR target table [V*L, F] (row
    ``tgt * L + type``; ``plan_gather_tgt_typed``, spmm_pallas.py:716-752)
    in ``stream_dtype``. A forward chunk's rows stay inside one expanded
    block of 128 * L rows, so the backward runs B12 over the forward plan
    itself with ``rel * L + type`` and ``block_rows = 128 * L``: an f32
    gradient, read from a stream in the cotangent's dtype."""

    @staticmethod
    def forward(ctx, table_tl, plan: ScatterPlan, stream_dtype):
        ctx.plan, ctx.rows = plan, table_tl.shape[0]
        return table_tl.to(stream_dtype).index_select(0, plan.tgt_typed_idx)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        g = g.masked_fill(plan.fwd_sentinel[:, None], 0.0).contiguous()
        d_table = sorted_segment_sum(g, plan.rel_typed, plan.tgt_blocks,
                                     ctx.rows,
                                     block_rows=BLOCK_NODES * plan.num_types,
                                     compact=plan.sum_rows("fwd_typed",
                                                           ctx.rows))
        return d_table, None, None


def plan_gather_tgt_typed(table_tl, plan: ScatterPlan,
                          stream_dtype: torch.dtype = None) -> torch.Tensor:
    """The forward-slot rows ``tgt * L + type`` of ``table_tl`` [V*L, F],
    in ``stream_dtype`` (default: the table's dtype)."""
    return PlanGatherTgtTyped.apply(table_tl, plan,
                                    stream_dtype or table_tl.dtype)


class PlanScatter(torch.autograd.Function):
    """``out[v] = sum over forward slots of v of weighted[slot]`` through
    B12 (``plan_scatter``, spmm_pallas.py:597-619), the stream cast to
    ``stream_dtype``; the gradient is a gather by absolute target, zero on
    sentinels, in the cotangent's f32 (the reference's transpose of the
    cast passes it unrounded)."""

    @staticmethod
    def forward(ctx, weighted, plan: ScatterPlan, stream_dtype):
        ctx.plan = plan
        return sorted_segment_sum(weighted.to(stream_dtype), plan.rel_tgt,
                                  plan.tgt_blocks, plan.num_nodes,
                                  compact=plan.sum_rows("fwd", plan.num_nodes))

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        d = g.index_select(0, plan.tgtabs_idx)
        return d.masked_fill_(plan.fwd_sentinel[:, None], 0.0), None, None


def plan_scatter(weighted, plan: ScatterPlan,
                 stream_dtype: torch.dtype = None) -> torch.Tensor:
    """The f32 [V, H] per-target sum of the forward-slot stream
    ``weighted`` [slots, H], streamed in ``stream_dtype`` (default: the
    stream's dtype)."""
    return PlanScatter.apply(weighted, plan, stream_dtype or weighted.dtype)


class AttentionScatter(torch.autograd.Function):
    """Fused attention aggregation (``attention_scatter``,
    spmm_pallas.py:755-873): B14 forward over the plan's forward compact
    form (shared with ``plan_scatter``'s B12 and B15); the backward is
    plain PyTorch, as the reference's ``_as_bwd`` is XLA:

        d_msgs[s, c] = expd[s, c % K] * d_weighted[tgt_s, c]
        d_expd[s, k] = sum over hd of msgs[s, hd*K + k] * d_weighted[tgt_s,
                       hd*K + k] + d_denom[tgt_s, k]

    both zero on sentinel slots."""

    @staticmethod
    def forward(ctx, expd, msgs, plan: ScatterPlan):
        denom, weighted = attention_scatter_sums(
            expd, msgs, plan.rel_tgt, plan.tgt_blocks, plan.num_nodes,
            compact=plan.sum_rows("fwd", plan.num_nodes))
        ctx.plan = plan
        ctx.save_for_backward(expd, msgs)
        return denom, weighted

    @staticmethod
    def backward(ctx, d_denom, d_weighted):
        expd, msgs = ctx.saved_tensors
        plan = ctx.plan
        slots, h = msgs.shape
        k = expd.shape[1]
        head_dim = h // k
        mask = plan.fwd_sentinel[:, None]
        if d_weighted is None:
            d_weighted = msgs.new_zeros((plan.num_nodes, h), dtype=torch.float32)
        if d_denom is None:
            d_denom = expd.new_zeros((plan.num_nodes, k))
        d_w_g = d_weighted.index_select(0, plan.tgtabs_idx).masked_fill_(
            mask, 0.0)
        d_d_g = d_denom.index_select(0, plan.tgtabs_idx).masked_fill_(mask,
                                                                      0.0)
        d_msgs = d_w_g * expd.repeat(1, head_dim)
        prod = (msgs.float() * d_w_g).reshape(slots, head_dim, k)
        d_expd = prod.sum(dim=1) + d_d_g
        return d_expd, d_msgs.to(msgs.dtype), None


def attention_scatter(expd, msgs, plan: ScatterPlan):
    """(denom f32 [V, K], weighted f32 [V, H]) of the per-slot ``expd``
    [slots, K] (zero on sentinels) and hk-major messages ``msgs``
    [slots, H]; per-slot attention weights are never materialised."""
    return AttentionScatter.apply(expd, msgs, plan)
