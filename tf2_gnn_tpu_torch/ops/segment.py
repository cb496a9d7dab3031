"""Segment (scatter-reduce) primitives over a static segment count (port of
``tf2_gnn_tpu/ops/segment.py``): the readouts' and the global exchange's
sums and softmaxes, and the unfused per-edge path's aggregations
(``get_aggregation_function``: sum, mean, max, sqrt_n) and RGAT's
``segment_log_softmax``.

Segment ids outside ``[0, num_segments)`` are dropped, as in
``jax.ops.segment_sum``. Where the rows of ``data`` are one shard of a
node-partitioned graph and the segments are global (per-graph readouts,
JAX segment.py:25-129), ``spmd_axis`` names the mesh axis: the partial
sums and counts are psum-ed over it (a gradient flows back through the
psum), and the softmaxes' stabilising max is pmax-ed, without a gradient.

A sum runs one of two ways. Given a ``SegmentOrder`` (``order=``), the
segment ids sorted once on their device into a CSR of ones, it is that
CSR's product with the rows (``torch.sparse.mm``, a library call, no
hand-written kernel), which reads each row once; its gradient is the row
gather of the cotangent at each entry's segment. A batch builds the
orders of its edge arrays once and keeps them
(``GraphBatch.aggregation_order``, and the gathers' backward in
``gather_source_rows`` / ``gather_target_rows``), so the unfused per-edge
path's sums over edges take this way. Without an order the sum is
``index_add_``, float atomics on the card, as the node-to-graph sums of
the readouts, the graph-level losses and the global exchange keep. The
counters ``segment.sum.ordered`` and ``segment.sum.scatter``
(``utils/tracing.py``) count the sums each way takes,
``segment.order.build`` the orders built.
"""
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils import tracing
from ..utils.constants import SMALL_NUMBER


def _valid_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Ids with the out-of-range ones sent to the discard row
    ``num_segments``."""
    ids = segment_ids.long()
    return torch.where((ids >= 0) & (ids < num_segments), ids,
                       torch.full_like(ids, num_segments))


@dataclasses.dataclass(frozen=True, eq=False)
class SegmentOrder:
    """Segment ids sorted once on their device, as the CSR that sums by
    them.

    * ``ids``: [M], each entry's segment, the out-of-range ones at the
      discard row ``num_segments``;
    * ``matrix``: the [num_segments + 1, M] CSR of ones, row ``s`` holding
      segment ``s``'s entries in their order, the discard row last.

    Indices are int32 (a sum's rows, M × C × 4 bytes, leave M far below
    2**31): 12 bytes an entry, its id, its column in the CSR and the
    CSR's one. ``build`` sorts on the ids' device and never waits for it.
    """

    num_segments: int
    ids: torch.Tensor
    matrix: torch.Tensor

    @classmethod
    def build(cls, segment_ids: torch.Tensor,
              num_segments: int) -> "SegmentOrder":
        entries = segment_ids.shape[0]
        ids = _valid_ids(segment_ids, num_segments).to(torch.int32)
        ordered, perm = torch.sort(ids, stable=True)
        rows = torch.searchsorted(
            ordered, torch.arange(num_segments + 2, dtype=torch.int32,
                                  device=ids.device), out_int32=True)
        matrix = torch.sparse_csr_tensor(
            rows, perm.to(torch.int32), torch.ones(entries, device=ids.device),
            size=(num_segments + 1, entries), check_invariants=False)
        tracing.count("segment.order.build")
        return cls(num_segments, ids, matrix)

    @property
    def num_entries(self) -> int:
        return int(self.ids.shape[0])

    def counts(self, dtype=torch.float32) -> torch.Tensor:
        """[num_segments]: the entries of each segment."""
        return self.matrix.crow_indices().diff()[:self.num_segments].to(
            dtype)

    def sum_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """[num_segments, C]: each segment's sum of the [M, C] ``rows``, the
        CSR's product with them (``torch.sparse.mm``; cuSPARSE on the
        card, whose additions are in no fixed order). f32 or f64 rows sum
        in their own precision, narrower ones in f32, rounded once."""
        wide = rows if rows.dtype in (torch.float32, torch.float64) else (
            rows.float())
        matrix = self.matrix if wide.dtype == torch.float32 else (
            self.matrix.to(wide.dtype))
        return torch.sparse.mm(matrix, wide)[:self.num_segments].to(
            rows.dtype)

    def spread(self, g: torch.Tensor) -> torch.Tensor:
        """[M, C]: each entry's row of the [num_segments, C] ``g``, 0 at the
        discarded entries (the gradient of ``sum_rows``)."""
        return F.pad(g, (0, 0, 0, 1)).index_select(0, self.ids)


class _OrderedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, order):
        ctx.order, ctx.shape = order, data.shape
        tracing.count("segment.sum.ordered")
        width = math.prod(data.shape[1:])
        sums = order.sum_rows(data.reshape(data.shape[0], width))
        return sums.reshape((order.num_segments,) + tuple(data.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        rows = ctx.order.spread(g.reshape(g.shape[0], math.prod(g.shape[1:])))
        return rows.reshape(ctx.shape), None


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                spmd_axis: Optional[str] = None,
                order: Optional[SegmentOrder] = None) -> torch.Tensor:
    """Sum of ``data`` rows per segment; empty segments yield 0. With
    ``spmd_axis``, the sum over every shard of the axis. With ``order``
    (built from ``segment_ids``), the product of its CSR with the rows."""
    if order is not None:
        if (order.num_segments != num_segments
                or order.num_entries != data.shape[0]):
            raise ValueError(
                f"an order over {order.num_entries} entries and "
                f"{order.num_segments} segments cannot sum {data.shape[0]} "
                f"rows into {num_segments} segments")
        out = _OrderedSum.apply(data, order)
    else:
        tracing.count("segment.sum.scatter")
        out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
        out.index_add_(0, _valid_ids(segment_ids, num_segments), data)
        out = out[:num_segments]
    if spmd_axis is not None:
        from ..parallel.collectives import psum

        out = psum(out, spmd_axis)
    return out


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  dtype=torch.float32,
                  spmd_axis: Optional[str] = None,
                  order: Optional[SegmentOrder] = None) -> torch.Tensor:
    """Number of entries per segment (in-degree when ids are edge
    targets); with ``order``, read from its offsets."""
    if order is not None:
        counts = order.counts(dtype)
        if spmd_axis is not None:
            from ..parallel.collectives import psum

            counts = psum(counts, spmd_axis)
        return counts
    return segment_sum(torch.ones(segment_ids.shape, dtype=dtype,
                                  device=segment_ids.device),
                       segment_ids, num_segments, spmd_axis)


def _counts_like(segment_ids: torch.Tensor, num_segments: int,
                 values: torch.Tensor,
                 spmd_axis: Optional[str] = None,
                 order: Optional[SegmentOrder] = None) -> torch.Tensor:
    """``segment_count`` in ``values``' dtype, shaped to broadcast over its
    trailing axes."""
    counts = segment_count(segment_ids, num_segments, values.dtype,
                           spmd_axis, order)
    return counts.reshape(counts.shape + (1,) * (values.dim() - 1))


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 spmd_axis: Optional[str] = None,
                 order: Optional[SegmentOrder] = None) -> torch.Tensor:
    """Mean per segment; empty segments yield 0 (tf.unsorted_segment_mean)."""
    totals = segment_sum(data, segment_ids, num_segments, spmd_axis, order)
    counts = _counts_like(segment_ids, num_segments, totals, spmd_axis,
                          order)
    return totals / torch.clamp(counts, min=1.0)


def segment_sqrt_n(data: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int,
                   order: Optional[SegmentOrder] = None) -> torch.Tensor:
    """Sum per segment over the root of its size
    (tf.unsorted_segment_sqrt_n); empty segments yield 0."""
    totals = segment_sum(data, segment_ids, num_segments, order=order)
    counts = _counts_like(segment_ids, num_segments, totals, order=order)
    return totals / torch.sqrt(torch.clamp(counts, min=1.0))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, empty_value: float = 0.0,
                order: Optional[SegmentOrder] = None) -> torch.Tensor:
    """Max per segment, ``empty_value`` where a segment is empty (where
    tf.unsorted_segment_max gives the dtype's lowest value). Ties share
    the gradient evenly, as under ``jax.ops.segment_max``. ``order``
    gives the counts only; the max is ``scatter_reduce``'s."""
    ids = _valid_ids(segment_ids, num_segments)
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    maxes = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    maxes = maxes.scatter_reduce(0, index, data, reduce="amax",
                                 include_self=False)[:num_segments]
    counts = _counts_like(segment_ids, num_segments, maxes, order=order)
    return torch.where(counts > 0, maxes,
                       torch.full_like(maxes, empty_value))


def segment_logits_max(logits: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int,
                       spmd_axis: Optional[str] = None) -> torch.Tensor:
    """Per-segment max of ``logits``, detached (a stability shift, whose
    true gradient contribution to a softmax is zero), with empty segments
    pinned to 0 so ``logits - max[ids]`` stays finite; with ``spmd_axis``
    the max over every shard, taken before the pin."""
    ids = _valid_ids(segment_ids, num_segments)
    index = ids.reshape((-1,) + (1,) * (logits.dim() - 1)).expand_as(logits)
    maxes = torch.full((num_segments + 1,) + tuple(logits.shape[1:]),
                       float("-inf"), dtype=logits.dtype,
                       device=logits.device)
    maxes = maxes.scatter_reduce(0, index, logits.detach(), reduce="amax",
                                 include_self=True)[:num_segments]
    if spmd_axis is not None:
        from ..parallel.collectives import pmax

        maxes = pmax(maxes, spmd_axis)
    return torch.where(torch.isfinite(maxes), maxes, torch.zeros_like(maxes))


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    spmd_axis: Optional[str] = None) -> torch.Tensor:
    """Numerically stable softmax within each segment, with dpu-utils'
    ``unsorted_segment_softmax`` semantics: ``exp(x - max) / (sum + eps)``.
    ``logits`` may be [M] or [M, K] (one softmax per trailing column)."""
    maxes = segment_logits_max(logits, segment_ids, num_segments, spmd_axis)
    ids = segment_ids.long()
    # index_select, not ``denom[ids]``: its gradient is an index_add_, where
    # advanced indexing's backward sorts the ids first (0.4 ms a step at
    # V = 8064 on an H100, chip_smoke.py --profile).
    exp_shifted = torch.exp(logits - maxes.index_select(0, ids))
    denom = segment_sum(exp_shifted, segment_ids, num_segments,
                        spmd_axis) + SMALL_NUMBER
    return exp_shifted / denom.index_select(0, ids)


def segment_log_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int,
                        spmd_axis: Optional[str] = None) -> torch.Tensor:
    """Log-softmax within each segment, with dpu-utils'
    ``unsorted_segment_log_softmax`` semantics: ``x - max - log(max(sum,
    eps))``, the epsilon under the log (``segment_softmax`` adds it to the
    denominator instead). ``logits`` may be [M] or [M, K]; the ids index
    the per-segment rows back, so they must lie in ``[0, num_segments)``."""
    maxes = segment_logits_max(logits, segment_ids, num_segments, spmd_axis)
    ids = segment_ids.long()
    shifted = logits - maxes.index_select(0, ids)
    sum_exp = segment_sum(torch.exp(shifted), segment_ids, num_segments,
                          spmd_axis)
    log_norm = torch.log(torch.clamp(sum_exp, min=SMALL_NUMBER))
    return shifted - log_norm.index_select(0, ids)


_AGGREGATORS = {
    "sum": segment_sum,
    "mean": segment_mean,
    "max": segment_max,
    "sqrt_n": segment_sqrt_n,
}


def get_aggregation_function(name: str):
    """Name -> segment aggregation function (reference
    utils/param_helpers.py:7-18)."""
    fn = _AGGREGATORS.get(name)
    if fn is None:
        raise ValueError(f"Unknown aggregation function: {name}")
    return fn


def get_known_aggregation_names():
    return sorted(_AGGREGATORS.keys())


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, params, indices, order):
        ctx.num_rows, ctx.order = params.shape[0], order
        ctx.save_for_backward(indices)
        return params[torch.clamp(indices.long(), 0, params.shape[0] - 1)]

    @staticmethod
    def backward(ctx, g):
        (indices,) = ctx.saved_tensors
        # Summed in f32 and rounded once, on the CPU and the card alike (a
        # bf16 index_add_ on the card rounds at every atomic add).
        return segment_sum(g.float(), indices, ctx.num_rows,
                           order=ctx.order).to(g.dtype), None, None


def gather_rows(params: torch.Tensor, indices: torch.Tensor,
                order: Optional[SegmentOrder] = None) -> torch.Tensor:
    """Row gather whose out-of-range indices CLAMP (``jnp.take`` with
    ``mode="clip"``), with a scatter-add gradient that drops them (their
    rows are discarded downstream, so their cotangents are 0) and sums in
    f32 (the reference's XLA scatter-add of a bf16 cotangent rounds to
    bf16 at every add): over ``order`` (``indices`` ordered over
    ``params``' rows) where given, else by ``index_add_``."""
    return _GatherRows.apply(params, indices, order)
