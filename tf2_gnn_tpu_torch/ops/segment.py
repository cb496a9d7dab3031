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
"""
from typing import Optional

import torch

from ..utils.constants import SMALL_NUMBER


def _valid_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Ids with the out-of-range ones sent to the discard row
    ``num_segments``."""
    ids = segment_ids.long()
    return torch.where((ids >= 0) & (ids < num_segments), ids,
                       torch.full_like(ids, num_segments))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                spmd_axis: Optional[str] = None) -> torch.Tensor:
    """Sum of ``data`` rows per segment; empty segments yield 0. With
    ``spmd_axis``, the sum over every shard of the axis."""
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, _valid_ids(segment_ids, num_segments), data)
    out = out[:num_segments]
    if spmd_axis is not None:
        from ..parallel.collectives import psum

        out = psum(out, spmd_axis)
    return out


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  dtype=torch.float32,
                  spmd_axis: Optional[str] = None) -> torch.Tensor:
    """Number of entries per segment (in-degree when ids are edge
    targets)."""
    return segment_sum(torch.ones(segment_ids.shape, dtype=dtype,
                                  device=segment_ids.device),
                       segment_ids, num_segments, spmd_axis)


def _counts_like(segment_ids: torch.Tensor, num_segments: int,
                 values: torch.Tensor,
                 spmd_axis: Optional[str] = None) -> torch.Tensor:
    """``segment_count`` in ``values``' dtype, shaped to broadcast over its
    trailing axes."""
    counts = segment_count(segment_ids, num_segments, values.dtype,
                           spmd_axis)
    return counts.reshape(counts.shape + (1,) * (values.dim() - 1))


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 spmd_axis: Optional[str] = None) -> torch.Tensor:
    """Mean per segment; empty segments yield 0 (tf.unsorted_segment_mean)."""
    totals = segment_sum(data, segment_ids, num_segments, spmd_axis)
    counts = _counts_like(segment_ids, num_segments, totals, spmd_axis)
    return totals / torch.clamp(counts, min=1.0)


def segment_sqrt_n(data: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Sum per segment over the root of its size
    (tf.unsorted_segment_sqrt_n); empty segments yield 0."""
    totals = segment_sum(data, segment_ids, num_segments)
    counts = _counts_like(segment_ids, num_segments, totals)
    return totals / torch.sqrt(torch.clamp(counts, min=1.0))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, empty_value: float = 0.0) -> torch.Tensor:
    """Max per segment, ``empty_value`` where a segment is empty (where
    tf.unsorted_segment_max gives the dtype's lowest value). Ties share
    the gradient evenly, as under ``jax.ops.segment_max``."""
    ids = _valid_ids(segment_ids, num_segments)
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    maxes = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    maxes = maxes.scatter_reduce(0, index, data, reduce="amax",
                                 include_self=False)[:num_segments]
    counts = _counts_like(segment_ids, num_segments, maxes)
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
    def forward(ctx, params, indices):
        ctx.num_rows = params.shape[0]
        ctx.save_for_backward(indices)
        return params[torch.clamp(indices.long(), 0, params.shape[0] - 1)]

    @staticmethod
    def backward(ctx, g):
        (indices,) = ctx.saved_tensors
        # Summed in f32 and rounded once, on the CPU and the card alike (a
        # bf16 index_add_ on the card rounds at every atomic add).
        return segment_sum(g.float(), indices, ctx.num_rows).to(g.dtype), None


def gather_rows(params: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Row gather whose out-of-range indices CLAMP (``jnp.take`` with
    ``mode="clip"``), with a scatter-add gradient that drops them (their
    rows are discarded downstream, so their cotangents are 0) and sums in
    f32 (the reference's XLA scatter-add of a bf16 cotangent rounds to
    bf16 at every add)."""
    return _GatherRows.apply(params, indices)
