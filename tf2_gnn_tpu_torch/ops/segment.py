"""Segment (scatter-reduce) primitives over a static segment count (port of
the parts of ``tf2_gnn_tpu/ops/segment.py`` that the readouts and the
global exchange use).

Segment ids outside ``[0, num_segments)`` are dropped, as in
``jax.ops.segment_sum``. The SPMD forms (``spmd_axis``) are not ported.
"""
import torch

from ..utils.constants import SMALL_NUMBER


def _valid_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Ids with the out-of-range ones sent to the discard row
    ``num_segments``."""
    ids = segment_ids.long()
    return torch.where((ids >= 0) & (ids < num_segments), ids,
                       torch.full_like(ids, num_segments))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum of ``data`` rows per segment; empty segments yield 0."""
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, _valid_ids(segment_ids, num_segments), data)
    return out[:num_segments]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean per segment; empty segments yield 0 (tf.unsorted_segment_mean)."""
    totals = segment_sum(data, segment_ids, num_segments)
    counts = segment_sum(torch.ones(segment_ids.shape, dtype=totals.dtype,
                                    device=totals.device),
                         segment_ids, num_segments)
    counts = counts.reshape(counts.shape + (1,) * (totals.dim() - 1))
    return totals / torch.clamp(counts, min=1.0)


def segment_logits_max(logits: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Per-segment max of ``logits``, detached (a stability shift, whose
    true gradient contribution to a softmax is zero), with empty segments
    pinned to 0 so ``logits - max[ids]`` stays finite."""
    ids = _valid_ids(segment_ids, num_segments)
    index = ids.reshape((-1,) + (1,) * (logits.dim() - 1)).expand_as(logits)
    maxes = torch.full((num_segments + 1,) + tuple(logits.shape[1:]),
                       float("-inf"), dtype=logits.dtype,
                       device=logits.device)
    maxes = maxes.scatter_reduce(0, index, logits.detach(), reduce="amax",
                                 include_self=True)[:num_segments]
    return torch.where(torch.isfinite(maxes), maxes, torch.zeros_like(maxes))


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically stable softmax within each segment, with dpu-utils'
    ``unsorted_segment_softmax`` semantics: ``exp(x - max) / (sum + eps)``.
    ``logits`` may be [M] or [M, K] (one softmax per trailing column)."""
    maxes = segment_logits_max(logits, segment_ids, num_segments)
    ids = segment_ids.long()
    # index_select, not ``denom[ids]``: its gradient is an index_add_, where
    # advanced indexing's backward sorts the ids first (0.4 ms a step at
    # V = 8064 on an H100, chip_smoke.py --profile).
    exp_shifted = torch.exp(logits - maxes.index_select(0, ids))
    denom = segment_sum(exp_shifted, segment_ids, num_segments) + SMALL_NUMBER
    return exp_shifted / denom.index_select(0, ids)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, params, indices):
        ctx.num_rows = params.shape[0]
        ctx.save_for_backward(indices)
        return params[torch.clamp(indices.long(), 0, params.shape[0] - 1)]

    @staticmethod
    def backward(ctx, g):
        (indices,) = ctx.saved_tensors
        return segment_sum(g, indices, ctx.num_rows), None


def gather_rows(params: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Row gather whose out-of-range indices CLAMP (``jnp.take`` with
    ``mode="clip"``), with a scatter-add gradient that drops them (their
    rows are discarded downstream, so their cotangents are 0)."""
    return _GatherRows.apply(params, indices)
