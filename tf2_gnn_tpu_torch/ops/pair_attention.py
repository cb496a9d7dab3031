"""Relational multi-head attention on the block-pair plans (port of
``tf2_gnn_tpu/ops/pair_attention.py``: the merged-plan form
``pair_attention`` and the per-type form ``pair_attention_typed``, under
either softmax stabiliser).

``pair_attention`` computes, per target node v and head k,

    denom[v, k]         = sum over edges e=(u -> v) of expd_e[k]
    weighted[v, hd*K+k] = sum over edges e of expd_e[k] * table[row_e, hd*K+k]

with ``expd_e = exp(LeakyReLU(ss[row_e] + ts[l_e*V + v]) - m_v)``, ``ss`` /
``ts`` the source / target halves of the packed score table and ``m`` a
softmax stabiliser per (target, head) over all edge types jointly. Messages
use the HK-MAJOR head layout (column ``hd*K + k``). The caller divides and
re-layouts heads.

The ``"bound"`` stabiliser is a dense node-space bound; ``"exact"`` runs
the max kernel (B11, ``pair_attention_max``) over the forward plan's
compact form, the per-type form chaining its launches through ``init``.
The forward then runs the expd kernel (B8, ``pair_attention_expd``) once
over the same form, which writes expd by entry of the form, and either the
merged-plan SpMM (B3, ``pair_spmm``) once per head on a head-major table
or, for heads wider than a tile or more heads than that route takes, the
hk-major aggregation kernel (B10, ``pair_attention_agg``) once, each
reading B8's output by entry (``by_entry=True``) over the same compact
form. The backward runs the fused backward
kernel (B9, ``pair_attention_bwd_fused``) once over the backward plan: a
row owner by source row over the plan's compact forms
(``MergedPlan.bwd_rows`` and ``bwd_ts_rows``, built at the batch's first
backward and kept), then a second pass that sums the target-score
gradient by its row. The per-type
form launches each of these once per edge type on that type's ``[V]``-row
slab, with one stabiliser over all types. All five kernels are hand-written
CUDA (``csrc/pair_attention.cu``: B9; ``csrc/pair_stream.cu``: B3, B8,
B10, B11 and B9's second pass). Each wrapper
runs its plain PyTorch version on a CPU tensor and launches its kernel on a
CUDA tensor, or raises.
"""
import ctypes
import functools
from typing import Optional

import torch

from .pair_spmm import (
    _DTYPE_CODES,
    BLK,
    MergedPlan,
    SlotRows,
    TsRows,
    _launch_rows,
    _library,
    _require_compact,
    by_slot,
    launch_expd_rows,
    launch_head_rows,
    launch_max_rows,
    pair_spmm,
    slot_abs_ids,
)

TILE = 128
NEG = -1e30
LEAKY_SLOPE = 0.2
# Lane width of the reference's streamed expd arrays and transposed VMEM
# accumulators: a TPU layout artefact that the port drops (its expd is
# [K, n] by entry of the forward compact form); kept for
# ``pair_attention_applicable``, whose routing the port mirrors.
ACC_W = 16
# The reference's resident VMEM budgets (bytes), read only by
# ``pair_attention_applicable``.
SCORE_BUDGET_BYTES = 12 * 1024 * 1024
TABLE_BUDGET_BYTES = 11 * 1024 * 1024
RESIDENT_BUDGET_BYTES = 13 * 1024 * 1024


def _expd_width(num_heads: int) -> int:
    return max(ACC_W, num_heads)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def pair_attention_applicable(rows: int, num_nodes: int, hidden_dim: int,
                              num_heads: int, table_dtype, score_dtype,
                              src_space: int = None) -> bool:
    """The reference's static gate of the pair-attention path (its VMEM
    budgets included), so that the port takes the path the reference takes
    on the same shapes. ``src_space`` is one type's source-row count."""
    if num_heads <= 0 or hidden_dim % num_heads or TILE % num_heads:
        return False
    if num_heads > min(ACC_W, 8):
        return False
    vs = num_nodes if src_space is None else src_space
    if num_nodes % BLK or vs % BLK or rows % vs:
        return False
    t_item = _itemsize(table_dtype)
    s_item = _itemsize(score_dtype)
    if rows * 128 * s_item + num_nodes * 128 * 4 > SCORE_BUDGET_BYTES:
        return False
    if rows * TILE * t_item + ACC_W * num_nodes * 4 > TABLE_BUDGET_BYTES:
        return False
    num_types = max(rows // max(vs, 1), 1)
    extra = ACC_W + _expd_width(num_heads) + num_heads * num_types
    haug = max(-(-(hidden_dim + extra) // TILE) * TILE, TILE)
    return (num_nodes * haug * t_item + ACC_W * rows * 4
            <= RESIDENT_BUDGET_BYTES)


def _leaky(p):
    return torch.where(p >= 0, p, LEAKY_SLOPE * p)


def _take(x, idx):
    """Rows of ``x`` at ``idx`` clipped into range (``jnp.take`` with
    ``mode="clip"``)."""
    return x[torch.clamp(idx, 0, x.shape[0] - 1)]


def _slot_logits(scores, rel_src, rel_tgt, src_blk, grp_tgt,
                 num_nodes: int, swap: bool, src_space: int = None):
    """Per-slot (pre-activation p, logit, tgt node, src row, valid) on one
    plan direction. ``swap=True`` reads a BACKWARD plan, whose plan-"src"
    role is the original target node and plan-"tgt" role the source row."""
    a_abs, b_abs, valid = slot_abs_ids(rel_src, rel_tgt, src_blk, grp_tgt)
    src_rows, tgt_nodes = (b_abs, a_abs) if swap else (a_abs, b_abs)
    k = scores.shape[1] // 2
    vs = num_nodes if src_space is None else src_space
    ltype = src_rows // vs
    ss = _take(scores, src_rows)[:, :k]
    ts = _take(scores, ltype * vs + tgt_nodes)[:, k:]
    p = ss.float() + ts.float()
    return p, _leaky(p), tgt_nodes, src_rows, valid


def _overflow_logits(scores, ovf_src, ovf_tgt, num_nodes: int,
                     src_space: int = None):
    """(p, logit, valid) of the overflow edges."""
    k = scores.shape[1] // 2
    v = num_nodes
    vs = v if src_space is None else src_space
    ovf_src = ovf_src.long()
    ovf_tgt = ovf_tgt.long()
    valid = ovf_tgt < v
    ltype = ovf_src // vs
    ss = _take(scores, ovf_src)[:, :k]
    ts = _take(scores, ltype * vs + torch.clamp(ovf_tgt, max=v - 1))[:, k:]
    p = ss.float() + ts.float()
    return p, _leaky(p), valid


def _bound_stabiliser(scores, v: int, k: int, src_space: int = None):
    """[V, K] upper bound on the per-(target, head) max logit from two
    dense node-space reduces (no pass over the edges):

        m[t, j] = leaky(max over types l of (max over sources u of
                        ss[l*V+u, j]) + ts[l*V+t, j]).

    Softmax is shift-invariant, so the normalised output is exact under any
    stabiliser at or above the true max. Pad heads (source half 0, target
    half NEG) get a huge negative finite bound."""
    vs = v if src_space is None else src_space
    num_types = scores.shape[0] // vs
    ss = scores[:, :k].float().reshape(num_types, vs, k)
    ts = scores[:, k:2 * k].float().reshape(num_types, vs, k)[:, :v]
    smax = ss.amax(dim=1)                                 # [L, K]
    return _leaky((smax[:, None, :] + ts).amax(dim=0))    # [V, K]


def _stabilise(m, stream_dtype):
    """A finite stabiliser rounded to the stream dtype and never
    differentiated: forward and backward read the same rounded value.
    Targets with no in-edges keep a finite value so exp() stays 0."""
    m_safe = torch.where(m > 0.5 * NEG, m, torch.zeros_like(m)).detach()
    return m_safe.to(stream_dtype).float()


# ---------------------------------------------------------------------------
# The four attention kernels (B9 in csrc/pair_attention.cu, B8, B10 and B11
# in csrc/pair_stream.cu), their plain versions and wrappers.

# Launch counts of the CUDA kernels of this module: each wrapper adds one
# where it launches its kernel, and nowhere else.
LAUNCHES = {"pair_attention_expd": 0, "pair_attention_bwd_fused": 0,
            "pair_attention_max": 0, "pair_attention_agg": 0}

_SOURCE = "pair_attention.cu"


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _segment_max(values, seg, num_segments: int):
    """[num_segments, K] max of ``values`` rows per segment id; ids at or
    above ``num_segments`` are dropped and empty segments read NEG (the
    reference's ``segment_max`` followed by ``jnp.maximum(out, NEG)``)."""
    seg = torch.where(seg < num_segments, seg,
                      torch.full_like(seg, num_segments))
    out = values.new_full((num_segments + 1, values.shape[1]), -torch.inf)
    out.scatter_reduce_(0, seg[:, None].expand(values.shape), values, "amax")
    return out[:num_segments].clamp_min(NEG)


def pair_attention_max_plain(scores, rel_src, rel_tgt, src_blk, grp_tgt,
                             num_nodes: int, num_heads: int,
                             src_space: int = None, init=None):
    """Plain PyTorch version of B11, a mirror of the reference's
    ``_max_kernel_jnp`` with its interpret path's ``maximum(out, NEG)``:
    f32 ``[V, K]``, the per-(target, head) max logit over the forward
    plan's valid slots, NEG where a target has none; with ``init`` (f32
    [V, K]) the elementwise ``maximum(init, ...)``, as the TPU kernel
    starts from its aliased output."""
    del num_heads  # the scores' width, 2K
    v = num_nodes
    _, logit, tgt, _, valid = _slot_logits(
        scores, rel_src, rel_tgt, src_blk, grp_tgt, v, swap=False,
        src_space=src_space)
    logit = torch.where(valid[:, None], logit, torch.full_like(logit, NEG))
    seg = torch.where(valid, tgt, torch.full_like(tgt, v))
    out = _segment_max(logit, seg, v)
    return out if init is None else torch.maximum(init, out)


def pair_attention_agg_plain(table, expd, rel_src, rel_tgt, src_blk, grp_tgt,
                             num_nodes: int, num_heads: int):
    """Plain PyTorch version of B10, a mirror of the reference's
    ``_agg_kernel_jnp`` on the port's ``[K, slots]`` expd layout (the
    reference's is its transpose): (denom [V, K], weighted [V, H]) in f32,

        denom[t, k] = sum of expd[k, s],
        weighted[t, hd*K + k] = sum of expd[k, s] * table[u, hd*K + k]

    over the valid slots s = (u -> t)."""
    v, k = num_nodes, num_heads
    srcabs, tgtabs, valid = slot_abs_ids(rel_src, rel_tgt, src_blk, grp_tgt)
    head_dim = table.shape[1] // k
    msgs = _take(table, srcabs).float()
    e = expd.t() * valid[:, None]
    seg = torch.where(valid & (tgtabs < v), tgtabs, torch.full_like(tgtabs, v))
    weighted = msgs.new_zeros((v + 1, table.shape[1])).index_add_(
        0, seg, msgs * e.repeat(1, head_dim))[:v]
    denom = e.new_zeros((v + 1, k)).index_add_(0, seg, e)[:v]
    return denom, weighted


def pair_attention_expd_plain(scores, maxes, rel_src, rel_tgt, src_blk,
                              grp_tgt, num_nodes: int, num_heads: int,
                              src_space: int = None):
    """Plain PyTorch version of B8, a mirror of the reference's
    ``_expd_kernel_jnp`` in forward slot order without the slope: f32
    ``[K, slots]``, row k the head-k expd of every slot (0 on padded
    slots)."""
    _, logit, tgt, _, valid = _slot_logits(
        scores, rel_src, rel_tgt, src_blk, grp_tgt, num_nodes, swap=False,
        src_space=src_space)
    expd = torch.where(valid[:, None], torch.exp(logit - _take(maxes, tgt)),
                       torch.zeros_like(logit))
    return expd[:, :num_heads].t().contiguous()


def pair_attention_bwd_fused_plain(table, d_weighted, d_denom, scores,
                                   maxes, rel_src, rel_tgt, src_blk, grp_tgt,
                                   num_nodes: int, num_heads: int,
                                   src_space: int = None):
    """Plain PyTorch version of B9, a mirror of the reference's
    ``_bwd_fused_jnp`` over the backward plan: (d_src_scores [rows, K],
    d_tgt_scores [rows, K], d_table [rows, H]), all f32, with

        d_p = expd * slope * (head-sum(table[u] * dw[t]) + d_denom[t])
        d_src_scores[u] += d_p,  d_tgt_scores[l*V + t] += d_p,
        d_table[u, hd*K + k] += expd[k] * dw[t, hd*K + k].
    """
    rows = table.shape[0]
    vs = num_nodes if src_space is None else src_space
    k = num_heads
    head_dim = table.shape[1] // k
    a_abs, b_abs, valid = slot_abs_ids(rel_src, rel_tgt, src_blk, grp_tgt)
    src_rows, tgt_nodes = b_abs, a_abs
    msgs = _take(table, src_rows).float()
    dwg = _take(d_weighted, tgt_nodes).float()
    ddg = _take(d_denom, tgt_nodes)
    de = (msgs * dwg).reshape(-1, head_dim, k).sum(dim=1) + ddg
    p, logit, tgt_b, _, _ = _slot_logits(
        scores, rel_src, rel_tgt, src_blk, grp_tgt, num_nodes, swap=True,
        src_space=src_space)
    valid_f = valid[:, None].float()
    e_n = torch.where(valid[:, None], torch.exp(logit - _take(maxes, tgt_b)),
                      torch.zeros_like(logit))
    slope = torch.where(p >= 0, 1.0, LEAKY_SLOPE)
    d_p = e_n * slope * de * valid_f

    def segment_sum(values, seg):
        seg = torch.where(valid & (seg < rows), seg, torch.full_like(seg, rows))
        out = values.new_zeros((rows + 1, values.shape[1]))
        return out.index_add_(0, seg, values)[:rows]

    d_ss = segment_sum(d_p, src_rows)
    d_ts = segment_sum(d_p, (src_rows // vs) * vs + tgt_nodes)
    d_table = segment_sum(dwg * (e_n * valid_f).repeat(1, head_dim), src_rows)
    return d_ss, d_ts, d_table


def _check(entry: str, device, **tensors) -> None:
    for name, (t, dtypes) in tensors.items():
        if t.device != device:
            raise ValueError(f"{entry}: {name} is on {t.device}, expected "
                             f"{device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{entry}: {name} has dtype {t.dtype}, expected "
                            f"one of {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{entry}: {name} must be contiguous")


def _heads_checks(entry: str, k: int, scores) -> None:
    if k <= 0 or 32 % k or scores.dim() != 2 or scores.shape[1] != 2 * k:
        raise ValueError(f"{entry}: needs 32 % num_heads == 0 and scores of "
                         f"[rows, 2 * num_heads], got num_heads={k} and "
                         f"scores of {tuple(scores.shape)}")


def _call(lib, entry: str, argtypes, *args) -> None:
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    err = fn(*args)
    if err != 0:
        lib.pair_attention_error_string.restype = ctypes.c_char_p
        lib.pair_attention_error_string.argtypes = [ctypes.c_int]
        msg = lib.pair_attention_error_string(err).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {err} ({msg})")


def pair_attention_expd(scores, maxes, rel_src, rel_tgt, src_blk, grp_tgt,
                        num_nodes: int, num_heads: int,
                        src_space: int = None,
                        compact: Optional[SlotRows] = None):
    """B8: the forward plan's expd, f32 ``[K, n]`` by entry of ``compact``
    (``MergedPlan.fwd_rows(V, rows)``, the form B11, B3 and B10 read):
    column e is the value of the entry's plan slot, so each head's row is
    the by-entry scale of its B3 launch and B10's expd
    (``by_entry=True``). ``scores`` [rows, 2K] f32 or bf16, ``maxes`` the
    f32 [V, K] stabiliser. On the card it reads only the compact form,
    through ``csrc/pair_stream.cu``'s expd row owner; on the CPU it is the
    plain version at the form's slots. Without ``compact`` (the CPU only)
    it is the plain version, ``[K, slots]`` by slot."""
    if scores.device.type == "cpu":
        expd = pair_attention_expd_plain(
            scores, maxes, rel_src, rel_tgt, src_blk, grp_tgt, num_nodes,
            num_heads, src_space)
        if compact is None:
            return expd
        return expd[:, compact.slot.long()].contiguous()
    if scores.device.type != "cuda":
        raise TypeError(f"pair_attention_expd: unsupported device "
                        f"{scores.device}")
    _require_compact("pair_attention_expd", compact)
    _library()
    entry = "pair_attention_expd_launch"
    k, v = num_heads, num_nodes
    vs = v if src_space is None else src_space
    _heads_checks(entry, k, scores)
    if compact.num_slots != rel_src.numel():
        raise ValueError(f"{entry}: the compact form is over "
                         f"{compact.num_slots} slots, the plan has "
                         f"{rel_src.numel()}")
    out = launch_expd_rows(scores, maxes, k, compact, v, vs)
    LAUNCHES["pair_attention_expd"] += 1
    return out


def pair_attention_bwd_fused(table, d_weighted, d_denom, scores, maxes,
                             rel_src, rel_tgt, src_blk, grp_tgt,
                             num_nodes: int, num_heads: int,
                             src_space: int = None,
                             compact: Optional[SlotRows] = None,
                             ts_rows: Optional[TsRows] = None):
    """B9: the three gradients of one backward-plan pass, (d_src_scores
    [rows, K], d_tgt_scores [rows, K], d_table [rows, H]) in f32 (see
    ``pair_attention_bwd_fused_plain``). ``table``, ``d_weighted`` and
    ``scores`` share the stream dtype (f32 or bf16); ``d_denom`` and
    ``maxes`` are f32 [V, K]. On the card it reads only the plan's compact
    forms, ``compact`` (``MergedPlan.bwd_rows(rows, V)``) and ``ts_rows``
    (``MergedPlan.bwd_ts_rows(rows, V, src_space or V)``), in two launches
    counted as one: the row owner by source row and the d_ts sum over
    ``ts_rows.sums`` (``csrc/pair_stream.cu``'s row owner); on the CPU the
    plain version reads the plan arrays."""
    if table.device.type == "cpu":
        return pair_attention_bwd_fused_plain(
            table, d_weighted, d_denom, scores, maxes, rel_src, rel_tgt,
            src_blk, grp_tgt, num_nodes, num_heads, src_space)
    if table.device.type != "cuda":
        raise TypeError(f"pair_attention_bwd_fused: unsupported device "
                        f"{table.device}")
    _require_compact("pair_attention_bwd_fused", compact)
    _require_compact("pair_attention_bwd_fused", ts_rows, "ts_rows")
    from .cuda_build import load_library

    lib = load_library(_SOURCE)
    entry = "pair_attention_bwd_rows_launch"
    k, v = num_heads, num_nodes
    vs = v if src_space is None else src_space
    stream = (table.dtype,)
    f32 = (torch.float32,)
    _check(entry, table.device, table=(table, tuple(_DTYPE_CODES)),
           d_weighted=(d_weighted, stream), scores=(scores, stream),
           d_denom=(d_denom, f32), maxes=(maxes, f32))
    _heads_checks(entry, k, scores)
    if table.dim() != 2:
        raise ValueError(f"{entry}: table must be 2-D")
    rows, h = table.shape
    if k > 8 or h % k or tuple(d_weighted.shape) != (v, h):
        raise ValueError(f"{entry}: needs num_heads 1, 2, 4 or 8 dividing "
                         f"the table's width and d_weighted of [{v}, {h}], "
                         f"got num_heads={k}, table of {tuple(table.shape)}, "
                         f"d_weighted of {tuple(d_weighted.shape)}")
    if (scores.shape[0] != rows or tuple(d_denom.shape) != (v, k)
            or tuple(maxes.shape) != (v, k) or vs <= 0 or rows % vs):
        raise ValueError(f"{entry}: inconsistent operand shapes (scores "
                         f"{tuple(scores.shape)}, d_denom "
                         f"{tuple(d_denom.shape)}, maxes "
                         f"{tuple(maxes.shape)}, {rows} rows of {vs})")
    n = compact.src_row.numel()
    if ((compact.out_rows, compact.table_rows) != (rows, v)
            or compact.num_slots != rel_src.numel()
            or ts_rows.score_row.numel() != n
            or (ts_rows.sums.out_rows, ts_rows.sums.table_rows) != (rows, n)):
        raise ValueError(
            f"{entry}: the compact forms are of {compact.num_slots} slots "
            f"into {compact.out_rows} rows from {compact.table_rows} (d_ts "
            f"over {ts_rows.sums.table_rows} entries into "
            f"{ts_rows.sums.out_rows} rows); the call has {rel_src.numel()} "
            f"slots, {rows} rows, a [{v}]-row d_weighted and {n} entries")
    if compact.row_ptr.device != table.device:
        raise ValueError(f"{entry}: the compact form is on "
                         f"{compact.row_ptr.device}, the table on "
                         f"{table.device}")
    dev = table.device
    d_ss = torch.empty((rows, k), dtype=torch.float32, device=dev)
    d_table = torch.empty((rows, h), dtype=torch.float32, device=dev)
    d_p = torch.empty((n, k), dtype=torch.float32, device=dev)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    _call(lib, entry,
          [i, i, p, p, p, p, p, i64, i, i, p, p, p, p, p, p, p],
          dev.index or 0, _DTYPE_CODES[table.dtype], table.data_ptr(),
          d_weighted.data_ptr(), d_denom.data_ptr(), scores.data_ptr(),
          maxes.data_ptr(), rows, h, k, compact.row_ptr.data_ptr(),
          compact.src_row.data_ptr(), ts_rows.score_row.data_ptr(),
          d_ss.data_ptr(), d_table.data_ptr(), d_p.data_ptr(),
          torch.cuda.current_stream(dev).cuda_stream)
    d_ts = _launch_rows("pair_attention_ts_launch", d_p, None, ts_rows.sums,
                        rows)
    LAUNCHES["pair_attention_bwd_fused"] += 1
    return d_ss, d_ts, d_table


def pair_attention_max(scores, rel_src, rel_tgt, src_blk, grp_tgt,
                       num_nodes: int, num_heads: int,
                       src_space: int = None,
                       compact: Optional[SlotRows] = None, init=None):
    """B11: the per-(target, head) max logit over the forward plan's valid
    slots, f32 ``[V, K]``, NEG on targets without in-edges; with ``init``
    (f32 [V, K]) the elementwise max of ``init`` and that. ``scores``
    [rows, 2K] f32 or bf16. On the card it reads only the plan's
    ``compact`` form (``MergedPlan.fwd_rows(V, rows)``, the form B3 and
    B10 read), through ``csrc/pair_stream.cu``'s max row owner; on the
    CPU the plain version reads the plan arrays."""
    if scores.device.type == "cpu":
        return pair_attention_max_plain(scores, rel_src, rel_tgt, src_blk,
                                        grp_tgt, num_nodes, num_heads,
                                        src_space, init)
    if scores.device.type != "cuda":
        raise TypeError(f"pair_attention_max: unsupported device "
                        f"{scores.device}")
    _require_compact("pair_attention_max", compact)
    _library()
    entry = "pair_attention_max_launch"
    k, v = num_heads, num_nodes
    vs = v if src_space is None else src_space
    _heads_checks(entry, k, scores)
    if not scores.is_contiguous() or vs <= 0:
        raise ValueError(f"{entry}: needs contiguous scores and src_space "
                         f"> 0, got src_space {vs}")
    if compact.num_slots != rel_src.numel():
        raise ValueError(f"{entry}: the compact form is over "
                         f"{compact.num_slots} slots, the plan has "
                         f"{rel_src.numel()}")
    out = launch_max_rows(entry, scores, k, compact, v, vs, init)
    LAUNCHES["pair_attention_max"] += 1
    return out


def pair_attention_agg(table, expd, rel_src, rel_tgt, src_blk, grp_tgt,
                       num_nodes: int, num_heads: int,
                       compact: Optional[SlotRows] = None,
                       by_entry: bool = False):
    """B10: (denom [V, K], weighted [V, H]) in f32, the softmax denominators
    and expd-weighted hk-major message sums over the forward plan's valid
    slots (see ``pair_attention_agg_plain``). ``table`` [rows, H] f32 or
    bf16, ``expd`` f32 ``[K, slots]``, or with ``by_entry`` B8's ``[K, n]``
    by entry of ``compact``. On the card it reads only the plan's
    ``compact`` form (``MergedPlan.fwd_rows(V, rows)``, the form B3 reads)
    and expd, through ``csrc/pair_stream.cu``'s per-head row owner; on the
    CPU the plain version reads the plan arrays (a by-entry expd put back
    in slot order)."""
    if table.device.type == "cpu":
        if by_entry:
            expd = by_slot(expd, compact)
        return pair_attention_agg_plain(table, expd, rel_src, rel_tgt,
                                        src_blk, grp_tgt, num_nodes,
                                        num_heads)
    if table.device.type != "cuda":
        raise TypeError(f"pair_attention_agg: unsupported device "
                        f"{table.device}")
    _require_compact("pair_attention_agg", compact)
    _library()
    entry = "pair_attention_agg_launch"
    k, slots = num_heads, rel_src.numel()
    count = compact.src_row.numel() if by_entry else slots
    if k <= 0 or 32 % k or tuple(expd.shape) != (k, count):
        raise ValueError(f"{entry}: needs 32 % num_heads == 0 and expd of "
                         f"[{k}, {count}], got num_heads={k} and expd of "
                         f"{tuple(expd.shape)}")
    if compact.num_slots != slots:
        raise ValueError(f"{entry}: the compact form is over "
                         f"{compact.num_slots} slots, the plan has {slots}")
    out = launch_head_rows(entry, table, expd, count, 1, k, compact,
                           num_nodes, by_entry)
    LAUNCHES["pair_attention_agg"] += 1
    return out


# ---------------------------------------------------------------------------
# The attention op.


def _headmajor_sums(table, expd_e, plan: MergedPlan, v: int, k: int):
    """(denom, weighted) through K ``pair_spmm`` launches, one per head, on
    a head-major layout: head kk's table is its head_dim columns plus a
    column of ones, whose output column is the head's denominator; its
    by-entry scale is row kk of B8's ``expd_e``. Every launch reads the
    plan's one compact form (``plan.fwd_rows``, built at the batch's first
    forward). The reference pads each head's table to the TPU's 128-lane
    tile; the CUDA kernel masks the ragged edge, so the port does not."""
    rows = table.shape[0]
    head_dim = table.shape[1] // k
    heads_km = table.reshape(rows, head_dim, k).permute(2, 0, 1)
    t_heads = torch.cat(
        [heads_km, table.new_ones((k, rows, 1))], dim=2).contiguous()
    compact = plan.fwd_rows(v, rows)
    outs = [pair_spmm(t_heads[kk], expd_e[kk], *plan.fwd, v, compact=compact,
                      by_entry=True)
            for kk in range(k)]
    denom = torch.stack([o[:, head_dim] for o in outs], dim=-1)
    weighted = torch.stack([o[:, :head_dim] for o in outs],
                           dim=-1).reshape(v, head_dim * k)
    return denom, weighted


def _launch_max(scores, plan: MergedPlan, v: int, k: int,
                src_space: Optional[int], init=None):
    """The raw per-(target, head) max of one launch, f32 [V, K] with NEG
    on empty targets, or its max with ``init``: B11 over the plan's
    compact form (``plan.fwd_rows``, built at the batch's first forward and
    shared with B3 and B10) and the overflow edges in plain torch."""
    m_k = pair_attention_max(scores, *plan.fwd, v, k, src_space=src_space,
                             compact=plan.fwd_rows(v, scores.shape[0]),
                             init=init)
    if plan.ovf_src.shape[0] == 0:  # no spilled edges (the common case)
        return m_k
    ovf_tgt = plan.ovf_tgt.long()
    _, l_o, valid_o = _overflow_logits(scores, plan.ovf_src, ovf_tgt, v,
                                       src_space)
    seg_o = torch.where(valid_o, ovf_tgt, torch.full_like(ovf_tgt, v))
    m_o = _segment_max(
        torch.where(valid_o[:, None], l_o, torch.full_like(l_o, NEG)), seg_o,
        v)
    return torch.maximum(m_k, m_o)


def _launch_sums(table, scores, m_safe, plan: MergedPlan, v: int, k: int,
                 src_space: Optional[int]):
    """(denom, weighted, expd_o, slope_o) under a given stabiliser: B8 by
    entry of the plan's forward compact form (``plan.fwd_rows``, built at
    the batch's first forward and shared with B11), then the head-major B3
    launches or B10 reading it by entry, as the reference routes them (its
    measured TPU cost model: head-major when its K sweeps beat B10's
    feature-tile sweeps with a factor-4 margin), and the overflow edges in
    plain torch."""
    head_dim = table.shape[1] // k
    h_tiles = max(-(-table.shape[1] // TILE), 1)
    compact = plan.fwd_rows(v, table.shape[0])
    expd_e = pair_attention_expd(scores, m_safe, *plan.fwd, v, k,
                                 src_space=src_space, compact=compact)
    if head_dim + 1 <= TILE and k <= 4 * h_tiles:
        denom, weighted = _headmajor_sums(table, expd_e, plan, v, k)
    else:
        denom, weighted = pair_attention_agg(
            table, expd_e, *plan.fwd, v, k, compact=compact, by_entry=True)
    if plan.ovf_src.shape[0] == 0:  # no spilled edges (the common case)
        zero_o = table.new_zeros((0, k), dtype=torch.float32)
        return denom, weighted, zero_o, zero_o
    ovf_src, ovf_tgt = plan.ovf_src.long(), plan.ovf_tgt.long()
    p_o, l_o, valid_o = _overflow_logits(scores, ovf_src, ovf_tgt, v,
                                         src_space)
    seg_o = torch.where(valid_o, ovf_tgt, torch.full_like(ovf_tgt, v))
    expd_o = torch.where(
        valid_o[:, None],
        torch.exp(l_o - _take(m_safe, torch.clamp(ovf_tgt, max=v - 1))),
        torch.zeros_like(l_o))
    slope_o = torch.where(p_o >= 0, 1.0, LEAKY_SLOPE)
    msgs_o = _take(table, ovf_src).float()
    denom = denom + denom.new_zeros((v + 1, k)).index_add_(
        0, seg_o, expd_o)[:v]
    weighted = weighted + weighted.new_zeros(
        (v + 1, weighted.shape[1])).index_add_(
        0, seg_o, msgs_o * expd_o.repeat(1, head_dim))[:v]
    return denom, weighted, expd_o, slope_o


def _launch_bwd(table, scores, m_safe, d_denom, d_weighted, dw_stream,
                plan: MergedPlan, expd_o, slope_o, v: int, k: int,
                src_space: Optional[int]):
    """(d_src_scores, d_tgt_scores, d_table): B9 over the plan's compact
    forms (built at the batch's first backward) plus the overflow terms."""
    rows = table.shape[0]
    head_dim = table.shape[1] // k
    vs = v if src_space is None else src_space
    d_ss, d_ts, d_table = pair_attention_bwd_fused(
        table, dw_stream, d_denom, scores, m_safe, *plan.bwd, v, k,
        src_space=src_space, compact=plan.bwd_rows(rows, v),
        ts_rows=plan.bwd_ts_rows(rows, v, vs))
    if plan.ovf_src.shape[0] == 0:
        return d_ss, d_ts, d_table
    ovf_src, ovf_tgt = plan.ovf_src.long(), plan.ovf_tgt.long()
    valid_o = (ovf_tgt < v)[:, None].float()
    tgt_o = torch.clamp(ovf_tgt, max=v - 1)
    dwg_o = d_weighted[tgt_o] * valid_o
    ddg_o = d_denom[tgt_o] * valid_o
    msgs_o = _take(table, ovf_src).float()
    de_o = (msgs_o * dwg_o).reshape(-1, head_dim, k).sum(dim=1) + ddg_o
    d_p_o = expd_o * slope_o * de_o
    d_table = d_table.index_add(0, ovf_src, dwg_o * expd_o.repeat(1, head_dim))
    d_ss = d_ss.index_add(0, ovf_src, d_p_o)
    seg = torch.where(ovf_tgt < v, (ovf_src // vs) * vs + tgt_o,
                      torch.full_like(ovf_tgt, rows))
    d_ts = torch.cat([d_ts, d_ts.new_zeros((1, k))]).index_add_(
        0, seg, d_p_o)[:rows]
    return d_ss, d_ts, d_table


def _check_stabiliser(stabiliser: str) -> None:
    if stabiliser not in ("bound", "exact"):
        raise ValueError(f"unknown stabiliser {stabiliser!r}; expected "
                         "'bound' or 'exact'")


class PairAttention(torch.autograd.Function):
    """``pair_attention`` and ``pair_attention_typed`` as one autograd op
    over ``plans``: one merged plan over the whole tables, or one plan per
    edge type over the type's [V]-row slab (the reference's ``_pat_fwd`` /
    ``_pat_bwd``). The forward takes one stabiliser for all plans (the
    bound over the stacked scores, or the B11 launches chained through
    ``init``: each starts from the max of the plans before it), sums B8
    and B3 or B10 over the plans, and saves the rounded stabiliser and the
    overflow edges' expd and slope; the backward runs B9 per plan with the
    same full cotangents and stacks the gradients along rows. Gradients
    come back in the input dtypes (bf16 inputs get bf16 gradients, as the
    reference's custom VJP returns them), so callers cast to the stream
    dtype OUTSIDE the op."""

    @staticmethod
    def forward(ctx, table_hk, scores, plans, num_nodes: int,
                num_heads: int, stabiliser: str, src_space: Optional[int]):
        v, k = num_nodes, num_heads
        _check_stabiliser(stabiliser)
        table = table_hk.contiguous()
        scores = scores.contiguous()
        tables = table.reshape(len(plans), -1, table.shape[1])
        sc = scores.reshape(len(plans), -1, scores.shape[1])
        if stabiliser == "bound":
            # The bound already spans all plans: one dense reduce over the
            # stacked scores, no max kernel.
            m = _bound_stabiliser(scores, v, k, src_space)
        else:
            # One launch a plan, each starting from the maxes of the
            # plans before it (a max does not depend on the order).
            m = None
            for s, plan in zip(sc, plans):
                m = _launch_max(s, plan, v, k, src_space, m)
        m_safe = _stabilise(m, table.dtype)
        sums = [_launch_sums(t, s, m_safe, plan, v, k, src_space)
                for t, s, plan in zip(tables, sc, plans)]
        denom = functools.reduce(torch.add, (part[0] for part in sums))
        weighted = functools.reduce(torch.add, (part[1] for part in sums))
        ctx.save_for_backward(table, scores, m_safe,
                              *(x for part in sums for x in part[2:]))
        ctx.plans, ctx.v, ctx.k, ctx.src_space = plans, v, k, src_space
        return denom, weighted

    @staticmethod
    def backward(ctx, g_denom, g_weighted):
        table, scores, m_safe, *saved_o = ctx.saved_tensors
        plans = ctx.plans
        d_denom = g_denom.float().contiguous()
        d_weighted = g_weighted.float()
        # The cotangent streams at the table dtype, as the forward messages.
        dw_stream = d_weighted.to(table.dtype).contiguous()
        tables = table.reshape(len(plans), -1, table.shape[1])
        sc = scores.reshape(len(plans), -1, scores.shape[1])
        d_tables, d_scores = [], []
        for l, plan in enumerate(plans):
            d_ss, d_ts, d_table = _launch_bwd(
                tables[l], sc[l], m_safe, d_denom, d_weighted, dw_stream,
                plan, saved_o[2 * l], saved_o[2 * l + 1], ctx.v, ctx.k,
                ctx.src_space)
            d_tables.append(d_table)
            d_scores.append(torch.cat([d_ss, d_ts], dim=1))
        rows = (lambda xs: xs[0] if len(xs) == 1 else torch.cat(xs))
        return (rows(d_tables).to(table.dtype),
                rows(d_scores).to(scores.dtype), None, None, None, None,
                None)


def pair_attention(table_hk, scores, plan: MergedPlan, num_nodes: int,
                   num_heads: int, stabiliser: str,
                   src_space: Optional[int] = None):
    """(denom [V, K], weighted [V, H]) of relational multi-head attention
    over a merged plan on the tables' device. ``table_hk`` [L*Vs, H]
    (hk-major heads) and ``scores`` [L*Vs, 2K] (source | target halves)
    in the stream dtype; ``stabiliser`` is ``"bound"`` or ``"exact"``."""
    return PairAttention.apply(table_hk, scores, (plan,), num_nodes,
                               num_heads, stabiliser, src_space)


def pair_attention_typed(table_hk, scores, plans_typed, num_nodes: int,
                         num_heads: int, stabiliser: str):
    """The per-type (row-split) form of ``pair_attention``: the same
    (denom [V, K], weighted [V, H]) with one launch of each kernel per edge
    type, over ``plans_typed``, one ``MergedPlan`` per type on the tables'
    device (``GraphBatch.pair_typed``). ``table_hk`` [L*V, H] and
    ``scores`` [L*V, 2K] in the stream dtype; the softmax still spans all
    types jointly."""
    plans = tuple(plans_typed)
    v = num_nodes
    if (not plans or table_hk.shape[0] != len(plans) * v
            or scores.shape[0] != len(plans) * v):
        raise ValueError(
            f"pair_attention_typed: {len(plans)} per-type plans need "
            f"tables of {len(plans)} * {v} rows, got {table_hk.shape[0]} "
            f"and {scores.shape[0]}")
    return PairAttention.apply(table_hk, scores, plans, num_nodes, num_heads,
                               stabiliser, None)
