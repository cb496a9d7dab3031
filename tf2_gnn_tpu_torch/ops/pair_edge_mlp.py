"""Relu-pair aggregation of the target-state edge MLP with one hidden
layer, the reference's default GNN_Edge_MLP (port of
``tf2_gnn_tpu/ops/pair_edge_mlp.py``).

The op computes, over a MERGED-TARGET pair plan,

    R[t] = sum over edges e=(u -> t) of s_e * relu(A[src_e] + B[t]),

with ``A`` [L*S, H] the stacked per-type source halves of the first
edge-MLP layer and ``B`` [L*V, H] its target halves in merged-target layout
``l * V + v``, which is the forward plan's output row space. The layer
(``layers/message_passing/gnn_edge_mlp.py``) applies the second linear to
R and sums over the types.

``pair_relu_mlp_aggregate`` is a ``torch.autograd.Function``: the training
forward runs B4 (``relu_pair_fwd_m``), which also emits the mask sum
``M[t] = sum of s_e * (A[src_e] + B[t] > 0)``, so the backward's ``dB`` is
the elementwise ``M * g`` and its ``dA`` is one B5 launch
(``relu_pair_da``) over the backward plan. B4's kernel is a row owner over
the forward plan's compact form (``MergedPlan.fwd_rows``, built at the
batch's first training forward and kept on the plan). Where no gradient is
needed (the eval step runs under ``torch.no_grad``) the function runs B6
(``relu_pair_fwd``, R only), as the reference's primal rule does. B7
(``relu_pair_db``, ``dB`` recomputed from the forward plan) is on no call
path, in the reference either; it has its wrapper and plain version like
the others. The overflow edges are plain torch. All four kernels are
hand-written CUDA (``csrc/pair_edge_mlp.cu``); each wrapper runs its plain
PyTorch version (a mirror of the reference's jnp twin, over the plan
arrays) on a CPU tensor and launches its kernel on a CUDA tensor, or
raises.
"""
import ctypes
from typing import Optional

import torch

from .pair_attention import _check, _plan_checks
from .pair_spmm import (
    _DTYPE_CODES,
    TILE,
    MergedPlan,
    SlotRows,
    _require_compact,
    slot_abs_ids,
)
from .segment import segment_sum

# The reference's resident VMEM budgets (bytes), read only by
# ``pair_edge_mlp_applicable``, whose routing the port mirrors.
VMEM_TABLE_BUDGET_BYTES = 11 * 1024 * 1024
VMEM_DUAL_TABLE_BUDGET_BYTES = 13 * 1024 * 1024


def _table_bytes(rows: int, dtype: torch.dtype) -> int:
    return rows * TILE * dtype.itemsize


def pair_edge_mlp_applicable(rows_a: int, rows_b: int, dtype) -> bool:
    """The reference's static gate of the relu-pair path: one resident
    feature tile of A for the forward, B and the cotangent resident for the
    dA pass. The port takes the path where the reference takes it."""
    return (_table_bytes(rows_a, dtype) <= VMEM_TABLE_BUDGET_BYTES
            and 2 * _table_bytes(rows_b, dtype)
            <= VMEM_DUAL_TABLE_BUDGET_BYTES)


# ---------------------------------------------------------------------------
# The four kernels of csrc/pair_edge_mlp.cu, their plain versions and
# wrappers.

# Launch counts of the CUDA kernels of this module: each wrapper adds one
# where it launches its kernel, and nowhere else.
LAUNCHES = {"relu_pair_fwd_m": 0, "relu_pair_da": 0, "relu_pair_fwd": 0,
            "relu_pair_db": 0}

_SOURCE = "pair_edge_mlp.cu"


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _gather(x, idx):
    """Rows of ``x`` at ``idx`` clipped into range (``jnp.take`` with
    ``mode="clip"``), in f32."""
    return x[torch.clamp(idx, 0, x.shape[0] - 1)].float()


def _fwd_slots(a, b, scale, rel_src, rel_tgt, src_blk, grp_tgt, out_rows):
    """(z, w, segment ids) per forward-plan slot: z = A[src] + B[tgt] in
    f32, w the slot's scale (0 on padded slots), ids the output rows
    (``out_rows`` on padded slots)."""
    srcabs, tgtabs, valid = slot_abs_ids(rel_src, rel_tgt, src_blk, grp_tgt)
    z = _gather(a, srcabs) + _gather(b, tgtabs)
    w = (scale.reshape(-1) * valid)[:, None]
    seg = torch.where(valid, tgtabs, torch.full_like(tgtabs, out_rows))
    return z, w, seg


def relu_pair_fwd_plain(a, b, scale, rel_src, rel_tgt, src_blk, grp_tgt,
                        out_rows: int):
    """Plain PyTorch version of B6, a mirror of the reference's
    ``_relu_pair_fwd_jnp``: f32 [out_rows, H] R."""
    z, w, seg = _fwd_slots(a, b, scale, rel_src, rel_tgt, src_blk, grp_tgt,
                           out_rows)
    return segment_sum(torch.relu(z) * w, seg, out_rows)


def relu_pair_fwd_m_plain(a, b, scale, rel_src, rel_tgt, src_blk, grp_tgt,
                          out_rows: int):
    """Plain PyTorch version of B4 (``_relu_pair_fwd_m_jnp``): (R, M), both
    f32 [out_rows, H]."""
    z, w, seg = _fwd_slots(a, b, scale, rel_src, rel_tgt, src_blk, grp_tgt,
                           out_rows)
    return (segment_sum(torch.relu(z) * w, seg, out_rows),
            segment_sum((z > 0.0) * w, seg, out_rows))


def relu_pair_db_plain(a, b, g, scale, rel_src, rel_tgt, src_blk, grp_tgt,
                       out_rows: int):
    """Plain PyTorch version of B7 (``_relu_pair_db_jnp``): f32
    [out_rows, H] ``g * M``."""
    z, w, seg = _fwd_slots(a, b, scale, rel_src, rel_tgt, src_blk, grp_tgt,
                           out_rows)
    return segment_sum((z > 0.0) * w, seg, out_rows) * g.float()


def relu_pair_da_plain(a, b, g, scale_bwd, rel_src, rel_tgt, src_blk,
                       grp_tgt, rows_a: int):
    """Plain PyTorch version of B5 (``_relu_pair_da_jnp``) over the
    BACKWARD plan, whose "source" is the original target t and whose
    output rows are A's rows u: f32 [rows_a, H]
    ``dA[u] = sum of s * (A[u] + B[t] > 0) * g[t]``."""
    tgtabs, srcabs_a, valid = slot_abs_ids(rel_src, rel_tgt, src_blk,
                                           grp_tgt)
    z = _gather(a, srcabs_a) + _gather(b, tgtabs)
    val = torch.where(z > 0.0, _gather(g, tgtabs), 0.0) \
        * (scale_bwd.reshape(-1) * valid)[:, None]
    seg = torch.where(valid, srcabs_a, torch.full_like(srcabs_a, rows_a))
    return segment_sum(val, seg, rows_a)


def _launch(entry: str, a, b, g, scale, rel_src, rel_tgt, src_blk, grp_tgt,
            out_rows: int):
    """Launch one of B5-B7 (``csrc/pair_edge_mlp.cu``) on the current
    stream into a fresh zero-initialised f32 output."""
    from .cuda_build import load_library

    lib = load_library(_SOURCE)
    dev = a.device
    stream_dtypes = tuple(_DTYPE_CODES)
    _check(entry, dev, a=(a, stream_dtypes), b=(b, (a.dtype,)),
           scale=(scale, (torch.float32,)))
    group, num_groups = _plan_checks(entry, dev, rel_src, rel_tgt, src_blk,
                                     grp_tgt)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"{entry}: a and b must be 2-D of one width")
    h = a.shape[1]
    if scale.numel() != rel_src.numel() or out_rows <= 0 or h <= 0:
        raise ValueError(f"{entry}: inconsistent operand shapes")
    if g is not None:
        _check(entry, dev, g=(g, (torch.float32,)))
        # dA reads g at B's rows; dB at the output rows.
        rows_g = b.shape[0] if entry == "relu_pair_da_launch" else out_rows
        if tuple(g.shape) != (rows_g, h):
            raise ValueError(f"{entry}: g must be [{rows_g}, {h}], got "
                             f"{tuple(g.shape)}")
    out = torch.zeros((out_rows, h), dtype=torch.float32, device=dev)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [i, i, p, i64, p, i64, p, i, p, p, p, p, p, i, i, p, i64,
                   p]
    _raise_on(lib, entry, fn(
        dev.index or 0, _DTYPE_CODES[a.dtype], a.data_ptr(), a.shape[0],
        b.data_ptr(), b.shape[0], None if g is None else g.data_ptr(), h,
        scale.data_ptr(), rel_src.data_ptr(), rel_tgt.data_ptr(),
        src_blk.data_ptr(), grp_tgt.data_ptr(), num_groups, group,
        out.data_ptr(), out_rows, torch.cuda.current_stream(dev).cuda_stream))
    return out


def _raise_on(lib, entry: str, err: int) -> None:
    if err != 0:
        lib.relu_pair_error_string.restype = ctypes.c_char_p
        lib.relu_pair_error_string.argtypes = [ctypes.c_int]
        msg = lib.relu_pair_error_string(err).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {err} ({msg})")


def _launch_fwd_m(a, b, scale, compact: SlotRows, out_rows: int):
    """Launch B4's row-owner kernel on the current stream over the forward
    plan's compact form: (R, M), f32 [out_rows, H], every element stored
    once, so the outputs are not initialised."""
    from .cuda_build import load_library

    lib = load_library(_SOURCE)
    entry = "relu_pair_fwd_m_launch"
    dev = a.device
    _check(entry, dev, a=(a, tuple(_DTYPE_CODES)), b=(b, (a.dtype,)),
           scale=(scale, (torch.float32,)))
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"{entry}: a and b must be 2-D of one width")
    h = a.shape[1]
    if (compact.out_rows != out_rows or compact.table_rows != a.shape[0]
            or compact.num_slots != scale.numel() or h <= 0
            or b.shape[0] <= 0):
        raise ValueError(
            f"{entry}: the compact form is of a [{compact.table_rows}]-row "
            f"A into {compact.out_rows} rows over {compact.num_slots} slots; "
            f"the call has a [{a.shape[0]}, {h}] A, {out_rows} output rows "
            f"and {scale.numel()} scales")
    if compact.row_ptr.device != dev:
        raise ValueError(f"{entry}: the compact form is on "
                         f"{compact.row_ptr.device}, A on {dev}")
    r = torch.empty((out_rows, h), dtype=torch.float32, device=dev)
    m = torch.empty_like(r)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = lib.relu_pair_fwd_m_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [i, i, p, p, i64, i, p, p, p, p, i64, p, p, p]
    _raise_on(lib, entry, fn(
        dev.index or 0, _DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(),
        b.shape[0], h, scale.data_ptr(), compact.row_ptr.data_ptr(),
        compact.src_row.data_ptr(), compact.slot.data_ptr(), out_rows,
        r.data_ptr(), m.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream))
    return r, m


def _device_type(name: str, a) -> str:
    if a.device.type not in ("cpu", "cuda"):
        raise TypeError(f"{name}: unsupported device {a.device}")
    return a.device.type


def relu_pair_fwd(a, b, scale, rel_src, rel_tgt, src_blk, grp_tgt,
                  out_rows: int):
    """B6, the eval forward: f32 [out_rows, H] R over the forward plan.
    ``a`` [rows_a, H] and ``b`` [rows_b, H] share the stream dtype (f32 or
    bf16); ``scale`` is f32, one value per slot."""
    if _device_type("relu_pair_fwd", a) == "cpu":
        return relu_pair_fwd_plain(a, b, scale, rel_src, rel_tgt, src_blk,
                                   grp_tgt, out_rows)
    out = _launch("relu_pair_fwd_launch", a, b, None, scale, rel_src,
                  rel_tgt, src_blk, grp_tgt, out_rows)
    LAUNCHES["relu_pair_fwd"] += 1
    return out


def relu_pair_fwd_m(a, b, scale, rel_src, rel_tgt, src_blk, grp_tgt,
                    out_rows: int, compact: Optional[SlotRows] = None):
    """B4, the training forward: (R, M), both f32 [out_rows, H], in one
    sweep of the forward plan. On the card it reads only the plan's
    ``compact`` form (``MergedPlan.fwd_rows(out_rows, rows of a)``) and the
    scales; on the CPU the plain version reads the plan arrays."""
    if _device_type("relu_pair_fwd_m", a) == "cpu":
        return relu_pair_fwd_m_plain(a, b, scale, rel_src, rel_tgt, src_blk,
                                     grp_tgt, out_rows)
    _require_compact("relu_pair_fwd_m", compact)
    out = _launch_fwd_m(a, b, scale, compact, out_rows)
    LAUNCHES["relu_pair_fwd_m"] += 1
    return out


def relu_pair_da(a, b, g, scale_bwd, rel_src, rel_tgt, src_blk, grp_tgt,
                 rows_a: int):
    """B5, the backward's dA over the backward plan: f32 [rows_a, H].
    ``g`` is the f32 cotangent [rows_b, H]."""
    if _device_type("relu_pair_da", a) == "cpu":
        return relu_pair_da_plain(a, b, g, scale_bwd, rel_src, rel_tgt,
                                  src_blk, grp_tgt, rows_a)
    out = _launch("relu_pair_da_launch", a, b, g, scale_bwd, rel_src,
                  rel_tgt, src_blk, grp_tgt, rows_a)
    LAUNCHES["relu_pair_da"] += 1
    return out


def relu_pair_db(a, b, g, scale, rel_src, rel_tgt, src_blk, grp_tgt,
                 out_rows: int):
    """B7, dB recomputed over the forward plan: f32 [out_rows, H]
    ``g * M`` (``g`` the f32 cotangent [out_rows, H]). No call path runs
    it: the training forward's M gives dB directly."""
    if _device_type("relu_pair_db", a) == "cpu":
        return relu_pair_db_plain(a, b, g, scale, rel_src, rel_tgt, src_blk,
                                  grp_tgt, out_rows)
    out = _launch("relu_pair_db_launch", a, b, g, scale, rel_src,
                  rel_tgt, src_blk, grp_tgt, out_rows)
    LAUNCHES["relu_pair_db"] += 1
    return out


# ---------------------------------------------------------------------------
# The differentiable op.


def _overflow_sum(a, b, plan: MergedPlan, ovf_scale, out_rows: int):
    """The overflow edges' share of R, [out_rows, H] f32."""
    ovf_src, ovf_tgt = plan.ovf_src.long(), plan.ovf_tgt.long()
    z = _gather(a, ovf_src) + _gather(b, torch.clamp(ovf_tgt,
                                                     max=out_rows - 1))
    return segment_sum(torch.relu(z) * ovf_scale[:, None], ovf_tgt,
                        out_rows)


class PairReluMlpAggregate(torch.autograd.Function):
    """The training form of ``pair_relu_mlp_aggregate``: B4 forward over
    the plan's compact form (R and the mask sum M, saved), backward ``dB =
    M * g`` in plain torch and ``dA`` through B5, plus the overflow edges
    in plain torch.

    The casts to the stream dtype happen inside the op and the gradients
    leave it in f32: in the reference the transpose of ``astype(bf16)``
    passes the custom VJP's f32 cotangents through unrounded."""

    @staticmethod
    def forward(ctx, a, b, plan: MergedPlan, scale_fwd, scale_bwd,
                ovf_scale, out_rows: int, stream_dtype):
        a_s = a.to(stream_dtype).contiguous()
        b_s = b.to(stream_dtype).contiguous()
        out, m = relu_pair_fwd_m(
            a_s, b_s, scale_fwd, *plan.fwd, out_rows,
            compact=plan.fwd_rows(out_rows, a_s.shape[0]))
        if plan.ovf_src.shape[0]:
            out = out + _overflow_sum(a_s, b_s, plan, ovf_scale, out_rows)
        ctx.save_for_backward(a_s, b_s, m, scale_bwd, ovf_scale)
        ctx.plan, ctx.out_rows = plan, out_rows
        return out

    @staticmethod
    def backward(ctx, g):
        a_s, b_s, m, scale_bwd, ovf_scale = ctx.saved_tensors
        plan, out_rows = ctx.plan, ctx.out_rows
        rows_a = a_s.shape[0]
        g = g.float().contiguous()
        d_b = m * g
        d_a = relu_pair_da(a_s, b_s, g, scale_bwd, *plan.bwd, rows_a)
        if plan.ovf_src.shape[0]:
            ovf_src, ovf_tgt = plan.ovf_src.long(), plan.ovf_tgt.long()
            tgt_c = torch.clamp(ovf_tgt, max=out_rows - 1)
            z = _gather(a_s, ovf_src) + _gather(b_s, tgt_c)
            val = torch.where(z > 0.0, _gather(g, tgt_c), 0.0) \
                * ovf_scale[:, None]
            d_a = d_a + segment_sum(val, ovf_src, rows_a)
            d_b = d_b + segment_sum(val, ovf_tgt, out_rows)
        return d_a, d_b, None, None, None, None, None, None


def pair_relu_mlp_aggregate(a, b, plan: MergedPlan, scale_fwd, scale_bwd,
                            ovf_scale, out_rows: int,
                            stream_dtype: torch.dtype = None):
    """Per-type relu-MLP aggregates over a merged-target plan, f32
    [out_rows, H]: ``R[t] = sum over edges e with merged target t of
    scale_e * relu(a[src_e] + b[t])``. ``a`` [L*S, H] and ``b`` [L*V, H]
    are cast to ``stream_dtype`` (default: ``a``'s dtype), the dtype the
    kernels gather. With gradients needed this is the autograd op (B4 and
    B5); without, the eval forward (B6)."""
    stream_dtype = stream_dtype or a.dtype
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return PairReluMlpAggregate.apply(a, b, plan, scale_fwd, scale_bwd,
                                          ovf_scale, out_rows, stream_dtype)
    a_s = a.to(stream_dtype).contiguous()
    b_s = b.to(stream_dtype).contiguous()
    out = relu_pair_fwd(a_s, b_s, scale_fwd, *plan.fwd, out_rows)
    if plan.ovf_src.shape[0]:
        out = out + _overflow_sum(a_s, b_s, plan, ovf_scale, out_rows)
    return out
