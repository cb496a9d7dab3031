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
(``relu_pair_da``). Where no gradient is needed (the eval step runs under
``torch.no_grad``) the function runs B6 (``relu_pair_fwd``, R only), as
the reference's primal rule does. B4, B6 and B7 (``relu_pair_db``, ``dB``
recomputed from the forward plan: M times g) are one row-owner kernel in
three modes over the forward plan's compact form
(``MergedPlan.fwd_rows``), B5 a row owner by A's row over the backward
plan's (``MergedPlan.bwd_rows``); each form is built at its first read
and kept on the plan, so a batch builds each once. B7 is on no call path,
in the reference either; it has its wrapper and plain version like the
others. The overflow edges are plain torch. All four kernels are
hand-written CUDA
(``csrc/pair_edge_mlp.cu``); each wrapper runs its plain PyTorch version
(a mirror of the reference's jnp twin, over the plan arrays) on a CPU
tensor and launches its kernel on a CUDA tensor, or raises.
"""
import ctypes
from typing import Optional

import torch

from .pair_attention import _check
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
# where it launches its kernel, and nowhere else. ``utils/tracing.py``'s
# registry reads them as ``launch.<name>`` and resets them.
LAUNCHES = {"relu_pair_fwd_m": 0, "relu_pair_da": 0, "relu_pair_fwd": 0,
            "relu_pair_db": 0}

_SOURCE = "pair_edge_mlp.cu"
_INT, _INT64, _PTR = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
# (restype, argtypes) of the library's C entry points, set once at load.
_SIGNATURES = {
    "relu_pair_rows_launch": (ctypes.c_int, [
        _INT, _INT, _PTR, _PTR, _INT64, _INT, _PTR, _PTR, _PTR, _PTR, _INT64,
        _PTR, _PTR, _PTR]),
    "relu_pair_da_rows_launch": (ctypes.c_int, [
        _INT, _INT, _PTR, _PTR, _PTR, _INT, _PTR, _PTR, _PTR, _PTR, _INT64,
        _PTR, _PTR]),
    "relu_pair_db_rows_launch": (ctypes.c_int, [
        _INT, _INT, _PTR, _PTR, _INT64, _PTR, _INT, _PTR, _PTR, _PTR, _PTR,
        _INT64, _PTR, _PTR]),
    "relu_pair_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}



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


def _library():
    from .cuda_build import load_library

    return load_library(_SOURCE, _SIGNATURES)


def _raise_on(lib, entry: str, err: int) -> None:
    if err != 0:
        msg = lib.relu_pair_error_string(err).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {err} ({msg})")


def _check_tables(entry: str, a, b, scale):
    """A and B 2-D of one width and one stream dtype, the f32 scale beside
    them; returns the width."""
    _check(entry, a.device, a=(a, tuple(_DTYPE_CODES)), b=(b, (a.dtype,)),
           scale=(scale, (torch.float32,)))
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"{entry}: a and b must be 2-D of one width")
    if a.shape[1] <= 0 or b.shape[0] <= 0:
        raise ValueError(f"{entry}: empty table")
    return a.shape[1]


def _check_compact(entry: str, compact: SlotRows, table, table_rows: int,
                   out_rows: int, scale) -> None:
    """The compact form's sizes against the call's: the table it gathers
    (``table``, of ``table_rows`` rows), the output rows and the scales.
    Its own tensors were checked when it was built."""
    if (compact.out_rows != out_rows or compact.table_rows != table_rows
            or compact.num_slots != scale.numel()):
        raise ValueError(
            f"{entry}: the compact form is of a [{compact.table_rows}]-row "
            f"table into {compact.out_rows} rows over {compact.num_slots} "
            f"slots; the call has a [{table_rows}]-row table, {out_rows} "
            f"output rows and {scale.numel()} scales")
    if compact.row_ptr.device != table.device:
        raise ValueError(f"{entry}: the compact form is on "
                         f"{compact.row_ptr.device}, the tables on "
                         f"{table.device}")


def _check_g(entry: str, g, rows: int, h: int, device) -> None:
    _check(entry, device, g=(g, (torch.float32,)))
    if tuple(g.shape) != (rows, h):
        raise ValueError(f"{entry}: g must be [{rows}, {h}], got "
                         f"{tuple(g.shape)}")


def _launch_fwd_rows(a, b, scale, compact: SlotRows, out_rows: int,
                     with_m: bool = False, g=None):
    """Launch the forward row owner (B4 ``with_m``, B7 with the f32
    cotangent ``g`` [out_rows, H], else B6) on the current stream over the
    forward plan's compact form: R, (R, M) or B7's dB = M * g, f32
    [out_rows, H], every element stored once, so the outputs are not
    initialised."""
    lib = _library()
    entry = ("relu_pair_rows_launch" if g is None
             else "relu_pair_db_rows_launch")
    h = _check_tables(entry, a, b, scale)
    _check_compact(entry, compact, a, a.shape[0], out_rows, scale)
    dev = a.device
    out = torch.empty((out_rows, h), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if g is not None:
        _check_g(entry, g, out_rows, h, dev)
        _raise_on(lib, entry, lib.relu_pair_db_rows_launch(
            dev.index or 0, _DTYPE_CODES[a.dtype], a.data_ptr(),
            b.data_ptr(), b.shape[0], g.data_ptr(), h, scale.data_ptr(),
            compact.row_ptr.data_ptr(), compact.src_row.data_ptr(),
            compact.slot.data_ptr(), out_rows, out.data_ptr(), stream))
        return out
    m = torch.empty_like(out) if with_m else None
    _raise_on(lib, entry, lib.relu_pair_rows_launch(
        dev.index or 0, _DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(),
        b.shape[0], h, scale.data_ptr(), compact.row_ptr.data_ptr(),
        compact.src_row.data_ptr(), compact.slot.data_ptr(), out_rows,
        out.data_ptr(), None if m is None else m.data_ptr(), stream))
    return (out, m) if with_m else out


def _launch_da_rows(a, b, g, scale, compact: SlotRows, rows_a: int):
    """Launch B5's row owner on the current stream over the backward plan's
    compact form (into A's first ``rows_a`` rows from B's and g's rows):
    f32 [rows_a, H], every element stored once."""
    lib = _library()
    entry = "relu_pair_da_rows_launch"
    h = _check_tables(entry, a, b, scale)
    _check_g(entry, g, b.shape[0], h, a.device)
    if rows_a > a.shape[0]:
        raise ValueError(f"{entry}: {rows_a} output rows from a "
                         f"[{a.shape[0]}]-row A")
    _check_compact(entry, compact, b, b.shape[0], rows_a, scale)
    dev = a.device
    out = torch.empty((rows_a, h), dtype=torch.float32, device=dev)
    _raise_on(lib, entry, lib.relu_pair_da_rows_launch(
        dev.index or 0, _DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(),
        g.data_ptr(), h, scale.data_ptr(), compact.row_ptr.data_ptr(),
        compact.src_row.data_ptr(), compact.slot.data_ptr(), rows_a,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream))
    return out


def _device_type(name: str, a) -> str:
    if a.device.type not in ("cpu", "cuda"):
        raise TypeError(f"{name}: unsupported device {a.device}")
    return a.device.type


def relu_pair_fwd(a, b, scale, rel_src, rel_tgt, src_blk, grp_tgt,
                  out_rows: int, compact: Optional[SlotRows] = None):
    """B6, the eval forward: f32 [out_rows, H] R over the forward plan.
    ``a`` [rows_a, H] and ``b`` [rows_b, H] share the stream dtype (f32 or
    bf16); ``scale`` is f32, one value per slot. On the card it reads only
    the plan's ``compact`` form (``MergedPlan.fwd_rows(out_rows, rows of
    a)``, B4's) and the scales; on the CPU the plain version reads the plan
    arrays."""
    if _device_type("relu_pair_fwd", a) == "cpu":
        return relu_pair_fwd_plain(a, b, scale, rel_src, rel_tgt, src_blk,
                                   grp_tgt, out_rows)
    _require_compact("relu_pair_fwd", compact)
    out = _launch_fwd_rows(a, b, scale, compact, out_rows, with_m=False)
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
    out = _launch_fwd_rows(a, b, scale, compact, out_rows, with_m=True)
    LAUNCHES["relu_pair_fwd_m"] += 1
    return out


def relu_pair_da(a, b, g, scale_bwd, rel_src, rel_tgt, src_blk, grp_tgt,
                 rows_a: int, compact: Optional[SlotRows] = None):
    """B5, the backward's dA over the backward plan: f32 [rows_a, H].
    ``g`` is the f32 cotangent [rows_b, H]. On the card it reads only the
    backward plan's ``compact`` form (``MergedPlan.bwd_rows(rows_a,
    rows_b)``, by A's row, each entry with its target clipped into B) and
    the scales; on the CPU the plain version reads the plan arrays."""
    if _device_type("relu_pair_da", a) == "cpu":
        return relu_pair_da_plain(a, b, g, scale_bwd, rel_src, rel_tgt,
                                  src_blk, grp_tgt, rows_a)
    _require_compact("relu_pair_da", compact)
    out = _launch_da_rows(a, b, g, scale_bwd, compact, rows_a)
    LAUNCHES["relu_pair_da"] += 1
    return out


def relu_pair_db(a, b, g, scale, rel_src, rel_tgt, src_blk, grp_tgt,
                 out_rows: int, compact: Optional[SlotRows] = None):
    """B7, dB recomputed over the forward plan: f32 [out_rows, H]
    ``g * M`` (``g`` the f32 cotangent [out_rows, H]). No call path runs
    it: the training forward's M gives dB directly. On the card it reads
    only the plan's ``compact`` form (``MergedPlan.fwd_rows(out_rows, rows
    of a)``, B4's), the scales and g; on the CPU the plain version reads
    the plan arrays."""
    if _device_type("relu_pair_db", a) == "cpu":
        return relu_pair_db_plain(a, b, g, scale, rel_src, rel_tgt, src_blk,
                                  grp_tgt, out_rows)
    _require_compact("relu_pair_db", compact)
    out = _launch_fwd_rows(a, b, scale, compact, out_rows, g=g)
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
    the forward plan's compact form (R and the mask sum M, saved), backward
    ``dB = M * g`` in plain torch and ``dA`` through B5 over the backward
    plan's, plus the overflow edges in plain torch.

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
        d_a = relu_pair_da(a_s, b_s, g, scale_bwd, *plan.bwd, rows_a,
                           compact=plan.bwd_rows(rows_a, b_s.shape[0]))
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
    out = relu_pair_fwd(a_s, b_s, scale_fwd, *plan.fwd, out_rows,
                        compact=plan.fwd_rows(out_rows, a_s.shape[0]))
    if plan.ovf_src.shape[0]:
        out = out + _overflow_sum(a_s, b_s, plan, ovf_scale, out_rows)
    return out
