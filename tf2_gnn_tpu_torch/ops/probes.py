"""The three design probes of the JAX repo's ``benchmarks/`` (its
``pair_probe.py`` and ``dyngather_probe.py``), ported as kernels with their
plan builders; the probes' timing harness is not ported.

* P2, ``pair_spmm_chunked`` (the probe's ``pair_spmm``): the block-pair
  SpMM ``out[tgt] += scale * table[src]`` over the plan of
  ``plan_block_pairs``, one chunk of 128 slots a grid step;
* P1, ``pair_spmm_unrolled``: the same over the plan regrouped by
  ``regroup_for_unroll`` so that ``group`` chunks sharing one target block
  run in one grid step.

Both are B3's function on B3's own plan encoding (``rel_src``/``rel_tgt``
[C, 128] with sentinel 128, ``src_blk`` [C], the group's target block
``grp_tgt = tgt_blk[::group]``), so both launch B3's kernel
(``csrc/pair_stream.cu::row_owner_kernel``) through ``pair_spmm`` over
the plan's compact form (``ProbePlan.fwd_rows``), whatever the group: 1
for P2, 8 for P1. The plan's f32 scale row is the kernel's scale; the TPU
probes round ``onehot * scale`` and each (row, row)
pair sum to bf16 before their products, which is exact for the unit
scales and multiplicities below 256 that the planner emits. The plain
version is ``pair_spmm_plain``.

* P3, ``dyngather`` (``dyngather_probe.py``'s kernel): ``out[r, c] = sum
  over s < reps of f32(table[(idx[r, c] + s) % R, c])``, a per-lane
  dynamic row gather summed over shifted index sets, in a hand-written
  CUDA kernel (``csrc/dyngather.cu``). The probe gathers from a table held
  on the chip (VMEM); the kernel's shared form stages each block's strip
  of ``strip_cols`` columns in shared memory and gathers from there, and a
  table whose one-column strip exceeds a block's shared memory takes its
  global form (``dyngather_form``). The probe adds into an output it
  never zeroes; here the sum starts from zero. The plain version
  (``dyngather_plain``) is one ``torch.gather`` a shift, summed in f32 in
  shift order.

Each wrapper takes the plain version on a CPU tensor and launches the
kernel on a CUDA tensor, or raises.
"""
import ctypes
import dataclasses
from typing import Dict

import numpy as np
import torch

from ..utils.device import as_tensor
from .pair_edge_mlp import _device_type
from .pair_spmm import (
    BLK,
    E_C,
    _DTYPE_CODES,
    SlotRows,
    pair_spmm,
    plan_group,
    slot_rows,
)

# Launch counts of the CUDA kernels of this module: the wrapper adds one
# where it launches its kernel, and nowhere else. P1 and P2 launch B3's
# kernel and count under ``pair_spmm.LAUNCHES["pair_spmm"]``.
LAUNCHES = {"dyngather": 0}

_SOURCE = "dyngather.cu"
_SIGNATURES = {
    "dyngather_launch": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]),
    "dyngather_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}

# P3's shared form: the columns of the table a block stages in shared
# memory (16 bytes of each row), and the shared memory a block of an H100
# may take (227 KB, with the kernel's opt-in attribute).
STRIP_COLS = {torch.float32: 4, torch.bfloat16: 8}
MAX_STRIP_BYTES = 232448


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Host half: the probes' plans (numpy, the probe's layout array for array)


def plan_block_pairs(src, tgt, num_rows: int, num_nodes: int):
    """Sort edges by (target block, source block, source); pad each pair's
    edges to chunks of ``E_C`` slots and the chunk count to a multiple of
    8. Returns (rel_src [C, E_C], rel_tgt [C, E_C], scale [C, E_C],
    src_blk [C], tgt_blk [C]) with sentinel ``BLK`` and scale 0 on padding
    slots; padding chunks repeat the last real chunk's blocks."""
    del num_nodes  # the probe's signature; the targets bound it
    src = np.asarray(src, np.int64)
    tgt = np.asarray(tgt, np.int64)
    sb, tb = src // BLK, tgt // BLK
    order = np.lexsort((src, sb, tb))
    src, tgt, sb, tb = src[order], tgt[order], sb[order], tb[order]
    pair = tb * (num_rows // BLK) + sb
    change = np.flatnonzero(np.diff(pair)) + 1
    starts = np.concatenate(([0], change))
    counts = np.diff(np.concatenate((starts, [pair.shape[0]])))
    chunks_per_pair = np.maximum((counts + E_C - 1) // E_C, 1)
    chunk_of_pair_start = np.concatenate(([0], np.cumsum(chunks_per_pair)))
    num_chunks = int(chunk_of_pair_start[-1])
    num_chunks_pad = ((num_chunks + 7) // 8) * 8

    offs = np.arange(pair.shape[0]) - np.repeat(starts, counts)
    slot = np.repeat(chunk_of_pair_start[:-1], counts) * E_C + offs

    rel_src = np.full((num_chunks_pad * E_C,), BLK, np.int32)
    rel_tgt = np.full((num_chunks_pad * E_C,), BLK, np.int32)
    scale = np.zeros((num_chunks_pad * E_C,), np.float32)
    rel_src[slot] = src - sb * BLK
    rel_tgt[slot] = tgt - tb * BLK
    scale[slot] = 1.0

    src_blk = np.zeros((num_chunks_pad,), np.int32)
    tgt_blk = np.zeros((num_chunks_pad,), np.int32)
    chunk_pair = np.repeat(np.arange(starts.shape[0]), chunks_per_pair)
    src_blk[:num_chunks] = sb[starts][chunk_pair]
    tgt_blk[:num_chunks] = tb[starts][chunk_pair]
    if num_chunks:
        tgt_blk[num_chunks:] = tgt_blk[num_chunks - 1]
        src_blk[num_chunks:] = src_blk[num_chunks - 1]
    return (rel_src.reshape(num_chunks_pad, E_C),
            rel_tgt.reshape(num_chunks_pad, E_C),
            scale.reshape(num_chunks_pad, E_C), src_blk, tgt_blk)


def regroup_for_unroll(rel_src, rel_tgt, scale, src_blk, tgt_blk,
                       group: int = 8):
    """Pad the chunk stream so that no group of ``group`` chunks spans a
    change of target block. Returns (rel_src, rel_tgt, scale, src_blk,
    tgt_blk, grp_tgt) with the chunk count a multiple of ``group`` and
    ``grp_tgt`` each group's target block."""
    n = rel_src.shape[0]
    run_change = np.flatnonzero(np.diff(tgt_blk)) + 1
    bounds = np.concatenate(([0], run_change, [n])) if n else np.zeros(1, int)
    out_rs, out_rt, out_sc, out_sb, out_tb = [], [], [], [], []
    for s, e in zip(bounds[:-1], bounds[1:]):
        pad = (-(e - s)) % group
        out_rs.append(rel_src[s:e])
        out_rt.append(rel_tgt[s:e])
        out_sc.append(scale[s:e])
        out_sb.append(src_blk[s:e])
        out_tb.append(tgt_blk[s:e])
        if pad:
            out_rs.append(np.full((pad, E_C), BLK, np.int32))
            out_rt.append(np.full((pad, E_C), BLK, np.int32))
            out_sc.append(np.zeros((pad, E_C), np.float32))
            out_sb.append(np.zeros((pad,), np.int32))
            out_tb.append(np.full((pad,), tgt_blk[s], np.int32))
    rel_src = np.concatenate(out_rs)
    rel_tgt = np.concatenate(out_rt)
    scale = np.concatenate(out_sc)
    src_blk = np.concatenate(out_sb)
    tgt_blk = np.concatenate(out_tb)
    return rel_src, rel_tgt, scale, src_blk, tgt_blk, tgt_blk[::group].copy()


@dataclasses.dataclass(frozen=True)
class ProbePlan:
    """A probe's plan as B3's kernel reads it: ``rel_src``/``rel_tgt``
    [C, E_C], the f32 ``scale`` [C, E_C], ``src_blk`` [C] and the groups'
    target blocks ``grp_tgt`` [C // group]. Its compact forms
    (``fwd_rows``) are built at their first read and kept (a moved plan
    starts without them)."""

    rel_src: object
    rel_tgt: object
    scale: object
    src_blk: object
    grp_tgt: object
    _rows: Dict[tuple, SlotRows] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def group(self) -> int:
        return plan_group(self.src_blk, self.grp_tgt)

    def to(self, device) -> "ProbePlan":
        return dataclasses.replace(self, **{
            f.name: as_tensor(getattr(self, f.name), device)
            for f in dataclasses.fields(self) if f.init})

    @property
    def kernel_args(self) -> tuple:
        """(scale row, rel_src, rel_tgt, src_blk, grp_tgt): the plan
        arguments of ``pair_spmm`` / ``pair_spmm_plain``."""
        return (self.scale.reshape(-1), self.rel_src, self.rel_tgt,
                self.src_blk, self.grp_tgt)

    def fwd_rows(self, out_rows: int, table_rows: int) -> SlotRows:
        """The plan's compact form (``slot_rows``), which B3's kernel
        reads."""
        key = (out_rows, table_rows)
        if key not in self._rows:
            self._rows[key] = slot_rows(*self.kernel_args[1:], table_rows,
                                        out_rows)
        return self._rows[key]


def chunked_plan(src, tgt, num_rows: int, num_nodes: int) -> ProbePlan:
    """P2's plan: ``plan_block_pairs``, one chunk a group."""
    rel_src, rel_tgt, scale, src_blk, tgt_blk = plan_block_pairs(
        src, tgt, num_rows, num_nodes)
    return ProbePlan(rel_src, rel_tgt, scale, src_blk, tgt_blk)


def unrolled_plan(src, tgt, num_rows: int, num_nodes: int,
                  group: int = 8) -> ProbePlan:
    """P1's plan: ``plan_block_pairs`` regrouped by ``regroup_for_unroll``
    into groups of ``group`` chunks."""
    rel_src, rel_tgt, scale, src_blk, _, grp_tgt = regroup_for_unroll(
        *plan_block_pairs(src, tgt, num_rows, num_nodes), group=group)
    return ProbePlan(rel_src, rel_tgt, scale, src_blk, grp_tgt)


# ---------------------------------------------------------------------------
# Device half: P1 and P2 through B3's kernel, P3's kernel


def pair_spmm_chunked(table, plan: ProbePlan, num_nodes: int):
    """P2: f32 [num_nodes, H] ``out[tgt] += scale * table[src]`` over a
    one-chunk-a-group plan (``chunked_plan``), through B3's kernel."""
    if plan.group != 1:
        raise ValueError(f"pair_spmm_chunked: plan has {plan.group} chunks "
                         "a group, expected 1")
    return pair_spmm(table, *plan.kernel_args, num_nodes,
                     compact=plan.fwd_rows(num_nodes, table.shape[0]))


def pair_spmm_unrolled(table, plan: ProbePlan, num_nodes: int,
                       group: int = 8):
    """P1: the same over a plan of ``group`` chunks a group
    (``unrolled_plan``), through B3's kernel."""
    if plan.group != group:
        raise ValueError(f"pair_spmm_unrolled: plan has {plan.group} chunks "
                         f"a group, expected {group}")
    return pair_spmm(table, *plan.kernel_args, num_nodes,
                     compact=plan.fwd_rows(num_nodes, table.shape[0]))


def dyngather_plain(table, idx, reps: int):
    """Plain PyTorch version of P3: one ``torch.gather`` a shift, summed in
    f32 in shift order from zero."""
    rows = table.shape[0]
    idx = idx.long()
    out = torch.zeros(table.shape, dtype=torch.float32, device=table.device)
    for s in range(reps):
        out += torch.gather(table, 0, (idx + s) % rows).float()
    return out


def strip_cols(rows: int, cols: int, dtype) -> int:
    """The columns a block of P3's shared form stages: ``STRIP_COLS``,
    halved while half of them still covers ``cols`` or the strip (``rows``
    of them) exceeds ``MAX_STRIP_BYTES``; 0, the global form, where one
    column does not fit."""
    width = STRIP_COLS[dtype]
    while width > 1 and (width // 2 >= cols or
                         rows * width * dtype.itemsize > MAX_STRIP_BYTES):
        width //= 2
    return width if rows * width * dtype.itemsize <= MAX_STRIP_BYTES else 0


def dyngather_form(rows: int, cols: int, dtype) -> str:
    """The form of P3's kernel that a [rows, cols] table of ``dtype``
    takes: ``"shared"`` (a gather from a column strip held in shared
    memory) or ``"global"`` (a gather from global memory)."""
    return "shared" if strip_cols(rows, cols, dtype) else "global"


def dyngather(table, idx, reps: int):
    """P3: f32 [R, C] ``out[r, c] = sum over s < reps of
    f32(table[(idx[r, c] + s) % R, c])``; ``table`` [R, C] f32 or bf16,
    ``idx`` int32 [R, C]. On the card the kernel's form is
    ``dyngather_form``'s."""
    if _device_type("dyngather", table) == "cpu":
        return dyngather_plain(table, idx, reps)
    from .cuda_build import load_library

    lib = load_library(_SOURCE, _SIGNATURES)
    if table.dtype not in _DTYPE_CODES:
        raise TypeError(f"dyngather: table must be float32 or bfloat16, got "
                        f"{table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("dyngather: table must be a contiguous 2-D tensor")
    if (idx.dtype != torch.int32 or not idx.is_contiguous()
            or idx.shape != table.shape or idx.device != table.device):
        raise TypeError("dyngather: idx must be a contiguous int32 tensor of "
                        "the table's shape on its device")
    rows, cols = table.shape
    out = torch.empty((rows, cols), dtype=torch.float32, device=table.device)
    err = lib.dyngather_launch(
        table.device.index or 0, _DTYPE_CODES[table.dtype], table.data_ptr(),
        rows, cols, idx.data_ptr(), reps,
        strip_cols(rows, cols, table.dtype), out.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream)
    if err != 0:
        msg = lib.dyngather_error_string(err).decode()
        raise RuntimeError(f"dyngather failed: CUDA error {err} ({msg})")
    LAUNCHES["dyngather"] += 1
    return out
