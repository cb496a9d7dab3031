"""Block-pair streamed SpMM for ``out[v] = sum over edges e=(u -> v) of
scale_e * table[src_e]`` (port of ``tf2_gnn_tpu/ops/pair_spmm.py``).

Host half (the JAX package's layout byte for byte): the planner sorts real
edges by (target block, source block), pads each pair's edges into chunks
of ``E_C`` slots, aligns output-block runs to the plan's grid ``group`` and
spills what does not fit a chunk budget into a small overflow list. The
port's C++ engine (``native/graphpack.cc``) plans a direction and counts
its chunks where the JAX package's does; the numpy planner is its plain
version and the spill path. ``concat_typed_plans`` concatenates per-type
plans into the streamed single-launch layout.

Device half: ``pair_stream_joint`` is a ``torch.autograd.Function`` whose
forward runs the joint SpMM (K2, ``pair_spmm_stream_joint``) and whose
backward runs the stream SpMM (K1, ``pair_spmm_stream``) over the backward
plan. ``pair_stream_typed`` gives the per-type aggregates instead, with
K1 in both directions (``StreamTypedPlan``: global forward output blocks
and the backward plan's real types). ``pair_spmm`` (B3) is the same SpMM
over one direction of a merged plan (``MergedPlan``); RGAT's head-major
sums run it once per head, and ``pair_typed_gather_scatter`` (the
edge-MLP family on merged plans) once in each direction. All three launch one hand-written CUDA kernel (``csrc/pair_stream.cu``'s
``row_owner_kernel``), which reads the plan direction's compact form
(``slot_rows``: its valid slots as a CSR over output rows); each plan
object builds it at first read and keeps it, so it is built once per
batch. Each wrapper runs its plain PyTorch version (over the plan arrays)
on a CPU tensor and launches the kernel on a CUDA tensor, or raises; there
is no fallback between the two. ``launch_head_rows`` launches the kernel's
per-head twin (``head_rows_kernel``) for the attention sums B10
(``pair_attention.py``) and B14 (``sorted_spmm.py``).
"""
import ctypes
import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..utils.constants import SMALL_NUMBER
from ..utils.device import as_tensor
from ..utils.shapes import round_up as _round_up

BLK = 128    # rows per node block
E_C = 128    # edge slots per chunk (one (tgt_block, src_block) pair each)
GROUP = 16   # chunks per group in the forward plan (all share one target block)
# The BACKWARD plan uses a smaller group: its output blocks are merged
# source rows, whose runs are shorter than the forward plan's target runs,
# so GROUP-16 run alignment would pad it ~2x. Each plan's group is encoded
# by its array shapes (src_blk.size // grp_tgt.size).
BWD_GROUP = 8
# Feature tile of the JAX package's Pallas kernels (the TPU's 128 lanes).
# The CUDA kernels mask the ragged feature edge and need no padding; the
# constant is kept for layout parity with the reference.
TILE = 128


# ---------------------------------------------------------------------------
# Host half: plans (numpy)


class PairPlan(NamedTuple):
    """Host-built plan for one direction.

    ``rel_*`` use sentinel ``BLK`` on padded slots; ``src_blk``/``grp_tgt``
    address table/output blocks per chunk/group. Absolute slot ids:
    ``srcabs = src_blk[slot // E_C] * BLK + rel_src`` (invalid where
    ``rel_src >= BLK``), likewise for targets via ``grp_tgt``.
    """

    rel_src: np.ndarray    # int32 [C, E_C]
    rel_tgt: np.ndarray    # int32 [C, E_C]
    src_blk: np.ndarray    # int32 [C]
    grp_tgt: np.ndarray    # int32 [C // group]; group = C // grp_tgt.size


def plan_group(src_blk, grp_tgt) -> int:
    """Chunks per group of a plan, encoded by its array shapes."""
    return src_blk.shape[0] // grp_tgt.shape[0]


class PairPlans(NamedTuple):
    """Forward + backward plans + overflow edges + per-slot 1/deg scales
    (``inv_*``, precomputed on the host; slots without a real edge carry
    scale 0)."""

    fwd: PairPlan          # out rows = num_nodes (scatter by target)
    bwd: PairPlan          # out rows = table rows (gradient scatter by source)
    ovf_src: np.ndarray    # int32 [OVF] merged source row ids (sentinel 0)
    ovf_tgt: np.ndarray    # int32 [OVF] target ids (sentinel num_nodes)
    inv_fwd: np.ndarray    # f32 [C_f * E_C] 1/deg scale per forward slot
    inv_bwd: np.ndarray    # f32 [C_b * E_C] 1/deg scale per backward slot
    inv_ovf: np.ndarray    # f32 [OVF] 1/deg scale per overflow slot

    def astuple(self) -> Tuple[np.ndarray, ...]:
        return (tuple(self.fwd) + tuple(self.bwd)
                + (self.ovf_src, self.ovf_tgt,
                   self.inv_fwd, self.inv_bwd, self.inv_ovf))

    @classmethod
    def fromtuple(cls, arrays) -> "PairPlans":
        return cls(
            PairPlan(*arrays[0:4]), PairPlan(*arrays[4:8]),
            arrays[8], arrays[9], arrays[10], arrays[11], arrays[12],
        )

    @property
    def kernel_arrays(self) -> Tuple[np.ndarray, ...]:
        """The 10 plan arrays the merged-plan ops read: both directions and
        the overflow edges."""
        return tuple(self.fwd) + tuple(self.bwd) + (self.ovf_src, self.ovf_tgt)


def _plan_one_direction(
    src: np.ndarray, tgt: np.ndarray, chunk_budget: Optional[int],
    group: int = GROUP,
) -> Tuple[PairPlan, np.ndarray, np.ndarray]:
    """Pair-chunk one direction. ``chunk_budget=None`` sizes the plan to the
    data. Returns (plan, overflow_edge_mask, edge_slot): the mask marks input
    edges that did not fit the chunk budget (smallest pairs spill first) and
    ``edge_slot[i]`` is input edge i's slot (-1 when spilled). ``group``
    chunks share one target block (runs pad to a multiple of it);
    ``chunk_budget`` must divide by it.

    With a budget, the C++ planner (``native.pair_plan``) plans the edges
    (the same layout); where they overflow the budget, the numpy planner,
    the only one that spills, plans them again (the JAX package's one
    fall-through). ``native.PLANNED`` counts which one planned.
    """
    n = src.shape[0]
    if n and chunk_budget is not None and chunk_budget % group == 0:
        if not native.binding_on():
            native.PLANNED["pair numpy"] += 1
            return _plan_one_direction_numpy(src, tgt, chunk_budget, group)
        used, rel_s, rel_t, src_blk, tgt_blk, edge_slot = native.pair_plan(
            src, tgt, chunk_budget, group, BLK, E_C)
        if used >= 0:
            native.PLANNED["pair binding"] += 1
            plan = PairPlan(rel_s.reshape(chunk_budget, E_C),
                            rel_t.reshape(chunk_budget, E_C),
                            src_blk, tgt_blk[::group].copy())
            return plan, np.zeros((n,), bool), edge_slot
        native.PLANNED["pair numpy spill"] += 1
    return _plan_one_direction_numpy(src, tgt, chunk_budget, group)


def _plan_one_direction_numpy(
    src: np.ndarray, tgt: np.ndarray, chunk_budget: Optional[int],
    group: int = GROUP,
) -> Tuple[PairPlan, np.ndarray, np.ndarray]:
    """``_plan_one_direction``'s numpy form: the plain version of the C++
    planner, and its spill path."""
    n = src.shape[0]
    overflow_mask = np.zeros((n,), bool)
    edge_slot = np.full((n,), -1, np.int64)
    if chunk_budget is not None and chunk_budget % group:
        raise ValueError(
            f"pair chunk budget {chunk_budget} not a multiple of {group}")

    if n == 0:
        chunk_budget = chunk_budget or group
        num_groups = chunk_budget // group
        rel = np.full((chunk_budget, E_C), BLK, np.int32)
        plan = PairPlan(rel, rel.copy(),
                        np.zeros((chunk_budget,), np.int32),
                        np.zeros((num_groups,), np.int32))
        return plan, overflow_mask, edge_slot

    sb = src // BLK
    tb = tgt // BLK
    order = np.lexsort((sb, tb))
    s_src, s_tgt, s_sb, s_tb = src[order], tgt[order], sb[order], tb[order]
    pair = s_tb.astype(np.int64) * (int(sb.max()) + 2) + s_sb
    change = np.flatnonzero(np.diff(pair)) + 1
    starts = np.concatenate(([0], change))
    counts = np.diff(np.concatenate((starts, [n])))
    keep_pair = np.ones(starts.shape[0], bool)

    def grouping(keep):
        """Per-kept-pair chunk starts with tgt-run group alignment."""
        p_tb = s_tb[starts[keep]]
        p_chunks = (counts[keep] + E_C - 1) // E_C
        run_change = np.flatnonzero(np.diff(p_tb)) + 1
        run_starts = np.concatenate(([0], run_change))
        run_ends = np.concatenate((run_change, [p_tb.shape[0]]))
        csum = np.concatenate(([0], np.cumsum(p_chunks)))
        run_sizes = csum[run_ends] - csum[run_starts]
        run_padded = ((run_sizes + group - 1) // group) * group
        run_base = np.concatenate(([0], np.cumsum(run_padded)))[:-1]
        pair_run = np.repeat(np.arange(run_starts.shape[0]),
                             run_ends - run_starts)
        pair_off = csum[:-1] - csum[run_starts][pair_run]
        chunk_start = run_base[pair_run] + pair_off
        total = int(run_base[-1] + run_padded[-1]) if run_padded.size else 0
        return chunk_start, p_chunks, total

    chunk_start, p_chunks, total = grouping(keep_pair)
    if chunk_budget is None:
        chunk_budget = max(total, group)
    if total > chunk_budget:
        # Spill smallest pairs (least dense) until fit, dropping batches of
        # pairs per re-grouping pass.
        by_size = list(np.argsort(counts, kind="stable"))
        while total > chunk_budget and by_size:
            need = total - chunk_budget
            acc = 0
            while by_size and acc < need:
                idx = by_size.pop(0)
                if keep_pair[idx]:
                    keep_pair[idx] = False
                    acc += int((counts[idx] + E_C - 1) // E_C)
            chunk_start, p_chunks, total = grouping(keep_pair)
        if total > chunk_budget:  # pragma: no cover - all pairs spilled
            keep_pair[:] = False
            total = 0

    rel_src = np.full((chunk_budget * E_C,), BLK, np.int32)
    rel_tgt = np.full((chunk_budget * E_C,), BLK, np.int32)
    src_blk = np.zeros((chunk_budget,), np.int32)
    tgt_blk = np.zeros((chunk_budget,), np.int32)

    kept_idx = np.flatnonzero(keep_pair)
    if kept_idx.size:
        kept_edge = np.repeat(keep_pair, counts)
        e_counts = counts[kept_idx]
        offs = (np.arange(n) - np.repeat(starts, counts))[kept_edge]
        slot = np.repeat(chunk_start, e_counts) * E_C + offs
        rel_src[slot] = (s_src - s_sb * BLK)[kept_edge]
        rel_tgt[slot] = (s_tgt - s_tb * BLK)[kept_edge]
        edge_slot[order[kept_edge]] = slot
        chunk_pair = np.full((chunk_budget,), -1, np.int64)
        tot = int(p_chunks.sum())
        pair_of_chunk = np.repeat(np.arange(kept_idx.shape[0]), p_chunks)
        csum_pc = np.concatenate(([0], np.cumsum(p_chunks)))[:-1]
        ch_idx = (np.repeat(chunk_start, p_chunks)
                  + np.arange(tot) - np.repeat(csum_pc, p_chunks))
        chunk_pair[ch_idx] = pair_of_chunk
        have = chunk_pair >= 0
        src_blk[have] = s_sb[starts[kept_idx]][chunk_pair[have]]
        tgt_blk[have] = s_tb[starts[kept_idx]][chunk_pair[have]]
        # Padding chunks inherit a non-decreasing tgt block and the previous
        # real chunk's src block (the reference layout, kept byte for byte).
        if not have.all():
            fill = np.maximum.accumulate(np.where(have, tgt_blk, 0))
            tgt_blk[~have] = fill[~have]
            last_real = np.maximum.accumulate(
                np.where(have, np.arange(chunk_budget), 0))
            src_blk[~have] = src_blk[last_real[~have]]
    if not keep_pair.all():
        spilled_edge_sorted = np.repeat(~keep_pair, counts)
        overflow_mask[order[spilled_edge_sorted]] = True

    plan = PairPlan(
        rel_src.reshape(chunk_budget, E_C),
        rel_tgt.reshape(chunk_budget, E_C),
        src_blk,
        tgt_blk[::group].copy(),
    )
    return plan, overflow_mask, edge_slot


def _host_inv_degree_scales(fwd_slots: int, edge_slot_fwd,
                            bwd_slots: int, edge_slot_bwd,
                            ovf_src, ovf_tgt,
                            all_src, all_tgt, v: int, src_space: int,
                            num_types: int, merge_targets: bool = False):
    """Per-slot 1/(per-type in-degree + eps) for fwd/bwd/overflow slots
    (reference gnn_edge_mlp.py:102-106): deg_l(t) counts real edges of type
    l into t. Padded slots keep 0."""
    if all_src.size:
        if merge_targets:
            idx = all_tgt
        else:
            idx = (all_src // src_space) * v + all_tgt
        deg = np.bincount(idx, minlength=num_types * v).astype(np.float32)
        inv_edge = (1.0 / (deg + SMALL_NUMBER)).astype(np.float32)[idx]
    else:
        deg = np.zeros((num_types * v,), np.float32)
        inv_edge = np.zeros((0,), np.float32)

    inv_fwd = np.zeros((fwd_slots,), np.float32)
    m = edge_slot_fwd >= 0
    inv_fwd[edge_slot_fwd[m]] = inv_edge[m]
    inv_bwd = np.zeros((bwd_slots,), np.float32)
    m = edge_slot_bwd >= 0
    inv_bwd[edge_slot_bwd[m]] = inv_edge[m]

    out_rows = num_types * v if merge_targets else v
    inv = (1.0 / (deg + SMALL_NUMBER)).astype(np.float32)
    top = inv.shape[0] - 1
    ovf_valid = ovf_tgt < out_rows
    if merge_targets:
        ovf_idx = np.minimum(ovf_tgt, top)
    else:
        ovf_l = ovf_src.astype(np.int64) // src_space
        ovf_idx = np.minimum(ovf_l * v + np.minimum(ovf_tgt, v - 1), top)
    inv_ovf = (inv[ovf_idx] * ovf_valid).astype(np.float32)
    return inv_fwd, inv_bwd, inv_ovf


def _merged_edges(sources_per_type, targets_per_type, counts_per_type,
                  v: int, src_space: int, merge_targets: bool):
    srcs, tgts = [], []
    for l in range(len(sources_per_type)):
        c = int(counts_per_type[l])
        srcs.append(np.asarray(sources_per_type[l][:c], np.int64)
                    + l * src_space)
        tgts.append(np.asarray(targets_per_type[l][:c], np.int64)
                    + (l * v if merge_targets else 0))
    all_src = np.concatenate(srcs) if srcs else np.zeros((0,), np.int64)
    all_tgt = np.concatenate(tgts) if tgts else np.zeros((0,), np.int64)
    return all_src, all_tgt


def build_pair_plans(
    sources_per_type,
    targets_per_type,
    counts_per_type,
    num_nodes_padded: int,
    src_space: int = None,
    chunk_budget_fwd: int = None,
    chunk_budget_bwd: int = None,
    overflow_budget: int = 2048,
    merge_targets: bool = False,
    overflow_size: int = None,
    group_fwd: int = None,
    group_bwd: int = None,
) -> PairPlans:
    """Build forward+backward pair plans over ALL edge types of a batch.

    Sources are merged into the stacked row space ``l * src_space + u``
    (matching the [L*V, H] node tables). ``merge_targets=True`` puts targets
    in the merged space ``l * V + t`` as well (per-type aggregates).
    """
    v = num_nodes_padded
    if src_space is None:
        src_space = v
    group_fwd = GROUP if group_fwd is None else group_fwd
    group_bwd = BWD_GROUP if group_bwd is None else group_bwd
    num_types = len(sources_per_type)
    out_rows = num_types * v if merge_targets else v
    all_src, all_tgt = _merged_edges(sources_per_type, targets_per_type,
                                     counts_per_type, v, src_space,
                                     merge_targets)

    fwd, ovf_f, slot_f = _plan_one_direction(all_src, all_tgt,
                                             chunk_budget_fwd,
                                             group=group_fwd)
    bwd, ovf_b, slot_b = _plan_one_direction(all_tgt, all_src,
                                             chunk_budget_bwd,
                                             group=group_bwd)
    ovf = ovf_f | ovf_b  # an edge must take the same path in fwd and bwd
    if ovf.any():
        # Re-plan excluding ALL overflow edges so fwd/bwd stay consistent
        # (shapes fixed by the first pass).
        keep = ~ovf
        fwd, extra_f, sf_k = _plan_one_direction(all_src[keep],
                                                 all_tgt[keep],
                                                 fwd.rel_src.shape[0],
                                                 group=group_fwd)
        bwd, extra_b, sb_k = _plan_one_direction(all_tgt[keep],
                                                 all_src[keep],
                                                 bwd.rel_src.shape[0],
                                                 group=group_bwd)
        if extra_f.any() or extra_b.any():  # pragma: no cover
            raise AssertionError("pair plan did not converge")
        slot_f = np.full(all_src.shape, -1, np.int64)
        slot_b = np.full(all_src.shape, -1, np.int64)
        slot_f[keep] = sf_k
        slot_b[keep] = sb_k
    num_overflow = int(ovf.sum())
    if num_overflow > overflow_budget:
        raise ValueError(
            f"{num_overflow} edges spilled the pair-chunk budget "
            f"(fwd {chunk_budget_fwd} / bwd {chunk_budget_bwd}) but the "
            f"overflow budget is {overflow_budget}."
        )
    # Overflow arrays are sized by the real spill (zero-size skips the
    # overflow term); callers needing a fixed shape pass overflow_size.
    ovf_slots = (_round_up(num_overflow, 8) if num_overflow
                 else 0) if overflow_size is None else overflow_size
    if num_overflow > ovf_slots:
        raise ValueError(
            f"{num_overflow} spilled edges exceed overflow_size {ovf_slots}."
        )
    ovf_src = np.zeros((ovf_slots,), np.int32)
    ovf_tgt = np.full((ovf_slots,), out_rows, np.int32)  # discard row
    if num_overflow:
        ovf_src[:num_overflow] = all_src[ovf]
        ovf_tgt[:num_overflow] = all_tgt[ovf]
    inv_fwd, inv_bwd, inv_ovf = _host_inv_degree_scales(
        fwd.rel_src.size, slot_f, bwd.rel_src.size, slot_b,
        ovf_src, ovf_tgt, all_src, all_tgt, v, src_space, num_types,
        merge_targets,
    )
    return PairPlans(fwd, bwd, ovf_src, ovf_tgt, inv_fwd, inv_bwd, inv_ovf)


def measure_pair_chunks(
    sources_per_type, targets_per_type, counts_per_type,
    num_nodes_padded: int, src_space: int = None,
    merge_targets: bool = False,
    group_fwd: int = GROUP,
    group_bwd: int = BWD_GROUP,
) -> Tuple[int, int]:
    """Chunk counts both directions would need for this batch."""
    v = num_nodes_padded
    if src_space is None:
        src_space = v
    all_src, all_tgt = _merged_edges(sources_per_type, targets_per_type,
                                     counts_per_type, v, src_space,
                                     merge_targets)
    if native.binding_on():
        return (max(native.pair_plan_count(all_src, all_tgt, group_fwd,
                                           BLK, E_C), group_fwd),
                max(native.pair_plan_count(all_tgt, all_src, group_bwd,
                                           BLK, E_C), group_bwd))
    fwd, _, _ = _plan_one_direction_numpy(all_src, all_tgt, None,
                                          group=group_fwd)
    bwd, _, _ = _plan_one_direction_numpy(all_tgt, all_src, None,
                                          group=group_bwd)
    return fwd.rel_src.shape[0], bwd.rel_src.shape[0]


def choose_pair_groups(
    sources_per_type, targets_per_type, counts_per_type,
    num_nodes_padded: int, src_space: int = None,
    merge_targets: bool = False,
    candidates: Tuple[int, ...] = (8, 16),
) -> Tuple[int, int]:
    """Pick (group_fwd, group_bwd) by measured run statistics: cost =
    padded_chunks + 6 * groups (the reference's cost model, kept so the
    port's plans are the reference's)."""
    def cost_of(group, swap):
        f, b = measure_pair_chunks(
            sources_per_type, targets_per_type, counts_per_type,
            num_nodes_padded, src_space=src_space,
            merge_targets=merge_targets,
            group_fwd=group if not swap else GROUP,
            group_bwd=group if swap else BWD_GROUP,
        )
        chunks = b if swap else f
        return chunks + 6 * (chunks // group)

    best_f = min(candidates, key=lambda g: cost_of(g, swap=False))
    best_b = min(candidates, key=lambda g: cost_of(g, swap=True))
    return best_f, best_b


def concat_typed_plans(plans_typed, v_src: int, v_out: int,
                       normalize: bool):
    """Concatenate per-type ``PairPlans.astuple()`` tuples into the streamed
    layout (numpy): (scales, fwd arrays + grp_type, bwd arrays + grp_type,
    global overflow ids). Forward output blocks globalize to the stacked
    [L*Vo] target row space, backward output blocks to the stacked [L*Vs]
    source row space; per-slot scales are the host-precomputed ``inv_*``
    (normalize) or unit scales. All types must share each direction's
    group."""
    plans_typed = [tuple(np.asarray(a) for a in p) for p in plans_typed]
    num_types = len(plans_typed)
    gf = plan_group(plans_typed[0][2], plans_typed[0][3])
    gb = plan_group(plans_typed[0][6], plans_typed[0][7])
    for ty, p in enumerate(plans_typed[1:], start=1):
        got = (plan_group(p[2], p[3]), plan_group(p[6], p[7]))
        if got != (gf, gb):
            raise ValueError(
                f"concat_typed_plans: type {ty} plan groups {got} differ "
                f"from type 0's ({gf}, {gb}); build every per-type plan "
                "with one shared (group_fwd, group_bwd) config."
            )

    def cat(i):
        return np.concatenate([p[i] for p in plans_typed])

    def cat_groups(i, out_blocks):
        parts, types = [], []
        for ty, p in enumerate(plans_typed):
            parts.append((p[i] + ty * out_blocks).astype(np.int32))
            types.append(np.full(p[i].shape, ty, np.int32))
        return np.concatenate(parts), np.concatenate(types)

    grp_tgt_f, grp_type_f = cat_groups(3, v_out // BLK)
    grp_tgt_b, grp_type_b = cat_groups(7, v_src // BLK)

    ovf_srcs, ovf_tgts, ovf_scales = [], [], []
    for ty, p in enumerate(plans_typed):
        o_src, o_tgt = p[8], p[9]
        ovf_srcs.append((ty * v_src + o_src).astype(np.int32))
        # Per-type sentinel (== v_out) maps to the global discard row
        # L*Vo -- NOT ty*v_out + v_out, a real row of the next type.
        ovf_tgts.append(np.where(o_tgt >= v_out, num_types * v_out,
                                 ty * v_out + o_tgt).astype(np.int32))
        if normalize:
            ovf_scales.append(p[12])
        else:
            ovf_scales.append((o_tgt < v_out).astype(np.float32))
    if normalize:
        scale_fwd, scale_bwd = cat(10), cat(11)
    else:
        scale_fwd = np.ones((sum(p[0].size for p in plans_typed),),
                            np.float32)
        scale_bwd = np.ones((sum(p[4].size for p in plans_typed),),
                            np.float32)
    return (scale_fwd, scale_bwd, np.concatenate(ovf_scales),
            cat(0), cat(1), cat(2), grp_tgt_f, grp_type_f,
            cat(4), cat(5), cat(6), grp_tgt_b, grp_type_b,
            np.concatenate(ovf_srcs), np.concatenate(ovf_tgts))


class _DevicePlan:
    """A frozen dataclass of plan arrays (the fields typed ``object``)
    and sizes, which ``to`` moves."""

    def to(self, device):
        """Every array field as a tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: as_tensor(getattr(self, f.name), device)
            for f in dataclasses.fields(self) if f.type is object})


@dataclasses.dataclass(frozen=True)
class StreamJointPlan(_DevicePlan):
    """The operands of ``pair_stream_joint`` for one batch: the
    concatenated per-type plans with LOCAL forward output blocks and LOCAL
    overflow targets (sentinel ``v_out``), and the all-zero backward types
    (one un-broadcast [Vo, H] cotangent slab). Built once per batch on the
    host (``stream_joint_plan``) and moved with ``.to(device)``; each
    direction's compact form (``fwd_rows``, ``bwd_rows``) is built at its
    first read and kept (a moved plan starts without them)."""

    scale_fwd: object
    scale_bwd: object
    ovf_scale: object
    rel_src_f: object
    rel_tgt_f: object
    src_blk_f: object
    grp_tgt_fl: object
    grp_type_f: object
    rel_src_b: object
    rel_tgt_b: object
    src_blk_b: object
    grp_tgt_b: object
    type_b_zeros: object
    ovf_src: object
    ovf_tgt_l: object
    v_src: int
    v_out: int
    num_types: int
    _rows: Dict[object, "SlotRows"] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def fwd_rows(self) -> "SlotRows":
        """The forward direction's compact form, which K2 reads: sources in
        the stacked [L * v_src] table, targets in [v_out]."""
        if "fwd" not in self._rows:
            self._rows["fwd"] = slot_rows(
                self.rel_src_f, self.rel_tgt_f, self.src_blk_f,
                self.grp_tgt_fl, self.num_types * self.v_src, self.v_out,
                self.grp_type_f, self.v_src)
        return self._rows["fwd"]

    @property
    def bwd_rows(self) -> "SlotRows":
        """The backward direction's compact form, which K1 reads: sources
        in the one [v_out] cotangent slab (all-zero types), targets in the
        stacked [L * v_src] table rows."""
        if "bwd" not in self._rows:
            self._rows["bwd"] = slot_rows(
                self.rel_src_b, self.rel_tgt_b, self.src_blk_b,
                self.grp_tgt_b, self.v_out, self.num_types * self.v_src,
                self.type_b_zeros, self.v_out)
        return self._rows["bwd"]


def stream_joint_plan(plans_typed, v_src: int,
                      v_out: int) -> StreamJointPlan:
    """Concatenate per-type plans (``concat_typed_plans``, with the 1/deg
    scales; ``pair_stream_joint`` substitutes unit scales) and localize the
    forward output blocks and overflow targets (the localisation of the
    reference's ``pair_stream_joint_from_typed``). Sentinel overflow rows
    carry zero scales, so mapping them to the pad row ``v_out`` is safe."""
    num_types = len(plans_typed)
    (sf, sb, so, rsf, rtf, sbf, gtf, gyf, rsb, rtb, sbb, gtb, gyb,
     osrc, otgt) = concat_typed_plans(plans_typed, v_src, v_out, True)
    gtf_l = (gtf - gyf * (v_out // BLK)).astype(np.int32)
    otgt_l = np.where(otgt >= num_types * v_out, v_out,
                      otgt % v_out).astype(np.int32)
    return StreamJointPlan(
        sf, sb, so, rsf, rtf, sbf, gtf_l, gyf, rsb, rtb, sbb, gtb,
        np.zeros_like(gyb), osrc, otgt_l, v_src, v_out, num_types)


@dataclasses.dataclass(frozen=True)
class StreamTypedPlan(_DevicePlan):
    """The operands of ``pair_stream_typed`` for one batch: the
    concatenated per-type plans as ``concat_typed_plans`` gives them, with
    GLOBAL forward output blocks (targets in the stacked [L * v_out] rows),
    the backward plan's real types (each type's groups read its own
    [v_out] slab of the [L * v_out] cotangent) and global overflow ids
    (sentinel target ``L * v_out``). Built once per batch on the host
    (``stream_typed_plan``) and moved with ``.to(device)``; each
    direction's compact form (``fwd_rows``, ``bwd_rows``) is built at its
    first read and kept (a moved plan starts without them)."""

    scale_fwd: object
    scale_bwd: object
    ovf_scale: object
    rel_src_f: object
    rel_tgt_f: object
    src_blk_f: object
    grp_tgt_f: object
    grp_type_f: object
    rel_src_b: object
    rel_tgt_b: object
    src_blk_b: object
    grp_tgt_b: object
    grp_type_b: object
    ovf_src: object
    ovf_tgt: object
    v_src: int
    v_out: int
    num_types: int
    _rows: Dict[object, "SlotRows"] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def out_rows(self) -> int:
        return self.num_types * self.v_out

    @property
    def fwd_rows(self) -> "SlotRows":
        """The forward direction's compact form, which K1 reads in the
        forward: sources in the stacked [L * v_src] table, targets in the
        stacked [L * v_out] output."""
        if "fwd" not in self._rows:
            self._rows["fwd"] = slot_rows(
                self.rel_src_f, self.rel_tgt_f, self.src_blk_f,
                self.grp_tgt_f, self.num_types * self.v_src, self.out_rows,
                self.grp_type_f, self.v_src)
        return self._rows["fwd"]

    @property
    def bwd_rows(self) -> "SlotRows":
        """The backward direction's compact form, which K1 reads in the
        backward: sources in the [L * v_out] cotangent (type l's groups in
        its slab), targets in the stacked [L * v_src] table rows."""
        if "bwd" not in self._rows:
            self._rows["bwd"] = slot_rows(
                self.rel_src_b, self.rel_tgt_b, self.src_blk_b,
                self.grp_tgt_b, self.out_rows, self.num_types * self.v_src,
                self.grp_type_b, self.v_out)
        return self._rows["bwd"]


def stream_typed_plan(plans_typed, v_src: int,
                      v_out: int) -> StreamTypedPlan:
    """Concatenate per-type plans (``concat_typed_plans``, with the 1/deg
    scales; ``pair_stream_typed`` substitutes unit scales) and keep them
    global, as the reference's ``pair_stream_from_typed`` reads them."""
    return StreamTypedPlan(
        *concat_typed_plans(plans_typed, v_src, v_out, True), v_src, v_out,
        len(plans_typed))


@dataclasses.dataclass(frozen=True)
class MergedPlan(_DevicePlan):
    """A merged plan over all edge types (``PairPlans.astuple()``, 13
    arrays: sources in the stacked ``l * src_space + u`` row space, targets
    local, or merged ``l * V + t`` when the plan was built with
    ``merge_targets=True``) as the merged-plan ops read it. Built once per
    batch from the host tuple (``MergedPlan(*arrays, out_rows=...)``) and
    moved with ``.to(device)``. ``out_rows`` is the forward output row
    count: V, or L * V for merged targets (None where the caller passes
    it). The compact forms (``fwd_rows``, ``bwd_rows``, ``bwd_ts_rows``)
    are built at their first read and kept (a moved plan starts without
    them)."""

    rel_src_f: object
    rel_tgt_f: object
    src_blk_f: object
    grp_tgt_f: object
    rel_src_b: object
    rel_tgt_b: object
    src_blk_b: object
    grp_tgt_b: object
    ovf_src: object
    ovf_tgt: object
    inv_fwd: object
    inv_bwd: object
    inv_ovf: object
    out_rows: Optional[int] = None
    _rows: Dict[object, "SlotRows"] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def fwd(self) -> tuple:
        return (self.rel_src_f, self.rel_tgt_f, self.src_blk_f, self.grp_tgt_f)

    def fwd_rows(self, out_rows: int, table_rows: int) -> "SlotRows":
        """The forward direction's compact form into ``out_rows`` rows from
        a table of ``table_rows``, which B3, B4 and B6 read."""
        key = ("fwd", out_rows, table_rows)
        if key not in self._rows:
            self._rows[key] = slot_rows(*self.fwd, table_rows, out_rows)
        return self._rows[key]

    @property
    def bwd(self) -> tuple:
        return (self.rel_src_b, self.rel_tgt_b, self.src_blk_b, self.grp_tgt_b)

    def bwd_rows(self, out_rows: int, table_rows: int) -> "SlotRows":
        """The backward direction's compact form into ``out_rows`` rows
        (its plan-"tgt" rows, the source rows u) from a table of
        ``table_rows`` (its plan-"src" rows, the targets t), which B9's
        first pass and B5 read."""
        key = ("bwd", out_rows, table_rows)
        if key not in self._rows:
            self._rows[key] = slot_rows(*self.bwd, table_rows, out_rows)
        return self._rows[key]

    def bwd_ts_rows(self, out_rows: int, table_rows: int,
                    vs: int) -> "TsRows":
        """B9's second compact form over ``bwd_rows(out_rows,
        table_rows)``, with target-score rows ``(u // vs) * vs + t``."""
        key = ("bwd_ts", out_rows, table_rows, vs)
        if key not in self._rows:
            self._rows[key] = ts_rows(self.bwd_rows(out_rows, table_rows),
                                      *self.bwd, vs)
        return self._rows[key]


def pair_unit_scales(plan: MergedPlan, out_rows: int):
    """(scale_fwd, scale_bwd, ovf_scale) for unweighted aggregation on the
    plan's device: ones on kernel slots (padded slots are skipped anyway)
    and a validity mask on the overflow slots (their sentinel targets would
    otherwise clip-gather a real row)."""
    sf = torch.ones((plan.rel_src_f.numel(),), dtype=torch.float32,
                    device=plan.rel_src_f.device)
    sb = torch.ones((plan.rel_src_b.numel(),), dtype=torch.float32,
                    device=plan.rel_src_b.device)
    so = (plan.ovf_tgt < out_rows).to(torch.float32)
    return sf, sb, so


# ---------------------------------------------------------------------------
# Device half: the three SpMMs (one kernel), their plain versions and the
# autograd op

# Launch counts of the CUDA kernels of this module: each wrapper adds one
# where it launches its kernel, and nowhere else.
LAUNCHES = {"pair_stream": 0, "pair_stream_joint": 0, "pair_spmm": 0}

_SOURCE = "pair_stream.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def slot_abs_ids(rel_src, rel_tgt, src_blk, grp_tgt):
    """Absolute (src_row, tgt_row, valid) per slot of one plan direction:
    ``srcabs = src_blk[slot // E_C] * BLK + rel_src``, targets through the
    group's ``grp_tgt``; a sentinel ``rel >= BLK`` marks a padded slot
    (its ids are clipped into the block)."""
    rel_s = rel_src.reshape(-1).long()
    rel_t = rel_tgt.reshape(-1).long()
    chunk = torch.arange(rel_s.shape[0], device=rel_s.device) // E_C
    group = plan_group(src_blk, grp_tgt)
    srcabs = src_blk.long()[chunk] * BLK + torch.clamp(rel_s, max=BLK - 1)
    tgtabs = (grp_tgt.long()[chunk // group] * BLK
              + torch.clamp(rel_t, max=BLK - 1))
    valid = (rel_s < BLK) & (rel_t < BLK)
    return srcabs, tgtabs, valid


def _stream_slot_abs_ids(rel_src, rel_tgt, src_blk, grp_tgt, grp_type,
                         v: int):
    """Global (src_row, out_row, valid) per slot of the streamed layout:
    sources globalize through the group's TYPE (``ty * V + src_blk * BLK +
    rel``), outputs through the group's output block."""
    srcabs, tgtabs, valid = slot_abs_ids(rel_src, rel_tgt, src_blk, grp_tgt)
    chunk = torch.arange(srcabs.shape[0], device=srcabs.device) // E_C
    ty = grp_type.long()[chunk // plan_group(src_blk, grp_tgt)]
    return ty * v + srcabs, tgtabs, valid


@dataclasses.dataclass(frozen=True)
class SlotRows:
    """The compact form of one plan direction (``slot_rows``, or
    ``sorted_spmm.sorted_rows`` for a sorted plan): its ``n`` valid slots
    with a target row in the output, sorted stably by target row into a
    CSR. Row ``t``'s slots are ``row_ptr[t]:row_ptr[t + 1]``, in ascending
    slot order; ``src_row`` is each one's table row (clipped into the
    table) and ``slot`` its plan slot, whose per-call scale is
    ``scale[slot]`` (or ``scale[e]`` where the call passes its scale by
    entry, ``by_entry=True``). Built with torch ops on the plan's
    device."""

    row_ptr: torch.Tensor    # int32 [out_rows + 1]
    src_row: torch.Tensor    # int32 [n]
    slot: torch.Tensor       # int32 [n]
    table_rows: int
    out_rows: int
    num_slots: int           # the plan direction's slots (a scale's length)


def slot_rows(rel_src, rel_tgt, src_blk, grp_tgt, table_rows: int,
              out_rows: int, grp_type=None, v: int = 0) -> SlotRows:
    """The compact form of one plan direction, as the row owners read it.

    A slot is valid where ``rel_src < BLK`` and ``rel_tgt < BLK``; its
    source row is ``src_blk[chunk] * BLK + rel_src``, plus ``grp_type[g] *
    v`` where ``grp_type`` is given (the streamed layout), clipped into
    ``[0, table_rows)`` as the twins' ``jnp.take(mode="clip")``; a target
    outside ``[0, out_rows)`` drops the slot (segment-sum semantics). No
    slot's position in its chunk is assumed."""
    if grp_type is None:
        src, tgt, valid = slot_abs_ids(rel_src, rel_tgt, src_blk, grp_tgt)
    else:
        src, tgt, valid = _stream_slot_abs_ids(rel_src, rel_tgt, src_blk,
                                               grp_tgt, grp_type, v)
    kept = torch.nonzero(valid & (tgt >= 0) & (tgt < out_rows)).reshape(-1)
    tgt = tgt[kept]
    slot = kept[torch.sort(tgt, stable=True).indices]
    counts = torch.bincount(tgt, minlength=out_rows)
    row_ptr = torch.cat([counts.new_zeros((1,)), torch.cumsum(counts, 0)])
    return SlotRows(row_ptr.to(torch.int32),
                    torch.clamp(src[slot], 0, table_rows - 1).to(torch.int32),
                    slot.to(torch.int32), table_rows, out_rows,
                    rel_src.numel())


@dataclasses.dataclass(frozen=True)
class TsRows:
    """The second compact form of an attention backward plan, which B9
    reads beside the plan's ``bwd_rows`` form (``compact``, whose entry e
    is a slot with source row u and target t): ``score_row[e]`` is the
    entry's target-score row ``clip((u // vs) * vs + t, rows)``, and
    ``sums`` the CSR of the same entries by their d_ts row ``(u // vs) *
    vs + t`` (t unclipped; entries with a row at or past ``rows`` are
    dropped), whose ``src_row`` is the entry's index e in ``compact``:
    B9's second pass sums each entry's d_p into d_ts over it."""

    score_row: torch.Tensor  # int32 [n]
    sums: "SlotRows"         # into compact.out_rows rows from n entries


def ts_rows(compact: "SlotRows", rel_src, rel_tgt, src_blk, grp_tgt,
            vs: int) -> TsRows:
    """``TsRows`` of the backward plan direction whose compact form (into
    the source rows u, from the target nodes t) is ``compact``. Entries
    whose u lies at or past the output are not in ``compact``, and none
    of them has a d_ts row below it where ``vs`` divides the rows."""
    t_abs, u_abs, _ = slot_abs_ids(rel_src, rel_tgt, src_blk, grp_tgt)
    slot = compact.slot.long()
    rows = compact.out_rows
    key = (u_abs[slot] // vs) * vs + t_abs[slot]
    kept = torch.nonzero(key < rows).reshape(-1)
    entry = kept[torch.sort(key[kept], stable=True).indices]
    counts = torch.bincount(key[kept], minlength=rows)
    row_ptr = torch.cat([counts.new_zeros((1,)), torch.cumsum(counts, 0)])
    sums = SlotRows(row_ptr.to(torch.int32), entry.to(torch.int32),
                    compact.slot[entry], slot.numel(), rows,
                    compact.num_slots)
    return TsRows(torch.clamp(key, 0, rows - 1).to(torch.int32), sums)


def by_slot(values, compact: Optional[SlotRows]):
    """A by-entry ``values`` ([n] or [K, n], entry e of ``compact`` at
    column e) in the plan's slot order: entry e's value at its slot, 0 at
    every other slot. The plain versions read a scale by slot; a slot that
    is not in the form is padded or outside the output, and the plain
    versions drop it."""
    _require_compact("by_slot", compact)
    out = values.new_zeros(values.shape[:-1] + (compact.num_slots,))
    out[..., compact.slot.long()] = values
    return out


def pair_spmm_stream_plain(tables, scale, rel_src, rel_tgt, src_blk,
                           grp_tgt, grp_type, v: int, out_rows: int):
    """Plain PyTorch version of K1 and K2: gather every slot's row
    (clipped, as ``jnp.take(mode="clip")``), upcast to f32, scale, and
    ``index_add_`` into ``out_rows`` rows (invalid slots go to a discard
    row)."""
    srcabs, tgtabs, valid = _stream_slot_abs_ids(
        rel_src, rel_tgt, src_blk, grp_tgt, grp_type, v)
    return _scatter_slots(tables, scale, srcabs, tgtabs, valid, out_rows)


def pair_spmm_plain(table, scale, rel_src, rel_tgt, src_blk, grp_tgt,
                    out_rows: int):
    """Plain PyTorch version of B3, a mirror of the reference's
    ``_pair_spmm_jnp``: the slots' clipped source rows, upcast to f32,
    times the f32 scale, summed into ``out_rows`` rows."""
    srcabs, tgtabs, valid = slot_abs_ids(rel_src, rel_tgt, src_blk, grp_tgt)
    return _scatter_slots(table, scale, srcabs, tgtabs, valid, out_rows)


def _scatter_slots(tables, scale, srcabs, tgtabs, valid, out_rows: int):
    srcabs = torch.clamp(srcabs, 0, tables.shape[0] - 1)
    msgs = tables[srcabs].to(torch.float32)
    msgs = msgs * (scale.reshape(-1) * valid)[:, None]
    seg = torch.where(valid & (tgtabs < out_rows), tgtabs,
                      torch.full_like(tgtabs, out_rows))
    out = torch.zeros((out_rows + 1, tables.shape[1]), dtype=torch.float32,
                      device=tables.device)
    out.index_add_(0, seg, msgs)
    return out[:out_rows]


_INT, _INT64, _PTR = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
# (restype, argtypes) of the library's C entry points, set once at load:
# one row-owner signature for K1, K2, B3, B12 (sorted_spmm.py) and B9's
# second pass (pair_attention.py), one per-head signature for B10
# (pair_attention.py) and B14 (sorted_spmm.py), one max signature for B11
# (pair_attention.py) and B15 (sorted_spmm.py), and B8's (pair_attention.py).
_ROW_OWNER = (ctypes.c_int, [_INT, _INT, _PTR, _INT64, _INT, _PTR, _PTR,
                             _PTR, _PTR, _INT64, _PTR, _PTR])
_HEAD_ROWS = (ctypes.c_int, [_INT, _INT, _PTR, _INT64, _INT, _INT, _PTR,
                             _INT64, _INT64, _PTR, _PTR, _PTR, _INT64, _PTR,
                             _PTR, _PTR])
_MAX_ROWS = (ctypes.c_int, [_INT, _INT, _PTR, _INT64, _INT64, _INT, _INT,
                            _PTR, _PTR, _PTR, _INT64, _PTR, _PTR])
_EXPD_ROWS = (ctypes.c_int, [_INT, _INT, _PTR, _INT64, _INT, _INT, _PTR,
                             _PTR, _PTR, _INT64, _INT64, _PTR, _PTR])
_SIGNATURES = {
    "pair_stream_launch": _ROW_OWNER,
    "pair_stream_joint_launch": _ROW_OWNER,
    "pair_spmm_launch": _ROW_OWNER,
    "sorted_segment_sum_launch": _ROW_OWNER,
    "pair_attention_ts_launch": _ROW_OWNER,
    "pair_attention_agg_launch": _HEAD_ROWS,
    "attention_scatter_launch": _HEAD_ROWS,
    "pair_attention_max_launch": _MAX_ROWS,
    "sorted_segment_max_launch": _MAX_ROWS,
    "pair_attention_expd_launch": _EXPD_ROWS,
    "pair_stream_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _library():
    from .cuda_build import load_library

    return load_library(_SOURCE, _SIGNATURES)


def _raise_on(lib, entry: str, err: int) -> None:
    if err != 0:
        msg = lib.pair_stream_error_string(err).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {err} ({msg})")


def _rows_view(x):
    """``x`` where its rows are contiguous (a row stride is fine), else a
    contiguous copy."""
    if x.stride(1) == 1 and x.stride(0) >= x.shape[1]:
        return x
    return x.contiguous()


def _check_compact(entry: str, table, compact: SlotRows,
                   out_rows: int) -> None:
    """The compact form's sizes held to the call's (its own tensors were
    checked when it was built)."""
    if (compact.out_rows != out_rows
            or compact.table_rows != table.shape[0]):
        raise ValueError(
            f"{entry}: the compact form is of a [{compact.table_rows}]-row "
            f"table into {compact.out_rows} rows; the call has a "
            f"[{table.shape[0]}]-row table and {out_rows} output rows")
    if compact.row_ptr.device != table.device:
        raise ValueError(f"{entry}: the compact form is on "
                         f"{compact.row_ptr.device}, the table on "
                         f"{table.device}")


def _check_table(entry: str, table, scale) -> None:
    if table.dtype not in _DTYPE_CODES:
        raise TypeError(f"{entry}: the table must be float32 or bfloat16, "
                        f"got {table.dtype}")
    if table.dim() != 2:
        raise ValueError(f"{entry}: the table must be 2-D")
    if scale is not None and (scale.dtype != torch.float32
                              or not scale.is_contiguous()
                              or scale.device != table.device):
        raise TypeError(f"{entry}: scale must be contiguous float32 on the "
                        "table's device")


def _scale_count(compact: SlotRows, by_entry: bool) -> int:
    """The values a scale holds: one an entry of the form (``by_entry``)
    or one a plan slot."""
    return compact.src_row.numel() if by_entry else compact.num_slots


def _launch_rows(entry: str, table, scale, compact: SlotRows,
                 out_rows: int, by_entry: bool = False):
    """Launch ``row_owner_kernel`` (K1, K2, B3, B12 or B9's second pass, by
    ``entry``) on the current stream over the plan's compact form: f32
    [out_rows, H], every element stored once, so the output is not
    initialised. ``table`` may be a row-strided view (its row stride is
    passed, not copied; other layouts are copied); ``scale`` None reads
    every entry at scale 1, ``by_entry`` reads entry e's scale at e (no
    slot load) rather than at its slot. The compact form's own tensors
    were checked when it was built; here only its sizes are held to the
    call's."""
    lib = _library()
    _check_table(entry, table, scale)
    table = _rows_view(table)
    _check_compact(entry, table, compact, out_rows)
    count = _scale_count(compact, by_entry)
    if scale is not None and scale.numel() != count:
        raise ValueError(f"{entry}: the compact form has {count} "
                         f"{'entries' if by_entry else 'slots'}, the call "
                         f"has {scale.numel()} scales")
    h = table.shape[1]
    out = torch.empty((out_rows, h), dtype=torch.float32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    _raise_on(lib, entry, getattr(lib, entry)(
        table.device.index or 0, _DTYPE_CODES[table.dtype],
        table.data_ptr(), table.stride(0), h,
        None if scale is None else scale.data_ptr(),
        compact.row_ptr.data_ptr(), compact.src_row.data_ptr(),
        None if by_entry else compact.slot.data_ptr(), out_rows,
        out.data_ptr(), stream))
    return out


def launch_head_rows(entry: str, table, expd, head_stride: int,
                     slot_stride: int, num_heads: int, compact: SlotRows,
                     out_rows: int, by_entry: bool = False):
    """Launch ``head_rows_kernel`` (B10 or B14, by ``entry``) on the
    current stream over the plan's compact form: (denom f32 [out_rows, K],
    weighted f32 [out_rows, H]) with ``weighted[t, c]`` the sum over row
    t's entries of ``expd(slot, c % K) * table[src_row, c]`` and ``denom[t,
    k]`` that of ``expd(slot, k)``, where ``expd(s, k)`` is the element
    ``k * head_stride + s * slot_stride`` of the contiguous f32 ``expd``
    (``s`` the entry's index e where ``by_entry``). Every element is
    stored once, so neither output is initialised; ``table`` may be a
    row-strided view."""
    lib = _library()
    _check_table(entry, table, None)
    table = _rows_view(table)
    _check_compact(entry, table, compact, out_rows)
    k, h = num_heads, table.shape[1]
    if not 0 < k <= 32 or h % k:
        raise ValueError(f"{entry}: needs 0 < num_heads <= 32 dividing the "
                         f"table's width, got {k} heads and {h} columns")
    count = _scale_count(compact, by_entry)
    last = (k - 1) * head_stride + (count - 1) * slot_stride
    if (expd.dtype != torch.float32 or expd.device != table.device
            or not expd.is_contiguous() or last >= expd.numel()):
        raise ValueError(f"{entry}: expd must be contiguous f32 on the "
                         f"table's device holding {k} heads of {count} "
                         f"{'entries' if by_entry else 'slots'}, got "
                         f"{expd.dtype} {tuple(expd.shape)} on "
                         f"{expd.device}")
    denom = torch.empty((out_rows, k), dtype=torch.float32,
                        device=table.device)
    out = torch.empty((out_rows, h), dtype=torch.float32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    _raise_on(lib, entry, getattr(lib, entry)(
        table.device.index or 0, _DTYPE_CODES[table.dtype],
        table.data_ptr(), table.stride(0), h, k, expd.data_ptr(),
        head_stride, slot_stride, compact.row_ptr.data_ptr(),
        compact.src_row.data_ptr(),
        None if by_entry else compact.slot.data_ptr(), out_rows,
        out.data_ptr(), denom.data_ptr(), stream))
    return denom, out


def launch_max_rows(entry: str, table, num_cols: int, compact: SlotRows,
                    out_rows: int, src_space: int = 0, init=None):
    """Launch ``max_rows_kernel`` (B11 or B15, by ``entry``) on the current
    stream over the plan's compact form: f32 [out_rows, num_cols], every
    element stored once, so the output is not initialised. B11's ``table``
    is the contiguous [rows, 2K] score table (``num_cols`` = K,
    ``src_space`` one type's source rows, ``init`` an optional f32
    [out_rows, K] that the maxes start from); B15's the f32 [slots, K]
    values, possibly a row-strided view."""
    lib = _library()
    _check_table(entry, table, None)
    table = _rows_view(table)
    _check_compact(entry, table, compact, out_rows)
    if init is not None and (init.dtype != torch.float32
                             or init.device != table.device
                             or not init.is_contiguous()
                             or tuple(init.shape) != (out_rows, num_cols)):
        raise ValueError(f"{entry}: init must be a contiguous f32 "
                         f"[{out_rows}, {num_cols}] on the table's device, "
                         f"got {init.dtype} {tuple(init.shape)} on "
                         f"{init.device}")
    out = torch.empty((out_rows, num_cols), dtype=torch.float32,
                      device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    _raise_on(lib, entry, getattr(lib, entry)(
        table.device.index or 0, _DTYPE_CODES[table.dtype],
        table.data_ptr(), table.stride(0), table.shape[0], num_cols,
        src_space, None if init is None else init.data_ptr(),
        compact.row_ptr.data_ptr(), compact.src_row.data_ptr(), out_rows,
        out.data_ptr(), stream))
    return out


def launch_expd_rows(scores, maxes, num_heads: int, compact: SlotRows,
                     out_rows: int, src_space: int):
    """Launch ``expd_rows_kernel`` (B8) on the current stream over the
    forward plan's compact form: f32 [K, n] by entry, ``exp(logit - m)``
    of each entry's K logits (B11's, over the contiguous [rows, 2K]
    ``scores``) against its target row's f32 stabiliser ``maxes``
    [out_rows, K]. Every element is stored once, so the output is not
    initialised."""
    entry = "pair_attention_expd_launch"
    lib = _library()
    _check_table(entry, scores, None)
    _check_compact(entry, scores, compact, out_rows)
    k = num_heads
    if not scores.is_contiguous() or src_space <= 0:
        raise ValueError(f"{entry}: needs contiguous scores and src_space "
                         f"> 0, got src_space {src_space}")
    if (maxes.dtype != torch.float32 or maxes.device != scores.device
            or not maxes.is_contiguous()
            or tuple(maxes.shape) != (out_rows, k)):
        raise ValueError(f"{entry}: maxes must be a contiguous f32 "
                         f"[{out_rows}, {k}] on the scores' device, got "
                         f"{maxes.dtype} {tuple(maxes.shape)} on "
                         f"{maxes.device}")
    n = compact.src_row.numel()
    out = torch.empty((k, n), dtype=torch.float32, device=scores.device)
    _raise_on(lib, entry, lib.pair_attention_expd_launch(
        scores.device.index or 0, _DTYPE_CODES[scores.dtype],
        scores.data_ptr(), scores.shape[0], k, src_space, maxes.data_ptr(),
        compact.row_ptr.data_ptr(), compact.src_row.data_ptr(), n, out_rows,
        out.data_ptr(), torch.cuda.current_stream(scores.device).cuda_stream))
    return out


def _on_cpu(name: str, tables) -> bool:
    if tables.device.type not in ("cpu", "cuda"):
        raise TypeError(f"{name}: unsupported device {tables.device}")
    return tables.device.type == "cpu"


def _require_compact(name: str, compact, keyword: str = "compact") -> None:
    if compact is None:
        raise ValueError(
            f"{name}: a CUDA call needs the plan's compact form ({keyword}=, "
            "from slot_rows / sorted_rows / ts_rows or the form the plan "
            "keeps), built once per batch")


def pair_spmm_stream(tables, scale, rel_src, rel_tgt, src_blk, grp_tgt_g,
                     grp_type, v: int, out_rows: int,
                     compact: Optional[SlotRows] = None):
    """K1, the streamed per-type kernel: f32 [out_rows, H] with GLOBAL
    output blocks ``grp_tgt_g``; ``tables`` [L*v, H] f32 or bf16. On the
    card it reads only the plan's ``compact`` form
    (``StreamJointPlan.bwd_rows``, ``StreamTypedPlan.fwd_rows`` or
    ``bwd_rows``) and the scales; on the CPU the plain version reads the
    plan arrays."""
    if _on_cpu("pair_stream", tables):
        return pair_spmm_stream_plain(tables, scale, rel_src, rel_tgt,
                                      src_blk, grp_tgt_g, grp_type, v,
                                      out_rows)
    _require_compact("pair_stream", compact)
    out = _launch_rows("pair_stream_launch", tables, scale, compact,
                       out_rows)
    LAUNCHES["pair_stream"] += 1
    return out


def pair_spmm_stream_joint(tables, scale, rel_src, rel_tgt, src_blk,
                           grp_tgt_l, grp_type, v: int, v_out: int,
                           compact: Optional[SlotRows] = None):
    """K2, the joint kernel: the sum over all types into f32 [v_out, H],
    with LOCAL output blocks ``grp_tgt_l``. On the card it reads only the
    plan's ``compact`` form (``StreamJointPlan.fwd_rows``) and the scales;
    on the CPU the plain version reads the plan arrays."""
    if _on_cpu("pair_stream_joint", tables):
        return pair_spmm_stream_plain(tables, scale, rel_src, rel_tgt,
                                      src_blk, grp_tgt_l, grp_type, v, v_out)
    _require_compact("pair_stream_joint", compact)
    out = _launch_rows("pair_stream_joint_launch", tables, scale, compact,
                       v_out)
    LAUNCHES["pair_stream_joint"] += 1
    return out


def pair_spmm(table, scale, rel_src, rel_tgt, src_blk, grp_tgt,
              out_rows: int, compact: Optional[SlotRows] = None,
              by_entry: bool = False):
    """B3, the merged-plan kernel: ``out[tgt] += scale * table[src]`` over
    one plan direction into f32 [out_rows, H] (``table`` [rows, H] f32 or
    bf16, ``scale`` a contiguous f32 row of one value per slot, or with
    ``by_entry`` one per entry of ``compact``, in its order, as B8 writes
    it). On the card it reads only the direction's ``compact`` form
    (``slot_rows``) and the scales; on the CPU the plain version reads
    the plan arrays (a by-entry scale put back in slot order)."""
    if _on_cpu("pair_spmm", table):
        if by_entry:
            scale = by_slot(scale, compact)
        return pair_spmm_plain(table, scale, rel_src, rel_tgt, src_blk,
                               grp_tgt, out_rows)
    _require_compact("pair_spmm", compact)
    out = _launch_rows("pair_spmm_launch", table, scale, compact, out_rows,
                       by_entry)
    LAUNCHES["pair_spmm"] += 1
    return out


def _overflow_sums(tables, ovf_src, ovf_tgt, ovf_scale, out_rows: int):
    """The overflow edges' f32 [out_rows, H] sums in plain torch
    (sentinel targets ``out_rows`` land in a dropped row)."""
    msgs = tables[ovf_src.long()].to(torch.float32) * ovf_scale[:, None]
    ext = torch.zeros((out_rows + 1, tables.shape[1]), dtype=torch.float32,
                      device=tables.device)
    ext.index_add_(0, ovf_tgt.long(), msgs)
    return ext[:out_rows]


def _add_overflow_grads(d_tables, g, ovf_src, ovf_tgt, ovf_scale) -> None:
    """The overflow edges' share of the table gradient, added in place:
    each edge's (clipped) cotangent row, scaled, into its source row."""
    g_rows = g[torch.clamp(ovf_tgt.long(), max=g.shape[0] - 1)]
    d_tables.index_add_(0, ovf_src.long(),
                        g_rows.to(torch.float32) * ovf_scale[:, None])


def _stream_scales(plan, normalize: bool, ovf_tgt, out_rows: int):
    """(scale_fwd, scale_bwd, ovf_scale): the plan's 1/deg scales, or
    unit scales with the overflow slots' validity mask (sentinel slots are
    skipped either way)."""
    if normalize:
        return plan.scale_fwd, plan.scale_bwd, plan.ovf_scale
    return (torch.ones_like(plan.scale_fwd), torch.ones_like(plan.scale_bwd),
            (ovf_tgt < out_rows).to(torch.float32))


class PairStreamJoint(torch.autograd.Function):
    """JOINT sum over types, f32 [Vo, H]: ``out[t] = sum over ALL edges
    (u -> t, type l) of scale_e * tables[l*Vs + u]``.

    Forward: the tables cast to ``stream_dtype``, the joint kernel K2 over
    the plan's compact form (``plan.fwd_rows``, built at the batch's first
    forward), plus the overflow edges in plain torch. Backward: the stream
    kernel K1 over the backward plan's compact form (``plan.bwd_rows``,
    built at the batch's first backward) with all-zero types, so every
    entry reads the one un-broadcast [Vo, H] cotangent slab. Unlike the
    TPU, where a VMEM budget routes large windows to stream-plus-reduce, the
    joint output always lives in device memory here, so the forward is
    always the joint kernel.

    The cast to the stream dtype happens inside the op so that the table
    gradient leaves it in f32: in the reference the transpose of
    ``astype(bf16)`` passes the f32 cotangent through unrounded, while a
    bf16 input here would have its gradient rounded to bf16.
    """

    @staticmethod
    def forward(ctx, tables_flat, plan: StreamJointPlan, scale_fwd,
                scale_bwd, ovf_scale, stream_dtype):
        tables = tables_flat.to(stream_dtype).contiguous()
        out = pair_spmm_stream_joint(
            tables, scale_fwd, plan.rel_src_f, plan.rel_tgt_f,
            plan.src_blk_f, plan.grp_tgt_fl, plan.grp_type_f, plan.v_src,
            plan.v_out, compact=plan.fwd_rows)
        if plan.ovf_src.shape[0]:
            out = out + _overflow_sums(tables, plan.ovf_src, plan.ovf_tgt_l,
                                       ovf_scale, plan.v_out)
        ctx.plan = plan
        ctx.stream_dtype = stream_dtype
        ctx.save_for_backward(scale_bwd, ovf_scale)
        return out

    @staticmethod
    def backward(ctx, g):
        plan: StreamJointPlan = ctx.plan
        scale_bwd, ovf_scale = ctx.saved_tensors
        rows = plan.num_types * plan.v_src
        # The cotangent streams at the FORWARD table dtype (bf16 tables:
        # half the gather bytes), as in the reference (pair_spmm.py:1309).
        g_stream = g.to(ctx.stream_dtype).contiguous()
        d_tables = pair_spmm_stream(
            g_stream, scale_bwd, plan.rel_src_b, plan.rel_tgt_b,
            plan.src_blk_b, plan.grp_tgt_b, plan.type_b_zeros, plan.v_out,
            rows, compact=plan.bwd_rows)
        if plan.ovf_src.shape[0]:
            _add_overflow_grads(d_tables, g, plan.ovf_src, plan.ovf_tgt_l,
                                ovf_scale)
        return d_tables, None, None, None, None, None


def pair_stream_joint(tables_flat, plan: StreamJointPlan, normalize: bool,
                      stream_dtype: torch.dtype = None) -> torch.Tensor:
    """Apply the joint streamed op with the plan's 1/deg scales
    (``normalize``) or unit scales (sentinel slots are skipped either way;
    overflow slots keep their validity mask). ``stream_dtype`` (default:
    the tables' dtype) is the dtype the kernels gather."""
    return PairStreamJoint.apply(
        tables_flat, plan,
        *_stream_scales(plan, normalize, plan.ovf_tgt_l, plan.v_out),
        stream_dtype or tables_flat.dtype)


def pair_stream_joint_from_typed(tables_flat, plans_typed, v_out: int,
                                 normalize: bool,
                                 stream_dtype: torch.dtype = None
                                 ) -> torch.Tensor:
    """Joint [Vo, H] sum over per-type plans (host arrays): concatenate and
    localize them on the host, move them to the tables' device, and run
    ``pair_stream_joint``. Model code builds the plan once per batch
    (``GraphBatch.pair_stream_joint``) and calls ``pair_stream_joint``."""
    v_src = tables_flat.shape[0] // len(plans_typed)
    plan = stream_joint_plan(plans_typed, v_src, v_out)
    return pair_stream_joint(tables_flat, plan.to(tables_flat.device),
                             normalize, stream_dtype)


class PairStreamTyped(torch.autograd.Function):
    """PER-TYPE aggregates, f32 [L*Vo, H]: ``out[l*Vo + t] = sum over type-l
    edges (u -> t) of scale_e * tables[l*Vs + u]`` (the reference's
    ``pair_stream_gather_scatter``).

    Forward: the tables cast to ``stream_dtype``, the stream kernel K1
    over the forward plan's compact form (``plan.fwd_rows``, global output
    blocks), plus the overflow edges in plain torch. Backward: K1 again
    over the backward plan's compact form (``plan.bwd_rows``), whose
    entries read their own type's slab of the [L*Vo] cotangent, streamed at
    the stream dtype as in the reference's ``_psgs_bwd``; the table
    gradient leaves in f32 (``PairStreamJoint``'s reason).
    """

    @staticmethod
    def forward(ctx, tables_flat, plan: StreamTypedPlan, scale_fwd,
                scale_bwd, ovf_scale, stream_dtype):
        tables = tables_flat.to(stream_dtype).contiguous()
        out = pair_spmm_stream(
            tables, scale_fwd, plan.rel_src_f, plan.rel_tgt_f,
            plan.src_blk_f, plan.grp_tgt_f, plan.grp_type_f, plan.v_src,
            plan.out_rows, compact=plan.fwd_rows)
        if plan.ovf_src.shape[0]:
            out = out + _overflow_sums(tables, plan.ovf_src, plan.ovf_tgt,
                                       ovf_scale, plan.out_rows)
        ctx.plan = plan
        ctx.stream_dtype = stream_dtype
        ctx.save_for_backward(scale_bwd, ovf_scale)
        return out

    @staticmethod
    def backward(ctx, g):
        plan: StreamTypedPlan = ctx.plan
        scale_bwd, ovf_scale = ctx.saved_tensors
        g_stream = g.to(ctx.stream_dtype).contiguous()
        d_tables = pair_spmm_stream(
            g_stream, scale_bwd, plan.rel_src_b, plan.rel_tgt_b,
            plan.src_blk_b, plan.grp_tgt_b, plan.grp_type_b, plan.v_out,
            plan.num_types * plan.v_src, compact=plan.bwd_rows)
        if plan.ovf_src.shape[0]:
            _add_overflow_grads(d_tables, g, plan.ovf_src, plan.ovf_tgt,
                                ovf_scale)
        return d_tables, None, None, None, None, None


def pair_stream_typed(tables_flat, plan: StreamTypedPlan, normalize: bool,
                      stream_dtype: torch.dtype = None) -> torch.Tensor:
    """Apply the per-type streamed op with the plan's 1/deg scales
    (``normalize``) or unit scales (overflow slots keep their validity
    mask). ``stream_dtype`` (default: the tables' dtype) is the dtype the
    kernels gather."""
    return PairStreamTyped.apply(
        tables_flat, plan,
        *_stream_scales(plan, normalize, plan.ovf_tgt, plan.out_rows),
        stream_dtype or tables_flat.dtype)



class PairTypedGatherScatter(torch.autograd.Function):
    """All-type sums over a MERGED plan, f32 [out_rows, H] (the
    reference's ``pair_typed_gather_scatter``, pair_spmm.py:718-797):
    ``out[t] = sum over edges e = (u -> t, type l) of scale_e *
    tables[l*Vs + u]``, with t a local target (``out_rows`` V, the joint
    sum) or a merged one ``l * V + t`` (``out_rows`` L * V, per-type
    aggregates).

    Forward: the tables cast to ``stream_dtype``, B3 over the forward
    plan's compact form (``plan.fwd_rows(out_rows, rows)``) with the
    forward scales by slot, plus the overflow edges in plain torch.
    Backward: B3 over the backward plan's compact form
    (``plan.bwd_rows(rows, out_rows)``: the [out_rows] cotangent is its
    table, the [rows] table gradient its output) with the backward scales;
    the cotangent streams at the stream dtype and the overflow share reads
    it unrounded, as in the reference's ``_ptgs_bwd``; the table gradient
    leaves in f32 (``PairStreamJoint``'s reason).
    """

    @staticmethod
    def forward(ctx, tables_flat, plan: MergedPlan, scale_fwd, scale_bwd,
                ovf_scale, out_rows: int, stream_dtype):
        tables = tables_flat.to(stream_dtype).contiguous()
        rows = tables.shape[0]
        out = pair_spmm(tables, scale_fwd, *plan.fwd, out_rows,
                        compact=plan.fwd_rows(out_rows, rows))
        if plan.ovf_src.shape[0]:
            out = out + _overflow_sums(tables, plan.ovf_src, plan.ovf_tgt,
                                       ovf_scale, out_rows)
        ctx.plan, ctx.rows, ctx.out_rows = plan, rows, out_rows
        ctx.stream_dtype = stream_dtype
        ctx.save_for_backward(scale_bwd, ovf_scale)
        return out

    @staticmethod
    def backward(ctx, g):
        plan: MergedPlan = ctx.plan
        scale_bwd, ovf_scale = ctx.saved_tensors
        g_stream = g.to(ctx.stream_dtype).contiguous()
        d_tables = pair_spmm(g_stream, scale_bwd, *plan.bwd, ctx.rows,
                             compact=plan.bwd_rows(ctx.rows, ctx.out_rows))
        if plan.ovf_src.shape[0]:
            _add_overflow_grads(d_tables, g, plan.ovf_src, plan.ovf_tgt,
                                ovf_scale)
        return d_tables, None, None, None, None, None, None


def pair_typed_gather_scatter(tables_flat, plan: MergedPlan, normalize: bool,
                              out_rows: int = None,
                              stream_dtype: torch.dtype = None
                              ) -> torch.Tensor:
    """Apply the merged-plan op into ``out_rows`` rows (default: the
    plan's own, V or L * V) with the plan's 1/deg scales (``normalize``)
    or unit scales (``pair_unit_scales``: sentinel slots are skipped
    either way; overflow slots keep their validity mask).
    ``stream_dtype`` (default: the tables' dtype) is the dtype the kernels
    gather."""
    out_rows = plan.out_rows if out_rows is None else out_rows
    if normalize:
        scales = (plan.inv_fwd, plan.inv_bwd, plan.inv_ovf)
    else:
        scales = pair_unit_scales(plan, out_rows)
    return PairTypedGatherScatter.apply(tables_flat, plan, *scales, out_rows,
                                        stream_dtype or tables_flat.dtype)
