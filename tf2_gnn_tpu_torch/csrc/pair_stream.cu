// The row-owner SpMM kernel for Hopper (sm_90a), bound through a plain C
// interface (ctypes) by tf2_gnn_tpu_torch/ops/pair_spmm.py,
// ops/sorted_spmm.py and ops/pair_attention.py.
//
// One kernel, row_owner_kernel, computes the function of four TPU kernels
// and the second pass of a fifth. Each reads the compact form of its plan
// direction (ops/pair_spmm.py::SlotRows, built once per batch by
// pair_spmm.py::slot_rows for the pair plans and by sorted_spmm.py::
// sorted_rows for the sorted plans): the valid slots whose output row lies
// in the output, sorted stably by output row into a CSR (row_ptr
// [out_rows + 1]; per entry its table row src_row and its plan slot), and
// computes
//
//   out[t, :] = sum over the entries e of row t, in slot order, of
//               scale[slot[e]] * f32(table[src_row[e], :])
//
// into an f32 output, every element stored once (scale 1 where the caller
// passes none; scale[e], with no slot load, where the caller passes the
// scale by entry, as a null slot). Its C entries:
//
//   pair_stream_launch        <- tf2_gnn_tpu/ops/pair_spmm.py:800
//                                (_pair_spmm_stream_device, pallas_call :895).
//                                K1: the backward of every RGCN layer over
//                                the backward plan with all-zero types, the
//                                [Vo, H] cotangent slab into the stacked
//                                [L * Vs] source rows (StreamJointPlan.
//                                bwd_rows).
//   pair_stream_joint_launch  <- tf2_gnn_tpu/ops/pair_spmm.py:973
//                                (_pair_spmm_stream_joint_device, pallas_call
//                                :1057). K2: the joint sum over edge types
//                                into one [Vo, H] output, the forward of
//                                every RGCN layer (StreamJointPlan.fwd_rows).
//   pair_spmm_launch          <- tf2_gnn_tpu/ops/pair_spmm.py:585
//                                (_pair_spmm_device, pallas_call :678; its
//                                jnp twin _pair_spmm_jnp). B3: one direction
//                                of a MERGED plan; RGAT runs it once per head
//                                on a head-major [L*V, head_dim + 1] table
//                                whose last column is ones (the
//                                denominators), with that head's row of B8's
//                                by-entry expd as the scale (scale[e]); the
//                                probes P1/P2 run it on their plans. Unlike
//                                the TPU kernel, which rounds onehot * scale
//                                to the table dtype, the scale stays f32, as
//                                in the jnp twin.
//   sorted_segment_sum_launch <- tf2_gnn_tpu/ops/spmm_pallas.py:378
//                                (sorted_segment_sum, pallas_call :442).
//                                B12: no scale. Over a sorted plan's compact
//                                form, either the stream itself, read row by
//                                row (src_row = slot), or, for
//                                plan_gather_src's gradient, the cotangent's
//                                forward-slot rows through the plan's
//                                bwd_to_fwd_slot map (src_row =
//                                bwd_to_fwd_idx[slot]), so the re-ordered
//                                [slots, H] stream is never written.
//   pair_attention_ts_launch  the second pass of B9 (csrc/pair_attention.cu,
//                                ops/pair_attention.py::
//                                pair_attention_bwd_fused): no scale; the
//                                f32 [n, K] d_p of the first pass's entries
//                                summed into d_ts by its row (u / vs) * vs +
//                                t (ops/pair_spmm.py::TsRows).
//
// Its twin, head_rows_kernel, scales column c of an entry by the entry's
// head c % K and also sums the heads themselves, the attention sums
//
//   weighted[t, c] = sum over the entries e of row t, in slot order, of
//                    expd(slot[e], c % K) * f32(table[src_row[e], c]),
//   denom[t, k]    = sum over the same entries of expd(slot[e], k),
//
// with expd(s, k) = expd[k * head_stride + s * slot_stride] (s = e where the
// caller passes expd by entry, as a null slot). Its C entries:
//
//   pair_attention_agg_launch <- tf2_gnn_tpu/ops/pair_attention.py:484
//                                (_agg_kernel_device, pallas_call :596; jnp
//                                twin _agg_kernel_jnp). B10: RGAT's hk-major
//                                sums where K > 4 * ceil(H / 128) or
//                                head_dim + 1 > 128, over a merged or one
//                                type's forward plan (MergedPlan.fwd_rows, the
//                                form B3 reads), B8's [K, n] expd by entry
//                                (head stride n). The TPU kernel rounds each
//                                scaled message to the table dtype; like the
//                                jnp twin, this one keeps it f32.
//   attention_scatter_launch  <- tf2_gnn_tpu/ops/spmm_pallas.py:755
//                                (attention_scatter, pallas_call :835). B14:
//                                the sorted RGAT forward over the sorted
//                                plan's compact form (ScatterPlan.sum_rows(
//                                "fwd"), src_row = slot, the stream row), a
//                                row-strided f32 [slots, H] view of the
//                                gathered bundle and the [slots, K] expd
//                                (slot stride K).
//
// For these, lanes j < K of a row's group load head j's expd of each entry
// (one load of each value per entry: K contiguous floats for B14, K rows of
// B8's by-entry output for B10) and the group shares them with
// __shfl_sync; element i of a lane's units lies in head (unit * E + i) % K,
// the same for all its units where K divides G * E (any power-of-two K;
// otherwise W = 1 and the columns take more tiles). The lanes j < K of column tile 0 sum the
// denominators in the same slot order. Every output element is stored
// once: the first port's B10 (one block per plan group and 64-column tile,
// shared and global atomics into a zero-filled output, every padded slot
// walked) and B14 (a block per 512-slot chunk and 64-column tile, scalar
// loads, an expd load per slot and column, an atomic per column and run)
// are retired.
//
// Its max twin, max_rows_kernel, takes a per-column max over the same
// entries, in place of the sum:
//
//   pair_attention_max_launch <- tf2_gnn_tpu/ops/pair_attention.py:174
//                                (_max_kernel_device, pallas_call :262; jnp
//                                twin _max_kernel_jnp). B11: RGAT's "exact"
//                                stabiliser over a merged or one type's
//                                forward plan (MergedPlan.fwd_rows, the form
//                                B3 and B10 read; src_row the source row u):
//                                  m[t, k] = max(init[t, k], NEG, max over
//                                    row t's entries of logit(e, k)),
//                                  logit(e, k) = leaky(ss[u, k] +
//                                    ts[clip((u / vs) * vs + t, rows), k])
//                                over the packed [rows, 2K] score table
//                                (source halves | target halves), with init
//                                NEG where the caller passes none; the
//                                per-type forward chains its launches
//                                through init. The compact form carries u
//                                clipped into the table, as the first port's
//                                kernel clipped it; it also clipped the
//                                target-score row from the unclipped u, which
//                                gives the same row wherever u < rows, as on
//                                every plan build_pair_plans builds.
//   sorted_segment_max_launch <- tf2_gnn_tpu/ops/spmm_pallas.py:671
//                                (sorted_segment_max, pallas_call :705). B15:
//                                the sorted RGAT's stabiliser over the sorted
//                                plan's forward compact form
//                                (ScatterPlan.sum_rows("fwd"), src_row = slot)
//                                and the f32 [slots, K] values: the max of
//                                row t's entries, stored as 0 where it is not
//                                finite (an empty row included), as the
//                                reference's where(isfinite(out), out, 0).
//
// Its expd twin, expd_rows_kernel, maps each entry's logits, computed by
// the same device function as B11's (pair_logits, so the two cannot
// disagree on a logit), through the stabiliser:
//
//   pair_attention_expd_launch <- tf2_gnn_tpu/ops/pair_attention.py:304
//                                (_expd_kernel_device, pallas_call :427; jnp
//                                twin _expd_kernel_jnp). B8: over the forward
//                                plan's compact form (MergedPlan.fwd_rows,
//                                the form B11, B3 and B10 read),
//                                  expd[k, e] = exp(logit(e, k) - m[t, k]),
//                                f32 [K, n] by entry: the TPU kernel's value
//                                at the entry's slot, so B3 and B10 read
//                                entry e's scale at e, with no slot load,
//                                and no padded slot is written. Like B11 it
//                                clips the target-score row from the
//                                compact form's clipped u, where the first
//                                port's kernel clipped it from the
//                                unclipped u: the same row wherever u <
//                                rows, as on every plan build_pair_plans
//                                builds. The subtraction is not contracted
//                                into an FMA and exp is expf (not __expf),
//                                so expf's argument is the plain version's
//                                bits. G = EXPD_LANES lanes (a warp) own a
//                                row, each takes whole entries (one in
//                                flight), loads the row's m once and
//                                stores each entry's E heads at k * n + e:
//                                consecutive lanes hold consecutive
//                                entries, so each head's stores coalesce. The first port's
//                                kernel (a thread a plan slot, padded slots
//                                written as zeros, scalar score loads, read
//                                through the slot map by B3 and B10) is
//                                retired.
//
// Its max is that of an order on the bits: a NaN above everything, then
// the numbers with +0.0 above -0.0 (the integer key of max_key). Values
// match the CPU's scatter_reduce_ amax, which the plain versions take, NaN
// included; where a row's max is a zero of either sign, the kernel stores
// +0.0 and the plain version the sign of the row's first zero. The max
// does not depend on the order of its operands, so G lanes own a row,
// each folds whole entries (one in flight) into E running maxes, the group
// folds them with __shfl_xor_sync, and lane 0 stores the row's E columns
// once: no fill, no atomics, no padded slot, the same bits every launch.
// A column tile (blockIdx.y) is one lane unit of E columns of a row (16 B
// where the width and the table's alignment allow; for B11 one unit of
// each score half). The first port's kernels are retired: B11's shared
// [128, K] tile and global atomic max a cell into a NEG fill, B15's
// atomics a run into a -inf fill and its nan_to_num_ launch.
//
// Design. The TPU kernels build one-hot matmuls and accumulate each output
// block on its first visit, walking every padded or sentinel slot. Here a
// group of G lanes owns one output row: it loads its row's entries with one
// coalesced load each, gathers their scales, broadcasts them within the
// group (__shfl_sync with width G) and gathers IN_FLIGHT = 8 table rows per
// lane into registers before their FMAs (register unrolling, not a cp.async
// ring: each value is used once, so a ring would only add a trip through
// shared memory and its waits; 16 in flight doubled the narrow path's
// registers and slowed it). The sum is f32 in registers, in the row's slot
// order, and each output element is stored exactly once (0 for a row
// without entries): no shared tile, no atomics, no zero-fill, and the same
// sum order on every run. A row of 32 or more lane units takes a whole warp
// (G = 32); a shorter one takes G = the next power of two of its units, and
// a warp owns 32 / G rows (QM9's H = 128 bf16 rows: 16 vectors, two rows a
// warp; B12's [., 4] f32 rows: one vector, 32 rows a warp). The groups of a
// warp walk their rows in lockstep, for as many rounds as the warp's
// longest row needs; a group whose row has ended is masked. In-degrees are
// even (PPI: mean 29 into a target, 8.7 out of a source; QM9: 3.2, 0.6), so
// the lockstep costs little.
//
// Loads. A lane unit is 16 bytes (8 bf16 or 4 f32 columns), 8 bytes (4 bf16
// or 2 f32; B12's bf16 rows of 648 B) or one element, the widest that
// divides the row (h * itemsize), the row stride (ld * itemsize) and the
// table's address; the output must be 16-byte aligned for the vector
// units. A lane holds up to 2 16-byte (3 in head_rows_kernel), 3 8-byte or
// 4 element units of a row; wider rows take more column tiles (gridDim.y),
// each walking the row's entries again. Lanes past H are masked; the table is not padded,
// and its rows may be strided (a row-strided view is not copied).
//
// Why not the tensor cores or TMA. There is no dense product: each gathered
// element takes one multiply-add, 2 flops per element, far below the card's
// ridge. Hopper's TMA copies tiles and has no row-gather mode, so the
// gathers are per-lane loads.
//
// Bound. B11 and B15: the distinct score halves (B11) or value rows (B15)
// the entries read, 4 B an entry's src_row, 4 B a row pointer and the f32
// output written once (B11 also the f32 init); bytes bound them. Rows
// are short (PPI: 8.7 entries into a target on one type's plan, 26 on the
// merged and the sorted plans): G = 8 (MAX_LANES) ran fastest of 4, 8, 16
// and 32 on an H100 at all three (tools/max_rows_lanes.py, PERF.md). B8:
// B11's reads with the f32 m rows of the rows that have entries in place
// of the init, and 4K B written an entry; bytes bound it, mostly its
// output and src_row. It has no fold across lanes, and a warp a row
// (EXPD_LANES = 32) ran fastest.
//
// Bound. Bytes: the distinct table rows the entries read, 8 B an entry
// (its row and its scale; 4 B for B12, which reads no scale, and for B14,
// whose row is its slot; 4 K B more of expd for B10 and B14), 4 B an output
// row pointer and the f32 outputs written once; 2 flops per entry and
// column (1 for B12). Bytes bound it. The pair tables fit in the 50 MB L2 (PPI
// [24192, 320] bf16 15.5 MB, QM9 [81920, 128] bf16 21 MB), so their gathers
// wait on L2 latency; B12's streams (bf16 [311296, 324] 202 MB, the
// cotangent [245760, 324] 159 MB) and B14's (f32 [245760, 324], 318 MB)
// do not, so their rows come from HBM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <limits>
#include <type_traits>

#include "lane_units.cuh"

namespace {

constexpr int IN_FLIGHT = 8;                 // row gathers before their FMAs
// head_rows_kernel's: with up to 3 16-byte units a lane (B14's f32 rows of
// 320 in one column tile), 2 in flight ran faster on an H100 than 4 or 8
// (127 registers at 2 units a lane) (PERF.md).
constexpr int HEAD_IN_FLIGHT = 2;

struct RowArgs {
  const void* table;
  int ld_units;             // the table's row stride, in lane units (32
                            // bits: a 64-bit stride cost B3 12 registers)
  int h;
  const float* scale;       // null: every entry's scale is 1
  const int32_t* row_ptr;   // [out_rows + 1]
  const int32_t* src_row;   // [n] table rows
  const int32_t* slot;      // [n] plan slots (the scale's index); null:
                            // the scale is by entry (scale[e])
  int64_t out_rows;
  float* out;               // [out_rows, h]
};

// G lanes own a row (32 / G rows a warp); W units a lane in this column
// tile (blockIdx.y).
template <typename T, int UB, int G, int W>
__global__ void __launch_bounds__(ROW_THREADS) row_owner_kernel(RowArgs a) {
  using U = Unit<T, UB>;
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: a power of 2");
  constexpr int kRows = 32 / G;                          // rows a warp
  constexpr int kRound = G > IN_FLIGHT ? G : IN_FLIGHT;  // entries a round
  constexpr int kPer = kRound / G;                       // ... a lane
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);  // the lane in its group
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * ROW_WARPS + (threadIdx.x >> 5))
      * kRows;
  if (first >= a.out_rows) return;  // warp-uniform
  const int64_t row = first + lane / G;
  const bool live = row < a.out_rows;
  const int units = a.h / U::kElems;  // per table row
  const int unit0 = blockIdx.y * G * W + sub;

  float acc[W][U::kElems];
#pragma unroll
  for (int k = 0; k < W; ++k)
#pragma unroll
    for (int e = 0; e < U::kElems; ++e) acc[k][e] = 0.0f;

  const int begin = live ? __ldg(a.row_ptr + row) : 0;
  const int len = live ? __ldg(a.row_ptr + row + 1) - begin : 0;
  // The warp's longest row sets its rounds (warp-uniform).
  const int most = kRows == 1 ? len : __reduce_max_sync(FULL, len);
  for (int base = 0; base < most; base += kRound) {
    const int count = len - base;  // this row's entries left; may be <= 0
    // Entry j of the round sits in lane j % G of the group, register j / G.
    int src[kPer];
    float sc[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = sub + G * i;
      src[i] = 0;
      sc[i] = 0.0f;
      if (j < count) {
        const int e = begin + base + j;
        src[i] = __ldg(a.src_row + e);
        sc[i] = a.scale ? __ldg(a.scale + (a.slot ? __ldg(a.slot + e) : e))
                        : 1.0f;
      }
    }
    const int trips = min(kRound, most - base);  // warp-uniform
    // With G >= IN_FLIGHT, j0 is a multiple of IN_FLIGHT (which divides G)
    // below trips <= G, so j0 + u < G; with G < IN_FLIGHT, trips <=
    // IN_FLIGHT and j0 is 0. Every shuffle reads a lane of the group.
    for (int j0 = 0; j0 < trips; j0 += IN_FLIGHT) {
      typename U::Raw val[IN_FLIGHT][W];
      float c[IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int reg = G >= IN_FLIGHT ? 0 : u / G;
        const int from = G >= IN_FLIGHT ? j0 + u : u % G;
        const int64_t r = __shfl_sync(FULL, src[reg], from, G);
        c[u] = __shfl_sync(FULL, sc[reg], from, G);
        const bool ok = j0 + u < count;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int unit = unit0 + G * k;
          val[u][k] = (ok && unit < units)
                          ? U::load(a.table, r * a.ld_units + unit)
                          : U::zero();
        }
      }
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        if (j0 + u >= count) break;  // uniform within the group
#pragma unroll
        for (int k = 0; k < W; ++k) U::fma(acc[k], val[u][k], c[u]);
      }
    }
  }
  if (!live) return;

  float* out_row = a.out + row * a.h;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int unit = unit0 + G * k;
    if (unit >= units) continue;
    store_f32<U::kElems>(out_row + static_cast<int64_t>(unit) * U::kElems,
                         acc[k]);
  }
}

struct HeadArgs {
  const void* table;
  int ld_units;             // the table's row stride, in lane units
  int h;
  int k;                    // heads: column c takes head c % k
  const float* expd;        // entry (slot s, head j) at
  int64_t head_stride;      //   j * head_stride + s * slot_stride
  int64_t slot_stride;
  const int32_t* row_ptr;   // [out_rows + 1]
  const int32_t* src_row;   // [n] table rows
  const int32_t* slot;      // [n] plan slots (expd's index); null: expd
                            // is by entry (s = e)
  int64_t out_rows;
  float* out;               // [out_rows, h]
  float* denom;             // [out_rows, k]
};

// row_owner_kernel with a scale per head (B10, B14): G lanes own a row, W
// units a lane in this column tile; lanes sub < k load head sub's expd of
// each entry, and element i of the lane's units takes head from[i].
template <typename T, int UB, int G, int W>
__global__ void __launch_bounds__(ROW_THREADS) head_rows_kernel(HeadArgs a) {
  using U = Unit<T, UB>;
  constexpr int E = U::kElems;
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: a power of 2");
  constexpr int kRows = 32 / G;
  constexpr int kRound = G > HEAD_IN_FLIGHT ? G : HEAD_IN_FLIGHT;
  constexpr int kPer = kRound / G;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * ROW_WARPS + (threadIdx.x >> 5))
      * kRows;
  if (first >= a.out_rows) return;  // warp-uniform
  const int64_t row = first + lane / G;
  const bool live = row < a.out_rows;
  const int units = a.h / E;
  const int unit0 = blockIdx.y * G * W + sub;
  // The launcher keeps every unit of a lane on one head pattern (k divides
  // G * E, or W = 1), so the heads of unit0 serve all of them.
  int from[E];
#pragma unroll
  for (int i = 0; i < E; ++i) from[i] = (unit0 * E + i) % a.k;
  const bool head_lane = sub < a.k;
  const int64_t head_off = static_cast<int64_t>(sub) * a.head_stride;

  float acc[W][E];
#pragma unroll
  for (int k = 0; k < W; ++k)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[k][e] = 0.0f;
  float dsum = 0.0f;

  const int begin = live ? __ldg(a.row_ptr + row) : 0;
  const int len = live ? __ldg(a.row_ptr + row + 1) - begin : 0;
  const int most = kRows == 1 ? len : __reduce_max_sync(FULL, len);
  for (int base = 0; base < most; base += kRound) {
    const int count = len - base;  // this row's entries left; may be <= 0
    int src[kPer], sl[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = sub + G * i;
      src[i] = 0;
      sl[i] = 0;
      if (j < count) {
        const int e = begin + base + j;
        src[i] = __ldg(a.src_row + e);
        sl[i] = a.slot ? __ldg(a.slot + e) : e;
      }
    }
    const int trips = min(kRound, most - base);  // warp-uniform
    for (int j0 = 0; j0 < trips; j0 += HEAD_IN_FLIGHT) {
      typename U::Raw val[HEAD_IN_FLIGHT][W];
      float e[HEAD_IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < HEAD_IN_FLIGHT; ++u) {
        const int reg = G >= HEAD_IN_FLIGHT ? 0 : u / G;
        const int from_lane = G >= HEAD_IN_FLIGHT ? j0 + u : u % G;
        const int64_t r = __shfl_sync(FULL, src[reg], from_lane, G);
        const int64_t s = __shfl_sync(FULL, sl[reg], from_lane, G);
        const bool ok = j0 + u < count;
        e[u] = (ok && head_lane)
                   ? __ldg(a.expd + head_off + s * a.slot_stride)
                   : 0.0f;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int unit = unit0 + G * k;
          val[u][k] = (ok && unit < units)
                          ? U::load(a.table, r * a.ld_units + unit)
                          : U::zero();
        }
      }
      // Entries past a group's row hold zeros (e and the units), so their
      // FMAs add +0 and leave the sums' bits; the shuffles below need the
      // whole warp, so the loop ends where the warp's longest row does.
#pragma unroll
      for (int u = 0; u < HEAD_IN_FLIGHT; ++u) {
        if (j0 + u >= trips) break;  // warp-uniform
        dsum += e[u];
        float eh[E];
#pragma unroll
        for (int i = 0; i < E; ++i) {
          eh[i] = __shfl_sync(FULL, e[u], from[i], G);
        }
#pragma unroll
        for (int k = 0; k < W; ++k) U::fma_each(acc[k], val[u][k], eh);
      }
    }
  }
  if (!live) return;

  float* out_row = a.out + row * a.h;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int unit = unit0 + G * k;
    if (unit >= units) continue;
    store_f32<E>(out_row + static_cast<int64_t>(unit) * E, acc[k]);
  }
  if (head_lane && blockIdx.y == 0) a.denom[row * a.k + sub] = dsum;
}

struct MaxArgs {
  const void* table;        // B11: scores [rows, 2k]; B15: values [slots, ld]
  int64_t ld_units;         // the table's row stride, in lane units
  int k;                    // heads (B11) or columns (B15)
  int rows;                 // B11: the table's rows (a score row's clip)
  int vs;                   // B11: one type's source rows
  const float* init;        // B11: [out_rows, k] or null
  const int32_t* row_ptr;   // [out_rows + 1]
  const int32_t* src_row;   // [n]: B11 the source row u, B15 the slot
  int64_t out_rows;
  float* out;               // [out_rows, k]
};

constexpr float NEG = -1e30f;  // B11's stabiliser of a target with no entry
constexpr float LEAKY_SLOPE = 0.2f;
constexpr int MAX_LANES = 8;   // max_rows_kernel's G, lanes a row
// expd_rows_kernel's G. Its lanes share nothing, so more of a row's
// entries are in flight with more lanes: on an H100 (PERF.md,
// tools/max_rows_lanes.py) 32 ran fastest of 4, 8, 16 and 32 on the merged
// and one type's plans.
constexpr int EXPD_LANES = 32;

// The max's order on the bits: NaN above everything, then the numbers,
// +0.0 above -0.0 (a negative float's key flips its magnitude bits).
__device__ __forceinline__ int max_key(float x) {
  const int i = __float_as_int(x);
  return isnan(x) ? 0x7fffffff : (i >= 0 ? i : i ^ 0x7fffffff);
}

__device__ __forceinline__ float max_of(float a, float b) {
  return max_key(b) > max_key(a) ? b : a;
}

// B11's and B8's logits of one compact-form entry: the E heads of lane
// unit `tile` of leaky(ss[u] + ts[clip((u / vs) * vs + row, rows)]) over
// the packed scores (k / E units a half). Neither step is contracted into
// an FMA with the caller's next one.
template <typename T, int UB>
__device__ __forceinline__ void pair_logits(const void* scores,
                                            int64_t ld_units, int k,
                                            int rows, int vs, int u,
                                            int64_t row, int tile, float* x) {
  using U = Unit<T, UB>;
  constexpr int E = U::kElems;
  U::unpack(U::load(scores, u * ld_units + tile), x);
  const int64_t r = clip(static_cast<int64_t>(u / vs) * vs + row, rows);
  float y[E];
  U::unpack(U::load(scores, r * ld_units + k / E + tile), y);
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float p = __fadd_rn(x[i], y[i]);
    x[i] = p >= 0.0f ? p : __fmul_rn(LEAKY_SLOPE, p);
  }
}

// G lanes own a row (32 / G rows a warp); column tile blockIdx.y is one
// lane unit of E columns. PAIR: B11's logits of two score halves; else
// B15's values.
template <typename T, int UB, int G, bool PAIR>
__global__ void __launch_bounds__(ROW_THREADS) max_rows_kernel(MaxArgs a) {
  using U = Unit<T, UB>;
  constexpr int E = U::kElems;
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: a power of 2");
  constexpr int kRows = 32 / G;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * ROW_WARPS + (threadIdx.x >> 5))
      * kRows;
  if (first >= a.out_rows) return;  // warp-uniform
  const int64_t row = first + lane / G;
  const bool live = row < a.out_rows;
  const int tile = blockIdx.y;

  float m[E];
#pragma unroll
  for (int i = 0; i < E; ++i) m[i] = PAIR ? NEG : __uint_as_float(0xff800000u);
  if (live) {
    const int end = __ldg(a.row_ptr + row + 1);
    for (int e = __ldg(a.row_ptr + row) + sub; e < end; e += G) {
      const int u = __ldg(a.src_row + e);
      float x[E];
      if constexpr (PAIR) {
        pair_logits<T, UB>(a.table, a.ld_units, a.k, a.rows, a.vs, u, row,
                           tile, x);
      } else {
        U::unpack(U::load(a.table, u * a.ld_units + tile), x);
      }
#pragma unroll
      for (int i = 0; i < E; ++i) m[i] = max_of(m[i], x[i]);
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < E; ++i)
      m[i] = max_of(m[i], __shfl_xor_sync(FULL, m[i], off));
  }
  if (!live || sub != 0) return;

  const int64_t at = row * a.k + static_cast<int64_t>(tile) * E;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    if constexpr (PAIR) {
      if (a.init) m[i] = max_of(__ldg(a.init + at + i), m[i]);
    } else {
      if (!isfinite(m[i])) m[i] = 0.0f;
    }
  }
  store_f32<E>(a.out + at, m);
}

struct ExpdArgs {
  const void* scores;       // [rows, 2k]
  int64_t ld_units;         // the scores' row stride, in lane units
  int k;
  int rows;
  int vs;
  const float* maxes;       // [out_rows, k], the stabiliser
  const int32_t* row_ptr;   // [out_rows + 1]
  const int32_t* src_row;   // [n] the source row u
  int64_t n;
  int64_t out_rows;
  float* out;               // [k, n], by entry
};

// G lanes own a row (32 / G rows a warp), each taking whole entries; column
// tile blockIdx.y is one lane unit of E heads of each score half. No lane
// shuffles, so a lane leaves as soon as its row has no entry left for it.
template <typename T, int UB, int G>
__global__ void __launch_bounds__(ROW_THREADS) expd_rows_kernel(ExpdArgs a) {
  constexpr int E = Unit<T, UB>::kElems;
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: a power of 2");
  constexpr int kRows = 32 / G;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * ROW_WARPS + (threadIdx.x >> 5))
          * kRows + lane / G;
  if (row >= a.out_rows) return;
  const int end = __ldg(a.row_ptr + row + 1);
  int e = __ldg(a.row_ptr + row) + (lane & (G - 1));
  if (e >= end) return;
  const int tile = blockIdx.y;
  float m[E];
#pragma unroll
  for (int i = 0; i < E; ++i)
    m[i] = __ldg(a.maxes + row * a.k + static_cast<int64_t>(tile) * E + i);
  float* out = a.out + static_cast<int64_t>(tile) * E * a.n;
  for (; e < end; e += G) {
    float x[E];
    pair_logits<T, UB>(a.scores, a.ld_units, a.k, a.rows, a.vs,
                       __ldg(a.src_row + e), row, tile, x);
#pragma unroll
    for (int i = 0; i < E; ++i) out[i * a.n + e] = expf(__fsub_rn(x[i], m[i]));
  }
}

template <typename T, int UB, int G, int W, typename A>
void launch_one(dim3 grid, cudaStream_t s, const A& a) {
  if constexpr (std::is_same_v<A, HeadArgs>) {
    head_rows_kernel<T, UB, G, W><<<grid, ROW_THREADS, 0, s>>>(a);
  } else {
    row_owner_kernel<T, UB, G, W><<<grid, ROW_THREADS, 0, s>>>(a);
  }
}

// A whole warp a row, w <= W units a lane.
template <typename T, int UB, int W, typename A>
void launch_wide(int w, dim3 grid, cudaStream_t s, const A& a) {
  if (w >= W) {
    launch_one<T, UB, 32, W>(grid, s, a);
  } else if constexpr (W > 1) {
    launch_wide<T, UB, W - 1>(w, grid, s, a);
  }
}

template <typename T, int UB, int MAX_W, typename A>
void launch_by_lanes(int g, int w, dim3 grid, cudaStream_t s, const A& a) {
  switch (g) {
    case 1: launch_one<T, UB, 1, 1>(grid, s, a); break;
    case 2: launch_one<T, UB, 2, 1>(grid, s, a); break;
    case 4: launch_one<T, UB, 4, 1>(grid, s, a); break;
    case 8: launch_one<T, UB, 8, 1>(grid, s, a); break;
    case 16: launch_one<T, UB, 16, 1>(grid, s, a); break;
    default: launch_wide<T, UB, MAX_W>(w, grid, s, a); break;
  }
}

// The widest unit first; an element-wide unit holds up to 4 a lane.
template <typename T, typename A>
void launch_by_unit(int ub, int g, int w, dim3 grid, cudaStream_t s,
                    const A& a) {
  if (ub == 16) {
    launch_by_lanes<T, 16, std::is_same_v<A, HeadArgs> ? 3 : 2>(g, w, grid,
                                                                 s, a);
  } else if (ub == 8) {
    launch_by_lanes<T, 8, 3>(g, w, grid, s, a);
  } else {
    launch_by_lanes<T, static_cast<int>(sizeof(T)), 4>(g, w, grid, s, a);
  }
}

// dtype codes shared with the Python wrappers.
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

// The lane unit (bytes), the lanes a row (g) and the units a lane (w) of
// a row of h elements: the widest unit that divides the row, the row stride
// and the table's address (and keeps the f32 output's vector stores
// aligned); g the next power of two of the row's units, at least min_g; a
// whole warp holds up to max_w16 16-byte (2 in row_owner_kernel, 3 in
// head_rows_kernel), 3 8-byte or 4 element units a lane.
struct Lanes {
  int ub, units, g, w;
};

Lanes choose_lanes(int itemsize, int64_t ld, int h, const void* table,
                   const float* out, int min_g, int max_w16) {
  auto fits = [&](int ub) {
    return static_cast<int64_t>(h) * itemsize % ub == 0
           && ld * itemsize % ub == 0 && aligned(table, ub)
           && aligned(out, 16);
  };
  Lanes l;
  l.ub = fits(16) ? 16 : (fits(8) ? 8 : itemsize);
  l.units = h * itemsize / l.ub;
  const int max_w = l.ub == 16 ? max_w16 : (l.ub == 8 ? 3 : 4);
  l.g = 1;
  while (l.g < 32 && (l.g < l.units || l.g < min_g)) l.g *= 2;
  l.w = l.g == 32 ? min((l.units + 31) / 32, max_w) : 1;
  return l;
}

dim3 row_grid(int64_t out_rows, const Lanes& l) {
  const int64_t rows_per_block = static_cast<int64_t>(ROW_WARPS) * (32 / l.g);
  return dim3(
      static_cast<unsigned>((out_rows + rows_per_block - 1) / rows_per_block),
      (l.units + l.g * l.w - 1) / (l.g * l.w));
}

template <typename A>
int launch_rows(int dtype, const Lanes& l, dim3 grid, void* stream,
                const A& a) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    launch_by_unit<float>(l.ub, l.g, l.w, grid, s, a);
  } else {
    launch_by_unit<__nv_bfloat16>(l.ub, l.g, l.w, grid, s, a);
  }
  return static_cast<int>(cudaGetLastError());
}

int row_owner_launch(int device, int dtype, const void* table, int64_t ld,
                     int h, const float* scale, const int32_t* row_ptr,
                     const int32_t* src_row, const int32_t* slot,
                     int64_t out_rows, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h <= 0 || ld < h || out_rows <= 0
      || (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int itemsize = dtype == DTYPE_F32 ? 4 : 2;
  const Lanes l = choose_lanes(itemsize, ld, h, table, out, 1, 2);
  if (ld * itemsize / l.ub > std::numeric_limits<int>::max())
    return static_cast<int>(cudaErrorInvalidValue);
  const RowArgs a{table, static_cast<int>(ld * itemsize / l.ub), h, scale,
                  row_ptr, src_row, slot, out_rows, out};
  return launch_rows(dtype, l, row_grid(out_rows, l), stream, a);
}

int head_rows_launch(int device, int dtype, const void* table, int64_t ld,
                     int h, int k, const float* expd, int64_t head_stride,
                     int64_t slot_stride, const int32_t* row_ptr,
                     const int32_t* src_row, const int32_t* slot,
                     int64_t out_rows, float* out, float* denom,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h <= 0 || ld < h || out_rows <= 0 || k <= 0 || k > 32 || h % k
      || !expd || !denom || (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int itemsize = dtype == DTYPE_F32 ? 4 : 2;
  // A group holds at least k lanes, one to load each head.
  Lanes l = choose_lanes(itemsize, ld, h, table, out, k, 3);
  if (ld * itemsize / l.ub > std::numeric_limits<int>::max())
    return static_cast<int>(cudaErrorInvalidValue);
  // Where k does not divide g * E (k not a power of two), the heads of a
  // lane's units differ: one unit a lane, and more column tiles.
  if (l.g * (l.ub / itemsize) % k) l.w = 1;
  const HeadArgs a{table, static_cast<int>(ld * itemsize / l.ub), h, k,
                   expd, head_stride, slot_stride, row_ptr, src_row, slot,
                   out_rows, out, denom};
  return launch_rows(dtype, l, row_grid(out_rows, l), stream, a);
}

// Calls go(the widest lane unit, at most 16 bytes, whose columns divide k
// and the row stride ld and whose size the table's address is aligned to),
// as a std::integral_constant of its bytes.
template <typename T, typename F>
void by_unit(int k, int64_t ld, const void* table, F&& go) {
  auto fits = [&](int e) {
    return k % e == 0 && ld % e == 0
           && aligned(table, e * static_cast<int>(sizeof(T)));
  };
  if (fits(16 / sizeof(T))) {
    go(std::integral_constant<int, 16>());
  } else if (fits(8 / sizeof(T))) {
    go(std::integral_constant<int, 8>());
  } else if constexpr (sizeof(T) == 2) {
    if (fits(2)) {
      go(std::integral_constant<int, 4>());
    } else {
      go(std::integral_constant<int, 2>());
    }
  } else {
    go(std::integral_constant<int, 4>());
  }
}

template <bool PAIR, typename T>
void launch_max(dim3 grid_rows, cudaStream_t s, MaxArgs a, int64_t ld) {
  by_unit<T>(a.k, ld, a.table, [&](auto unit) {
    constexpr int UB = decltype(unit)::value;
    constexpr int E = UB / static_cast<int>(sizeof(T));
    a.ld_units = ld / E;
    const dim3 grid(grid_rows.x, a.k / E);
    max_rows_kernel<T, UB, MAX_LANES, PAIR><<<grid, ROW_THREADS, 0, s>>>(a);
  });
}

// One block a ROW_WARPS * (32 / lanes) rows.
dim3 lanes_grid(int64_t out_rows, int lanes) {
  const int64_t rows_per_block =
      static_cast<int64_t>(ROW_WARPS) * (32 / lanes);
  return dim3(static_cast<unsigned>(
      (out_rows + rows_per_block - 1) / rows_per_block));
}

// B11 (pair) and B15: f32 [out_rows, k], every element stored once.
int max_rows_launch(bool pair, int device, int dtype, const void* table,
                    int64_t ld, int64_t rows, int k, int vs,
                    const float* init, const int32_t* row_ptr,
                    const int32_t* src_row, int64_t out_rows, float* out,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k <= 0 || out_rows <= 0 || rows <= 0
      || rows > std::numeric_limits<int>::max()
      || !aligned(out, 16)
      || (pair ? (ld != 2 * k || vs <= 0 || k > 32) : (ld < k || init))
      || (dtype != DTYPE_F32 && (pair ? dtype != DTYPE_BF16 : true)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = lanes_grid(out_rows, MAX_LANES);
  const MaxArgs a{table, 0, k, static_cast<int>(rows), vs, init, row_ptr,
                  src_row, out_rows, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!pair) {
    launch_max<false, float>(grid, s, a, ld);
  } else if (dtype == DTYPE_F32) {
    launch_max<true, float>(grid, s, a, ld);
  } else {
    launch_max<true, __nv_bfloat16>(grid, s, a, ld);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
void launch_expd(cudaStream_t s, ExpdArgs a) {
  by_unit<T>(a.k, 2 * static_cast<int64_t>(a.k), a.scores, [&](auto unit) {
    constexpr int UB = decltype(unit)::value;
    constexpr int E = UB / static_cast<int>(sizeof(T));
    a.ld_units = 2 * a.k / E;
    const dim3 grid(lanes_grid(a.out_rows, EXPD_LANES).x, a.k / E);
    expd_rows_kernel<T, UB, EXPD_LANES><<<grid, ROW_THREADS, 0, s>>>(a);
  });
}

// B8: f32 [k, n] by entry, every element stored once.
int expd_rows_launch(int device, int dtype, const void* scores, int64_t rows,
                     int k, int vs, const float* maxes,
                     const int32_t* row_ptr, const int32_t* src_row,
                     int64_t n, int64_t out_rows, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k <= 0 || k > 32 || 32 % k || out_rows <= 0 || rows <= 0
      || rows > std::numeric_limits<int>::max() || vs <= 0 || n < 0
      || !maxes || (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const ExpdArgs a{scores, 0, k, static_cast<int>(rows), vs, maxes, row_ptr,
                   src_row, n, out_rows, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    launch_expd<float>(s, a);
  } else {
    launch_expd<__nv_bfloat16>(s, a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, one per TPU kernel and one for B9's second pass, all with
// one signature (scale is null for B12 and B9; slot is null where the scale
// is by entry, as B3's in RGAT's head-major sums). Each returns the
// cudaError_t of its launch (cudaGetLastError right after it); 0 is
// success.

#define DEFINE_LAUNCH(NAME)                                                   \
  extern "C" int NAME(int device, int dtype, const void* table, int64_t ld,  \
                      int h, const float* scale, const int32_t* row_ptr,      \
                      const int32_t* src_row, const int32_t* slot,            \
                      int64_t out_rows, float* out, void* stream) {           \
    return row_owner_launch(device, dtype, table, ld, h, scale, row_ptr,      \
                            src_row, slot, out_rows, out, stream);            \
  }

DEFINE_LAUNCH(pair_stream_launch)
DEFINE_LAUNCH(pair_stream_joint_launch)
DEFINE_LAUNCH(pair_spmm_launch)
DEFINE_LAUNCH(sorted_segment_sum_launch)
DEFINE_LAUNCH(pair_attention_ts_launch)

// B10 and B14: head_rows_kernel, one signature (expd's element (slot s,
// head j) at j * head_stride + s * slot_stride, s = e where slot is null;
// weighted [out_rows, h] and denom [out_rows, k] in f32, every element
// stored once).
#define DEFINE_HEAD_LAUNCH(NAME)                                              \
  extern "C" int NAME(int device, int dtype, const void* table, int64_t ld,  \
                      int h, int k, const float* expd, int64_t head_stride,   \
                      int64_t slot_stride, const int32_t* row_ptr,            \
                      const int32_t* src_row, const int32_t* slot,            \
                      int64_t out_rows, float* out, float* denom,             \
                      void* stream) {                                         \
    return head_rows_launch(device, dtype, table, ld, h, k, expd,             \
                            head_stride, slot_stride, row_ptr, src_row, slot, \
                            out_rows, out, denom, stream);                    \
  }

DEFINE_HEAD_LAUNCH(pair_attention_agg_launch)
DEFINE_HEAD_LAUNCH(attention_scatter_launch)

// B11 and B15: max_rows_kernel, one signature (table rows of ld elements;
// B11: rows, vs and an optional f32 init [out_rows, k], its table the
// [rows, 2k] scores; B15: f32 values, vs 0 and no init).
#define DEFINE_MAX_LAUNCH(NAME, PAIR)                                         \
  extern "C" int NAME(int device, int dtype, const void* table, int64_t ld,  \
                      int64_t rows, int k, int vs, const float* init,         \
                      const int32_t* row_ptr, const int32_t* src_row,         \
                      int64_t out_rows, float* out, void* stream) {           \
    return max_rows_launch(PAIR, device, dtype, table, ld, rows, k, vs,       \
                           init, row_ptr, src_row, out_rows, out, stream);    \
  }

DEFINE_MAX_LAUNCH(pair_attention_max_launch, true)
DEFINE_MAX_LAUNCH(sorted_segment_max_launch, false)

// B8: expd_rows_kernel over the forward compact form (scores [rows, 2k],
// the f32 stabiliser [out_rows, k]; expd f32 [k, n], n the form's entries).
extern "C" int pair_attention_expd_launch(
    int device, int dtype, const void* scores, int64_t rows, int k, int vs,
    const float* maxes, const int32_t* row_ptr, const int32_t* src_row,
    int64_t n, int64_t out_rows, float* out, void* stream) {
  return expd_rows_launch(device, dtype, scores, rows, k, vs, maxes, row_ptr,
                          src_row, n, out_rows, out, stream);
}

extern "C" const char* pair_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
