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
// passes none). Its C entries:
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
//                                denominators), with that head's expd row as
//                                the scale; the probes P1/P2 run it on their
//                                plans. Unlike the TPU kernel, which rounds
//                                onehot * scale to the table dtype, the scale
//                                stays f32, as in the jnp twin.
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
// units. A lane holds up to 2 16-byte, 3 8-byte or 4 element units of a
// row; wider rows take more column tiles (gridDim.y), each walking the
// row's entries again. Lanes past H are masked; the table is not padded,
// and its rows may be strided (a row-strided view is not copied).
//
// Why not the tensor cores or TMA. There is no dense product: each gathered
// element takes one multiply-add, 2 flops per element, far below the card's
// ridge. Hopper's TMA copies tiles and has no row-gather mode, so the
// gathers are per-lane loads.
//
// Bound. Bytes: the distinct table rows the entries read, 8 B an entry
// (its row and its scale; 4 B for B12, which reads no scale), 4 B an output
// row pointer and the f32 output written once; 2 flops per entry and column
// (1 for B12). Bytes bound it. The pair tables fit in the 50 MB L2 (PPI
// [24192, 320] bf16 15.5 MB, QM9 [81920, 128] bf16 21 MB), so their gathers
// wait on L2 latency; B12's streams (bf16 [311296, 324] 202 MB, the
// cotangent [245760, 324] 159 MB) do not, so its rows come from HBM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <limits>

#include "lane_units.cuh"

namespace {

constexpr int IN_FLIGHT = 8;                 // row gathers before their FMAs

struct RowArgs {
  const void* table;
  int ld_units;             // the table's row stride, in lane units (32
                            // bits: a 64-bit stride cost B3 12 registers)
  int h;
  const float* scale;       // null: every entry's scale is 1
  const int32_t* row_ptr;   // [out_rows + 1]
  const int32_t* src_row;   // [n] table rows
  const int32_t* slot;      // [n] plan slots (the scale's index)
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
        sc[i] = a.scale ? __ldg(a.scale + __ldg(a.slot + e)) : 1.0f;
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

template <typename T, int UB, int G, int W>
void launch_one(dim3 grid, cudaStream_t s, const RowArgs& a) {
  row_owner_kernel<T, UB, G, W><<<grid, ROW_THREADS, 0, s>>>(a);
}

// A whole warp a row, w <= W units a lane.
template <typename T, int UB, int W>
void launch_wide(int w, dim3 grid, cudaStream_t s, const RowArgs& a) {
  if (w >= W) {
    launch_one<T, UB, 32, W>(grid, s, a);
  } else if constexpr (W > 1) {
    launch_wide<T, UB, W - 1>(w, grid, s, a);
  }
}

template <typename T, int UB, int MAX_W>
void launch_by_lanes(int g, int w, dim3 grid, cudaStream_t s,
                     const RowArgs& a) {
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
template <typename T>
void launch_by_unit(int ub, int g, int w, dim3 grid, cudaStream_t s,
                    const RowArgs& a) {
  if (ub == 16) {
    launch_by_lanes<T, 16, 2>(g, w, grid, s, a);
  } else if (ub == 8) {
    launch_by_lanes<T, 8, 3>(g, w, grid, s, a);
  } else {
    launch_by_lanes<T, static_cast<int>(sizeof(T)), 4>(g, w, grid, s, a);
  }
}

// dtype codes shared with the Python wrappers.
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

int row_owner_launch(int device, int dtype, const void* table, int64_t ld,
                     int h, const float* scale, const int32_t* row_ptr,
                     const int32_t* src_row, const int32_t* slot,
                     int64_t out_rows, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h <= 0 || ld < h || out_rows <= 0 || (scale && !slot)
      || (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int itemsize = dtype == DTYPE_F32 ? 4 : 2;
  auto fits = [&](int ub) {
    return static_cast<int64_t>(h) * itemsize % ub == 0
           && ld * itemsize % ub == 0 && aligned(table, ub)
           && aligned(out, 16);
  };
  const int ub = fits(16) ? 16 : (fits(8) ? 8 : itemsize);
  if (ld * itemsize / ub > std::numeric_limits<int>::max())
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = h * itemsize / ub;
  const int max_w = ub == 16 ? 2 : (ub == 8 ? 3 : 4);
  int g = 1;
  while (g < 32 && g < units) g *= 2;
  const int w = g == 32 ? min((units + 31) / 32, max_w) : 1;
  const RowArgs a{table, static_cast<int>(ld * itemsize / ub), h, scale,
                  row_ptr, src_row, slot, out_rows, out};
  const int64_t rows_per_block = static_cast<int64_t>(ROW_WARPS) * (32 / g);
  const dim3 grid(
      static_cast<unsigned>((out_rows + rows_per_block - 1) / rows_per_block),
      (units + g * w - 1) / (g * w));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    launch_by_unit<float>(ub, g, w, grid, s, a);
  } else {
    launch_by_unit<__nv_bfloat16>(ub, g, w, grid, s, a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, one per TPU kernel and one for B9's second pass, all with
// one signature (scale is null for B12 and B9). Each returns the
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

extern "C" const char* pair_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
