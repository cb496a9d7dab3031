// Relu-pair kernels of the target-state edge MLP with one hidden layer, for
// Hopper (sm_90a), bound through a plain C interface (ctypes) by
// tf2_gnn_tpu_torch/ops/pair_edge_mlp.py. All four read a MERGED-TARGET pair
// plan (ops/pair_spmm.py::build_pair_plans(merge_targets=True)): per slot s
// of group g (chunk c = s / E_C), padded where rel >= BLK,
//
//   src = src_blk[c] * BLK + rel_src[s],   tgt = grp_tgt[g] * BLK + rel_tgt[s],
//
// with A the stacked per-type source halves [L*S, H] and B the target halves
// [L*V, H] in merged-target layout, whose row space IS the forward plan's
// output row space. They compute the plan-slot semantics of the JAX
// package's jnp twins (tf2_gnn_tpu/ops/pair_edge_mlp.py::_relu_pair_*_jnp),
// in f32 from stream-dtype (f32 or bf16) tables, into zero-initialised f32
// outputs, each sum term in the twins' order, z = A[src] + B[tgt]:
//
//   relu_pair_fwd   <- tf2_gnn_tpu/ops/pair_edge_mlp.py:84
//                      (_relu_pair_fwd_device, pallas_call :171), forward
//                      plan: R[tgt] += max(z, 0) * s. The eval forward.
//   relu_pair_fwd_m <- pair_edge_mlp.py:188 (_relu_pair_fwd_m_device,
//                      pallas_call :289), forward plan: R as above and
//                      M[tgt] += (z > 0 ? s : 0) in the same sweep. The
//                      training forward (the backward's dB is M * g). Its
//                      own kernel, relu_pair_rows_kernel (below).
//   relu_pair_da    <- pair_edge_mlp.py:420 (_relu_pair_da_device,
//                      pallas_call :523), BACKWARD plan, whose "source" is
//                      the original target t (rows of B and of the f32
//                      cotangent g) and whose output rows are A's rows u:
//                      dA[u] += (A[u] + B[t] > 0 ? g[t] : 0) * s.
//   relu_pair_db    <- pair_edge_mlp.py:308 (_relu_pair_db_device,
//                      pallas_call :402), forward plan:
//                      dB[tgt] += g[tgt] * sum of (z > 0 ? s : 0); g is
//                      constant per output row, so each block multiplies its
//                      accumulated rows by g before the global add. No call
//                      path runs it, in the JAX package either.
//
// Unlike the TPU kernels, which round the cotangent g to the stream dtype
// (pair_edge_mlp.py:416, 537), g stays f32 here, as in the jnp twins.
//
// Design of B5-B7. The TPU kernels build one-hot factors and run three or
// four MXU matmuls per chunk, because Mosaic cannot gather rows: the source
// half stays resident in VMEM and the target half streams through the
// output block index. Hopper gathers rows natively, so each slot is a row
// gather, an add, a compare and an add into shared memory. One thread
// block per (plan group, 64-column feature tile): a group's chunks share
// one 128-row output block, so the block first stages that block's rows of
// the table indexed by the output (B for the forward plan, A for the
// backward plan) as a [128, 64] slab in shared memory, the counterpart of
// the TPU's "slab through the output block index". Each warp then loads 32
// slots' plan entries with coalesced loads and walks its valid slots four
// at a time: the 32 lanes gather a row segment of the other table
// (neighbouring lanes on neighbouring columns), add the staged row, and add
// the slot's term into an f32 [128, 64] shared tile with shared-memory
// atomics. The touched rows are then added into the output with one global
// atomicAdd per element: groups of one output block run concurrently, so
// f32 sums land in a run-dependent order. relu and the mask are per
// element, so the column tiling is exact. Shared memory: the tile, the slab
// and the touched-row flags, 48.5 KB to 64.5 KB, so the launch raises the
// dynamic shared-memory limit with cudaFuncSetAttribute. H needs no
// padding: columns >= H are masked.
//
// Design of B4, the row owner. The forward plan's output row t is also B's
// row t, so one warp owns an output row: it reads the row's entries from
// the plan's compact form (ops/pair_spmm.py::slot_rows, the valid slots as
// a CSR by output row, each with its clipped source row and its plan slot,
// built once per batch and kept on the plan as MergedPlan.fwd_rows), holds
// B[clip(t)] in registers, gathers 2 rows of A per lane before their
// adds, and keeps R and M as f32 register sums in the row's slot
// order, each element stored once: no padded slot is walked, nothing is
// staged in shared memory, there are no atomics and two launches give the
// same bits. A lane unit is 8 bytes (4 bf16 or 2 f32 columns; bf16 H = 320
// is 80 units, 3 a lane) where the row and its tables' alignment allow
// them, else one element (10 a lane at H = 320); wider rows take more
// column tiles (gridDim.y), each walking the row's entries again.
//
// Bound. Memory: each input read once (the distinct gathered rows, the
// staged table's rows, for dA and dB the f32 cotangent rows), the plan and
// the f32 outputs written once; B4 reads its compact form (8 B an entry and
// 4 B an output row) in place of the plan. The arithmetic (3 to 6 f32
// operations a valid slot and column) is far below the card's f32 rate.
// B5-B7 sit well above that bound (PERF.md): a warp's gathers are dependent
// rounds of short row segments, flushed through shared and global atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "lane_units.cuh"

namespace {

constexpr int BLK = 128;     // rows per node block
constexpr int E_C = 128;     // slots per chunk
constexpr int HT = 64;       // feature columns per thread block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS_PER_LANE = HT / 32;
constexpr int UNROLL = 4;    // valid slots gathered before their adds

enum Mode : int { kFwd = 0, kDa = 1, kDb = 2 };

__device__ __forceinline__ void set_zero(float& x) { x = 0.0f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& x) {
  x = __float2bfloat16(0.0f);
}

// Dynamic shared memory: the f32 accumulator tile, the staged slab and the
// touched-row flags.
template <typename T>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(BLK) * HT * sizeof(float)
         + static_cast<size_t>(BLK) * HT * sizeof(T) + BLK * sizeof(int);
}

struct Args {
  const void* gathered;   // [gathered_rows, h]: A (fwd plan) or B (bwd plan)
  int64_t gathered_rows;
  const void* staged;     // [staged_rows, h]: B (fwd plan) or A (bwd plan)
  int64_t staged_rows;
  const float* g;         // f32 cotangent: [gathered_rows, h] for dA,
                          // [out_rows, h] for dB, unused otherwise
  int h;
  const float* scale;
  const int32_t* rel_src;
  const int32_t* rel_tgt;
  const int32_t* src_blk;
  const int32_t* grp_tgt;
  int group;
  float* out;             // R, dA or dB
  int64_t out_rows;
};

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS) relu_pair_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);                  // [BLK, HT]
  T* slab = reinterpret_cast<T*>(acc + BLK * HT);               // [BLK, HT]
  int* touched = reinterpret_cast<int*>(slab + BLK * HT);       // [BLK]

  const T* __restrict__ gathered = static_cast<const T*>(a.gathered);
  const T* __restrict__ staged = static_cast<const T*>(a.staged);
  const int g = blockIdx.x;
  const int col0 = blockIdx.y * HT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t out_base = static_cast<int64_t>(a.grp_tgt[g]) * BLK;

  for (int i = threadIdx.x; i < BLK * HT; i += THREADS) acc[i] = 0.0f;
  for (int i = threadIdx.x; i < BLK; i += THREADS) touched[i] = 0;
  // The output block's rows of the staged table, this block's columns.
  for (int i = threadIdx.x; i < BLK * HT; i += THREADS) {
    const int col = col0 + i % HT;
    const int64_t row = clip(out_base + i / HT, a.staged_rows);
    if (col < a.h) {
      slab[i] = staged[row * a.h + col];
    } else {
      set_zero(slab[i]);
    }
  }
  __syncthreads();

  const int64_t slot0 = static_cast<int64_t>(g) * a.group * E_C;
  const int num_slots = a.group * E_C;
  for (int base = warp * 32; base < num_slots; base += WARPS * 32) {
    const int64_t s = slot0 + base + lane;
    const int rs = a.rel_src[s];
    const int rt = a.rel_tgt[s];
    const float sc = a.scale[s];
    const bool valid = rs >= 0 && rs < BLK && rt >= 0 && rt < BLK;
    const int64_t row = clip(
        static_cast<int64_t>(a.src_blk[s / E_C]) * BLK + (valid ? rs : 0),
        a.gathered_rows);
    if (valid) touched[rt] = 1;
    unsigned mask = __ballot_sync(FULL, valid);
    while (mask) {
      int64_t r[UNROLL];
      int t[UNROLL];
      float c[UNROLL];
      bool ok[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        ok[u] = mask != 0;
        const int j = ok[u] ? __ffs(mask) - 1 : 0;
        if (ok[u]) mask &= mask - 1;
        r[u] = __shfl_sync(FULL, row, j);
        t[u] = __shfl_sync(FULL, rt, j);
        c[u] = __shfl_sync(FULL, sc, j);
      }
      float x[UNROLL][COLS_PER_LANE];
      float gv[UNROLL][COLS_PER_LANE];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int k = 0; k < COLS_PER_LANE; ++k) {
          const int col = col0 + lane + 32 * k;
          const bool in = ok[u] && col < a.h;
          x[u][k] = in ? to_f32(gathered[r[u] * a.h + col]) : 0.0f;
          gv[u][k] = (MODE == kDa && in) ? a.g[r[u] * a.h + col] : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!ok[u]) continue;
#pragma unroll
        for (int k = 0; k < COLS_PER_LANE; ++k) {
          const int col = lane + 32 * k;
          if (col0 + col >= a.h) continue;
          const int i = t[u] * HT + col;
          const float y = to_f32(slab[i]);
          // The twins add the source half first: z = A[src] + B[tgt].
          const float z = MODE == kDa ? y + x[u][k] : x[u][k] + y;
          if (MODE == kFwd) atomicAdd(&acc[i], fmaxf(z, 0.0f) * c[u]);
          if (MODE == kDb) atomicAdd(&acc[i], z > 0.0f ? c[u] : 0.0f);
          if (MODE == kDa) {
            atomicAdd(&acc[i], (z > 0.0f ? gv[u][k] : 0.0f) * c[u]);
          }
        }
      }
    }
  }
  __syncthreads();

  // Segment-sum semantics: rows outside the output are dropped.
  for (int i = threadIdx.x; i < BLK * HT; i += THREADS) {
    const int rr = i / HT;
    const int col = col0 + i % HT;
    const int64_t orow = out_base + rr;
    if (!touched[rr] || col >= a.h || orow < 0 || orow >= a.out_rows) {
      continue;
    }
    const int64_t o = orow * a.h + col;
    atomicAdd(&a.out[o], MODE == kDb ? acc[i] * a.g[o] : acc[i]);
  }
}

template <typename T, int MODE>
int launch(const Args& a, int num_groups, cudaStream_t s) {
  const size_t smem = smem_bytes<T>();
  // Above 48 KB a block's shared memory must be raised explicitly.
  cudaError_t err = cudaFuncSetAttribute(
      relu_pair_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(num_groups),
                  static_cast<unsigned>((a.h + HT - 1) / HT));
  relu_pair_kernel<T, MODE><<<grid, THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dtype codes shared with the Python wrapper.
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

template <int MODE>
int dispatch(int device, int dtype, const void* a_tab, int64_t a_rows,
             const void* b_tab, int64_t b_rows, const float* g, int h,
             const float* scale, const int32_t* rel_src,
             const int32_t* rel_tgt, const int32_t* src_blk,
             const int32_t* grp_tgt, int num_groups, int group, float* out,
             int64_t out_rows, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_groups <= 0 || group <= 0 || h <= 0 || a_rows <= 0 || b_rows <= 0
      || out_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The forward plan gathers A and stages B; the backward plan (dA) the
  // other way round.
  const bool bwd = MODE == kDa;
  const Args a{bwd ? b_tab : a_tab, bwd ? b_rows : a_rows,
               bwd ? a_tab : b_tab, bwd ? a_rows : b_rows,
               g, h, scale, rel_src, rel_tgt, src_blk, grp_tgt, group,
               out, out_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return launch<float, MODE>(a, num_groups, s);
  if (dtype == DTYPE_BF16) {
    return launch<__nv_bfloat16, MODE>(a, num_groups, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// B4: the row owner over the forward plan's compact form.

struct RowsArgs {
  const void* a;            // [a_rows, h], rows contiguous
  const void* b;            // [b_rows, h]
  int64_t b_rows;
  int h;
  const float* scale;       // [slots]
  const int32_t* row_ptr;   // [out_rows + 1]
  const int32_t* src_row;   // [n] rows of A, clipped
  const int32_t* slot;      // [n] plan slots (the scale's index)
  int64_t out_rows;
  float* r;                 // [out_rows, h]
  float* m;                 // [out_rows, h]
};

// One warp owns output row t; W units of UB bytes a lane in this column
// tile (blockIdx.y). IN_FLIGHT = 2 rows of A are gathered before their
// adds: the kernel waits on L2 latency, and on an H100 more resident warps
// (64 registers at H = 320, 4 blocks an SM) hid it better than deeper
// unrolling did, whose registers cost resident warps.
template <typename T, int UB, int W>
__global__ void __launch_bounds__(ROW_THREADS)
    relu_pair_rows_kernel(RowsArgs a) {
  using U = Unit<T, UB>;
  constexpr int E = U::kElems;
  constexpr int IN_FLIGHT = 2;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * ROW_WARPS + (threadIdx.x >> 5);
  if (row >= a.out_rows) return;  // warp-uniform
  const int units = a.h / E;      // per table row
  const int unit0 = blockIdx.y * 32 * W + lane;
  const int64_t b_row = row < a.b_rows ? row : a.b_rows - 1;

  float bv[W][E], r[W][E], m[W][E];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int unit = unit0 + 32 * k;
    U::unpack(unit < units ? U::load(a.b, b_row * units + unit) : U::zero(),
              bv[k]);
#pragma unroll
    for (int e = 0; e < E; ++e) r[k][e] = m[k][e] = 0.0f;
  }

  const int begin = __ldg(a.row_ptr + row);
  const int end = __ldg(a.row_ptr + row + 1);
  for (int base = begin; base < end; base += 32) {
    const int count = min(32, end - base);  // warp-uniform
    // Entry j of the round sits in lane j.
    int src = 0;
    float sc = 0.0f;
    if (lane < count) {
      src = __ldg(a.src_row + base + lane);
      sc = __ldg(a.scale + __ldg(a.slot + base + lane));
    }
    for (int j0 = 0; j0 < count; j0 += IN_FLIGHT) {
      typename U::Raw val[IN_FLIGHT][W];
      float c[IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int j = (j0 + u) & 31;
        const int64_t s = __shfl_sync(FULL, src, j);
        c[u] = __shfl_sync(FULL, sc, j);
        const bool ok = j0 + u < count;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int unit = unit0 + 32 * k;
          val[u][k] = (ok && unit < units) ? U::load(a.a, s * units + unit)
                                           : U::zero();
        }
      }
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        if (j0 + u >= count) break;  // warp-uniform
#pragma unroll
        for (int k = 0; k < W; ++k) {
          float x[E];
          U::unpack(val[u][k], x);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            // The twins add the source half first: z = A[src] + B[tgt].
            const float z = x[e] + bv[k][e];
            r[k][e] += fmaxf(z, 0.0f) * c[u];
            m[k][e] += z > 0.0f ? c[u] : 0.0f;
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int unit = unit0 + 32 * k;
    if (unit >= units) continue;
    const int64_t o = row * a.h + static_cast<int64_t>(unit) * E;
    store_f32<E>(a.r + o, r[k]);
    store_f32<E>(a.m + o, m[k]);
  }
}

template <typename T, int UB, int W>
void launch_rows_w(dim3 grid, cudaStream_t s, const RowsArgs& a) {
  relu_pair_rows_kernel<T, UB, W><<<grid, ROW_THREADS, 0, s>>>(a);
}

// Units a lane, instantiated: 8-byte units 1, 3 or 5 (bf16 H up to 128,
// 384, 640 in one tile; f32 half that), element units 1, 2, 4 or 10 (H up
// to 32, 64, 128, 320); the smallest that holds the row, else the largest
// and more column tiles.
int rows_w(bool eight, int units) {
  const int need = (units + 31) / 32;
  if (eight) return need <= 1 ? 1 : (need <= 3 ? 3 : 5);
  return need <= 1 ? 1 : (need <= 2 ? 2 : (need <= 4 ? 4 : 10));
}

template <typename T, int UB>
void launch_rows(dim3 grid, int w, cudaStream_t s, const RowsArgs& a) {
  if constexpr (UB == 8) {
    if (w == 1) launch_rows_w<T, UB, 1>(grid, s, a);
    else if (w == 3) launch_rows_w<T, UB, 3>(grid, s, a);
    else launch_rows_w<T, UB, 5>(grid, s, a);
  } else {
    if (w == 1) launch_rows_w<T, UB, 1>(grid, s, a);
    else if (w == 2) launch_rows_w<T, UB, 2>(grid, s, a);
    else if (w == 4) launch_rows_w<T, UB, 4>(grid, s, a);
    else launch_rows_w<T, UB, 10>(grid, s, a);
  }
}

template <typename T>
int launch_rows_by_unit(const RowsArgs& a, cudaStream_t s) {
  constexpr int kItem = static_cast<int>(sizeof(T));
  // 8-byte units where the row, both tables and both outputs allow them
  // (on an H100 2.5 times faster at bf16 H = 320 than one element a lane,
  // PERF.md); else one element a lane.
  const bool eight = static_cast<int64_t>(a.h) * kItem % 8 == 0
                     && aligned(a.a, 8) && aligned(a.b, 8)
                     && aligned(a.r, 16) && aligned(a.m, 16);
  const int units = eight ? a.h * kItem / 8 : a.h;
  const int w = rows_w(eight, units);
  const dim3 grid(
      static_cast<unsigned>((a.out_rows + ROW_WARPS - 1) / ROW_WARPS),
      static_cast<unsigned>((units + 32 * w - 1) / (32 * w)));
  if (eight) {
    launch_rows<T, 8>(grid, w, s, a);
  } else {
    launch_rows<T, kItem>(grid, w, s, a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One C entry point per kernel. B5-B7 share one signature (g is null where
// a kernel reads none); B4 reads the compact form. Each returns the
// cudaError_t of its launch (cudaGetLastError right after it); 0 is
// success.

#define DEFINE_LAUNCH(NAME, MODE)                                             \
  extern "C" int NAME(int device, int dtype, const void* a_tab,              \
                      int64_t a_rows, const void* b_tab, int64_t b_rows,      \
                      const float* g, int h, const float* scale,              \
                      const int32_t* rel_src, const int32_t* rel_tgt,         \
                      const int32_t* src_blk, const int32_t* grp_tgt,         \
                      int num_groups, int group, float* out,                  \
                      int64_t out_rows, void* stream) {                       \
    return dispatch<MODE>(device, dtype, a_tab, a_rows, b_tab, b_rows, g, h,  \
                          scale, rel_src, rel_tgt, src_blk, grp_tgt,          \
                          num_groups, group, out, out_rows, stream);          \
  }

DEFINE_LAUNCH(relu_pair_fwd_launch, kFwd)
DEFINE_LAUNCH(relu_pair_da_launch, kDa)
DEFINE_LAUNCH(relu_pair_db_launch, kDb)

// B4: R and M, f32 [out_rows, h], every element stored once.
extern "C" int relu_pair_fwd_m_launch(
    int device, int dtype, const void* a_tab, const void* b_tab,
    int64_t b_rows, int h, const float* scale, const int32_t* row_ptr,
    const int32_t* src_row, const int32_t* slot, int64_t out_rows, float* r,
    float* m, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h <= 0 || b_rows <= 0 || out_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RowsArgs a{a_tab, b_tab, b_rows, h, scale, row_ptr, src_row, slot,
                   out_rows, r, m};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return launch_rows_by_unit<float>(a, s);
  if (dtype == DTYPE_BF16) return launch_rows_by_unit<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* relu_pair_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
