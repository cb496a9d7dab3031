// Streamed block-pair SpMM kernels for Hopper (sm_90a), bound through a
// plain C interface (ctypes) by tf2_gnn_tpu_torch/ops/pair_spmm.py.
//
// The three kernels compute the plan-slot semantics of the JAX package's
// jnp twins (tf2_gnn_tpu/ops/pair_spmm.py::_pair_spmm_stream_jnp,
// ::_pair_spmm_stream_joint_jnp and ::_pair_spmm_jnp):
//
//   for every slot s of group g (chunk c = s / E_C) with rel_src, rel_tgt < BLK:
//     out[grp_tgt[g] * BLK + rel_tgt[s], :] +=
//         scale[s] * f32(tables[grp_type[g] * v + src_blk[c] * BLK + rel_src[s], :])
//
// into a zero-initialised f32 output. They replace three Pallas TPU kernels:
//
//   pair_stream_kernel        <- tf2_gnn_tpu/ops/pair_spmm.py:800
//                                (_pair_spmm_stream_device, pallas_call :895).
//                                GLOBAL output blocks (ty * V/BLK + local).
//                                The model runs it as the backward of every
//                                layer, over the backward plan with all-zero
//                                types (one un-broadcast [Vo, H] cotangent).
//   pair_stream_joint_kernel  <- tf2_gnn_tpu/ops/pair_spmm.py:973
//                                (_pair_spmm_stream_joint_device, pallas_call
//                                :1057). LOCAL output blocks: the joint sum
//                                over edge types into one [Vo, H] output;
//                                types revisit output blocks in any order.
//                                The model runs it as the forward of every
//                                layer.
//   pair_spmm_kernel          <- tf2_gnn_tpu/ops/pair_spmm.py:585
//                                (_pair_spmm_device, pallas_call :678; its
//                                jnp twin _pair_spmm_jnp). One direction of
//                                a MERGED plan: every group of type 0
//                                (grp_type == nullptr) and GLOBAL output
//                                blocks. RGAT runs it once per head on a
//                                head-major [L*V, head_dim + 1] table whose
//                                last column is ones (the denominators),
//                                with that head's expd row as the scale.
//                                Unlike the TPU kernel, which rounds
//                                onehot * scale to the table dtype, the
//                                scale stays f32, as in the jnp twin.
//
// Design. The TPU kernels build one-hot factors and run two MXU matmuls per
// chunk because Mosaic cannot gather rows; Hopper gathers rows natively, so
// each slot here is a row gather, a scale and an add. One thread block per
// (plan group, 64-column feature tile): a group's chunks all share one
// 128-row output block, so the block accumulates into a [128, 64] f32 tile
// in shared memory (shared-memory atomics, no global traffic per slot) and
// adds the touched rows into the output with one global atomicAdd per
// element at the end. Output runs span several groups and the joint form's
// types revisit blocks in any order; blocks run concurrently, so the
// TPU's sequential first-visit logic has no counterpart and the global adds
// are atomic (f32 sums therefore land in a run-dependent order). Each warp
// loads 32 slots' plan entries with coalesced loads and walks its valid
// slots four at a time; the 32 lanes read a row segment with neighbouring
// lanes on neighbouring columns. H needs no padding: columns >= H are
// masked.
//
// Bound. Memory: the distinct table rows the slots read, the plan (12 B a
// slot: rel_src, rel_tgt, scale) and the f32 output written once; the
// arithmetic (2 flops per slot and column) is far below the card's rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLK = 128;     // rows per node block
constexpr int E_C = 128;     // slots per chunk
constexpr int HT = 64;       // feature columns per thread block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS_PER_LANE = HT / 32;
constexpr int UNROLL = 4;    // valid slots gathered before their adds
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct StreamArgs {
  const void* tables;
  int64_t table_rows;
  int h;
  const float* scale;
  const int32_t* rel_src;
  const int32_t* rel_tgt;
  const int32_t* src_blk;
  const int32_t* grp_tgt;
  const int32_t* grp_type;
  int group;
  int v;
  float* out;
  int64_t out_rows;
};

template <typename T>
__device__ __forceinline__ void accumulate_group(const StreamArgs& a) {
  __shared__ float acc[BLK * HT];
  __shared__ int touched[BLK];
  const T* __restrict__ tables = static_cast<const T*>(a.tables);
  const int g = blockIdx.x;
  const int col0 = blockIdx.y * HT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < BLK * HT; i += THREADS) acc[i] = 0.0f;
  for (int i = threadIdx.x; i < BLK; i += THREADS) touched[i] = 0;
  __syncthreads();

  const int64_t type_base =
      a.grp_type ? static_cast<int64_t>(a.grp_type[g]) * a.v : 0;
  const int64_t slot0 = static_cast<int64_t>(g) * a.group * E_C;
  const int num_slots = a.group * E_C;

  for (int base = warp * 32; base < num_slots; base += WARPS * 32) {
    const int64_t s = slot0 + base + lane;
    const int rs = a.rel_src[s];
    const int rt = a.rel_tgt[s];
    const float sc = a.scale[s];
    const bool valid = rs >= 0 && rs < BLK && rt >= 0 && rt < BLK;
    int64_t row = type_base + static_cast<int64_t>(a.src_blk[s / E_C]) * BLK
                  + (valid ? rs : 0);
    // Out-of-range rows clip, as the twins' jnp.take(mode="clip") does.
    row = row < 0 ? 0 : (row >= a.table_rows ? a.table_rows - 1 : row);
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
      float val[UNROLL][COLS_PER_LANE];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int k = 0; k < COLS_PER_LANE; ++k) {
          const int col = col0 + lane + 32 * k;
          val[u][k] = (ok[u] && col < a.h)
                          ? to_f32(tables[r[u] * a.h + col])
                          : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!ok[u]) continue;
#pragma unroll
        for (int k = 0; k < COLS_PER_LANE; ++k) {
          const int col = lane + 32 * k;
          if (col0 + col < a.h) atomicAdd(&acc[t[u] * HT + col], val[u][k] * c[u]);
        }
      }
    }
  }
  __syncthreads();

  // Segment-sum semantics: rows outside the output are dropped.
  const int64_t out_base = static_cast<int64_t>(a.grp_tgt[g]) * BLK;
  for (int i = threadIdx.x; i < BLK * HT; i += THREADS) {
    const int r = i / HT;
    const int col = col0 + i % HT;
    const int64_t orow = out_base + r;
    if (touched[r] && col < a.h && orow >= 0 && orow < a.out_rows) {
      atomicAdd(&a.out[orow * a.h + col], acc[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) pair_stream_kernel(StreamArgs a) {
  accumulate_group<T>(a);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    pair_stream_joint_kernel(StreamArgs a) {
  accumulate_group<T>(a);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) pair_spmm_kernel(StreamArgs a) {
  accumulate_group<T>(a);
}

// dtype codes shared with the Python wrapper.
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

}  // namespace

// One C entry point per kernel. Returns the cudaError_t of the launch
// (cudaGetLastError right after it); 0 is success.

#define DEFINE_LAUNCH(NAME, KERNEL)                                           \
  extern "C" int NAME(int device, int dtype, const void* tables,              \
                      int64_t table_rows, int h, const float* scale,          \
                      const int32_t* rel_src, const int32_t* rel_tgt,         \
                      const int32_t* src_blk, const int32_t* grp_tgt,         \
                      const int32_t* grp_type, int num_groups, int group,     \
                      int v, float* out, int64_t out_rows, void* stream) {    \
    cudaError_t err = cudaSetDevice(device);                                  \
    if (err != cudaSuccess) return static_cast<int>(err);                     \
    if (num_groups <= 0 || group <= 0 || h <= 0 || table_rows <= 0)           \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    StreamArgs a{tables, table_rows, h, scale, rel_src, rel_tgt, src_blk,     \
                 grp_tgt, grp_type, group, v, out, out_rows};                 \
    dim3 grid(num_groups, (h + HT - 1) / HT);                                 \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                       \
    if (dtype == DTYPE_F32) {                                                 \
      KERNEL<float><<<grid, THREADS, 0, s>>>(a);                              \
    } else if (dtype == DTYPE_BF16) {                                         \
      KERNEL<__nv_bfloat16><<<grid, THREADS, 0, s>>>(a);                      \
    } else {                                                                  \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                         \
    return static_cast<int>(cudaGetLastError());                              \
  }

DEFINE_LAUNCH(pair_stream_launch, pair_stream_kernel)
DEFINE_LAUNCH(pair_stream_joint_launch, pair_stream_joint_kernel)
DEFINE_LAUNCH(pair_spmm_launch, pair_spmm_kernel)

extern "C" const char* pair_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
