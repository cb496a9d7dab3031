// Sorted-segment scatter kernels of the scatter-plan route, for Hopper
// (sm_90a), bound through a plain C interface (ctypes) by
// tf2_gnn_tpu_torch/ops/sorted_spmm.py. All three read one plan layout
// (ops/sorted_spmm.py::build_merged_plans): a chunk-ordered stream of
// CHUNK = 512 slots a chunk, every chunk inside one block of R = 128
// output rows,
//
//   out[block_ids[slot / CHUNK] * R + rel[slot]]  <-  stream row `slot`,
//
// where rel outside [0, R) marks a sentinel slot, which is skipped. Each
// computes the semantics of its TPU kernel in f32 into an f32 output that
// the wrapper allocates and fills (0, or -inf for the max). The plain sum
// of this family (B12, spmm_pallas.py:442) is pair_stream.cu's row-owner
// kernel over the plan's compact form:
//
//   sorted_segment_sum_scaled <- spmm_pallas.py:457 (sorted_segment_sum_
//                                scaled, pallas_call :494): out[row] +=
//                                msgs[slot] * scale[slot], in that order.
//                                f32 or bf16 stream, f32 scale; with a bf16
//                                stream the wrapper has rounded the scale
//                                to bf16 first, as the TPU kernel rounds
//                                onehot * scale to the stream dtype.
//   sorted_segment_max        <- spmm_pallas.py:671 (sorted_segment_max,
//                                pallas_call :705): out[row] =
//                                max(out[row], vals[slot]) from a -inf fill;
//                                the wrapper maps non-finite rows to 0. f32.
//   attention_scatter         <- spmm_pallas.py:755 (attention_scatter,
//                                pallas_call :835): weighted[row, c] +=
//                                msgs[slot, c] * expd[slot, c % K] (hk-major
//                                columns) and denom[row, k] += expd[slot, k],
//                                in one pass. f32.
//
// Design. The TPU kernels run a sequential (feature tile, chunk) grid that
// builds a [128, 512] one-hot per chunk and accumulates each output block on
// its first visit, because Mosaic cannot scatter rows. GPU blocks run in no
// order, so here every output row is owned by no one: each flush is an
// atomic into the pre-filled output. One thread block per (chunk, column
// tile). Its 128 threads are split into segments of LPR lanes: for wide
// rows (H > 32) a segment is a warp over a 64-column tile, two columns a
// lane; for H <= 32 a segment covers all of H (LPR = 32, or 4 for H <= 4,
// as the [., 4] logits and scores are), so one block per chunk. Each
// segment walks its share of the chunk's slots in order (128 slots for a
// warp, 16 for a 4-lane segment), keeping a register sum (or max) per
// column while rel stays the same and flushing it with one atomic per
// column when rel changes. The forward plans are target-sorted inside a
// chunk, so runs are long (about 26 slots on the PPI batch) and atomics are
// few. Loads are
// issued UNROLL slots at a time (rel first, then the rows), so each thread
// keeps several row loads in flight; neighbouring lanes read neighbouring
// columns. The float max flushes with the integer trick (atomicMax on the
// bits of a value with the sign bit clear, atomicMin on the unsigned bits of
// one with it set), which is exact: B15 matches its plain version bit for
// bit. B14's denominators are flushed by the lanes of column tile 0 whose
// column is a head (K <= 32), from the same expd loads as their weights.
// Sums land in an order that changes run to run.
//
// Bound. Memory: the stream read once (slots x H at its dtype, or the valid
// slots' rows only where sentinels dominate), the plan (4 B a slot and 4 B a
// chunk), B13's f32 scale and B14's f32 expd (4 B a slot and head), and the
// f32 outputs written once. One or two f32 operations a slot and column are
// far below the card's f32 rate, so every kernel here is bound by bytes;
// the design reads each stream byte once, in slot order, with coalesced
// row segments. At the PPI batch of the scatter-plan route (211,200 valid
// slots; chip_smoke.py computes these from its plan, at 3.35 TB/s): B13
// 0.084 ms forward ([245760, 320] f32 into 8064 rows) and 0.091 ms backward
// ([311296, 320] into 24192 rows), B14 0.085 ms, B15 about 0.0013 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "float_atomics.cuh"

namespace {

constexpr int CHUNK = 512;   // slots per chunk
constexpr int THREADS = 128;
constexpr int UNROLL = 8;    // slots loaded before they are combined

enum Mode : int { kScaled = 1, kMax = 2, kAttention = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Args {
  const void* msgs;           // [slots, h] rows, row stride ld (elements)
  int64_t ld;
  int h;
  const float* aux;           // B13: scale [slots]; B14: expd [slots, k]
  int k;                      // B14 heads
  const int32_t* rel;         // [slots]
  const int32_t* block_ids;   // [chunks]
  int block_rows;             // R
  float* out;                 // [num_nodes, h], pre-filled
  float* denom;               // B14: [num_nodes, k], zeroed
  int64_t num_nodes;
};

// LPR lanes a segment, CPL columns a lane: a column tile of LPR * CPL.
template <typename T, int MODE, int LPR, int CPL>
__global__ void __launch_bounds__(THREADS) sorted_scatter_kernel(Args a) {
  constexpr int SEGS = THREADS / LPR;
  constexpr int SEG_LEN = CHUNK / SEGS;
  constexpr int TILE = LPR * CPL;
  static_assert(SEG_LEN % UNROLL == 0, "a segment is whole unrolled steps");
  const float init = MODE == kMax ? -CUDART_INF_F : 0.0f;

  const T* __restrict__ msgs = static_cast<const T*>(a.msgs);
  const float* __restrict__ aux = a.aux;
  const int chunk = blockIdx.x;
  const int seg = threadIdx.x / LPR;
  const int col0 = blockIdx.y * TILE + threadIdx.x % LPR;
  const int64_t s0 = static_cast<int64_t>(chunk) * CHUNK + seg * SEG_LEN;
  const int64_t row0 = static_cast<int64_t>(a.block_ids[chunk]) * a.block_rows;
  // B14: the lanes of tile 0 whose (first) column is a head also sum the
  // denominators; col0 % k == col0 there, so their expd is the head's.
  const bool denom_lane = MODE == kAttention && blockIdx.y == 0 && col0 < a.k;

  float acc[CPL];
  float dacc = 0.0f;
  int cur = -1;
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = init;

  auto flush = [&]() {
    const int64_t row = row0 + cur;
    if (cur < 0 || row >= a.num_nodes) return;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = col0 + c * LPR;
      if (col >= a.h) continue;
      float* p = a.out + row * a.h + col;
      if (MODE == kMax) {
        atomic_max_f32(p, acc[c]);
      } else {
        atomicAdd(p, acc[c]);
      }
    }
    if (denom_lane) atomicAdd(a.denom + row * a.k + col0, dacc);
  };

  for (int i = 0; i < SEG_LEN; i += UNROLL) {
    int r[UNROLL];
    float x[UNROLL][CPL];
    float e[UNROLL][CPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) r[u] = a.rel[s0 + i + u];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t s = s0 + i + u;
      const bool ok = r[u] >= 0 && r[u] < a.block_rows;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int col = col0 + c * LPR;
        const bool in = ok && col < a.h;
        x[u][c] = in ? to_f32(msgs[s * a.ld + col]) : 0.0f;
        if (MODE == kScaled) e[u][c] = ok ? aux[s] : 0.0f;
        if (MODE == kAttention) e[u][c] = in ? aux[s * a.k + col % a.k] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r[u] < 0 || r[u] >= a.block_rows) continue;  // sentinel slot
      if (r[u] != cur) {
        flush();
        cur = r[u];
        dacc = 0.0f;
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[c] = init;
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        if (MODE == kScaled || MODE == kAttention) acc[c] += x[u][c] * e[u][c];
        if (MODE == kMax) acc[c] = fmaxf(acc[c], x[u][c]);
      }
      if (denom_lane) dacc += e[u][0];
    }
  }
  flush();
}

template <typename T, int MODE, int LPR, int CPL>
int launch(const Args& a, int num_chunks, cudaStream_t s) {
  constexpr int TILE = LPR * CPL;
  const dim3 grid(static_cast<unsigned>(num_chunks),
                  static_cast<unsigned>((a.h + TILE - 1) / TILE));
  sorted_scatter_kernel<T, MODE, LPR, CPL><<<grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
int by_width(const Args& a, int num_chunks, cudaStream_t s) {
  if (a.h <= 4) return launch<T, MODE, 4, 1>(a, num_chunks, s);
  if (a.h <= 32) return launch<T, MODE, 32, 1>(a, num_chunks, s);
  return launch<T, MODE, 32, 2>(a, num_chunks, s);
}

// dtype codes shared with the Python wrapper.
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

template <int MODE>
int dispatch(int device, int dtype, const void* msgs, int64_t ld, int h,
             const float* aux, int k, const int32_t* rel,
             const int32_t* block_ids, int num_chunks, int block_rows,
             float* out, float* denom, int64_t num_nodes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool needs_aux = MODE == kScaled || MODE == kAttention;
  if (num_chunks <= 0 || h <= 0 || ld < h || block_rows <= 0
      || num_nodes <= 0 || (needs_aux && aux == nullptr)
      || (MODE == kAttention
          && (k <= 0 || k > 32 || h % k != 0 || denom == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{msgs, ld, h, aux, k, rel, block_ids, block_rows, out, denom,
               num_nodes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return by_width<float, MODE>(a, num_chunks, s);
  if constexpr (MODE == kScaled) {
    if (dtype == DTYPE_BF16) {
      return by_width<__nv_bfloat16, MODE>(a, num_chunks, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// One C entry point per kernel, all with one signature (aux and denom are
// null where a kernel reads or writes none). Each returns the cudaError_t
// of its launch (cudaGetLastError right after it); 0 is success.

#define DEFINE_LAUNCH(NAME, MODE)                                             \
  extern "C" int NAME(int device, int dtype, const void* msgs, int64_t ld,   \
                      int h, const float* aux, int k, const int32_t* rel,     \
                      const int32_t* block_ids, int num_chunks,               \
                      int block_rows, float* out, float* denom,               \
                      int64_t num_nodes, void* stream) {                      \
    return dispatch<MODE>(device, dtype, msgs, ld, h, aux, k, rel, block_ids, \
                          num_chunks, block_rows, out, denom, num_nodes,      \
                          stream);                                            \
  }

DEFINE_LAUNCH(sorted_segment_sum_scaled_launch, kScaled)
DEFINE_LAUNCH(sorted_segment_max_launch, kMax)
DEFINE_LAUNCH(attention_scatter_launch, kAttention)

extern "C" const char* sorted_scatter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
