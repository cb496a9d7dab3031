// The scaled sorted-segment sum of the scatter-plan route (B13), for Hopper
// (sm_90a), bound through a plain C interface (ctypes) by
// tf2_gnn_tpu_torch/ops/sorted_spmm.py. It reads one plan layout
// (ops/sorted_spmm.py::build_merged_plans): a chunk-ordered stream of
// CHUNK = 512 slots a chunk, every chunk inside one block of R = 128
// output rows,
//
//   out[block_ids[slot / CHUNK] * R + rel[slot]]  <-  stream row `slot`,
//
// where rel outside [0, R) marks a sentinel slot, which is skipped. It
// computes the semantics of its TPU kernel in f32 into an f32 output that
// the wrapper zero-fills. The rest of this family are row owners over the
// plan's compact form in csrc/pair_stream.cu: the plain sum (B12,
// spmm_pallas.py:442) and the max (B15, spmm_pallas.py:705) on its
// row_owner_kernel and max_rows_kernel, the attention sums (B14,
// spmm_pallas.py:835) on head_rows_kernel.
//
//   sorted_segment_sum_scaled <- spmm_pallas.py:457 (sorted_segment_sum_
//                                scaled, pallas_call :494): out[row] +=
//                                msgs[slot] * scale[slot], in that order.
//                                f32 or bf16 stream, f32 scale; with a bf16
//                                stream the wrapper has rounded the scale
//                                to bf16 first, as the TPU kernel rounds
//                                onehot * scale to the stream dtype.
//
// Design. The TPU kernel runs a sequential (feature tile, chunk) grid that
// builds a [128, 512] one-hot per chunk and accumulates each output block on
// its first visit, because Mosaic cannot scatter rows. GPU blocks run in no
// order, so here every output row is owned by no one: each flush is an
// atomic add into the zero-filled output. One thread block per (chunk,
// column tile). Its 128 threads are split into segments of LPR lanes: for
// wide rows (H > 32) a segment is a warp over a 64-column tile, two columns
// a lane; for H <= 32 a segment covers all of H (LPR = 32, or 4 for H <= 4),
// so one block per chunk. Each segment walks its share of the chunk's slots
// in order (128 slots for a warp, 16 for a 4-lane segment), keeping a
// register sum per column while rel stays the same and flushing it with one
// atomic per column when rel changes. The forward plans are target-sorted
// inside a chunk, so runs are long (about 26 slots on the PPI batch) and
// atomics are few. Loads are issued UNROLL slots at a time (rel first, then
// the rows), so each thread keeps several row loads in flight;
// neighbouring lanes read neighbouring columns. The sums land in an order
// that changes run to run.
//
// Bound. Memory: the stream read once (slots x H at its dtype, or the valid
// slots' rows only where sentinels dominate), the plan (4 B a slot and 4 B a
// chunk), the f32 scale (4 B a slot), and the f32 output written once. Two
// f32 operations a slot and column are far below the card's f32 rate, so
// the kernel is bound by bytes; the design reads each stream byte once, in
// slot order, with coalesced row segments. At the PPI batch of the
// scatter-plan route (211,200 valid slots; chip_smoke.py computes these
// from its plan, at 3.35 TB/s): 0.084 ms forward ([245760, 320] f32 into
// 8064 rows) and 0.091 ms backward ([311296, 320] into 24192 rows).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CHUNK = 512;   // slots per chunk
constexpr int THREADS = 128;
constexpr int UNROLL = 8;    // slots loaded before they are combined

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Args {
  const void* msgs;           // [slots, h] rows, row stride ld (elements)
  int64_t ld;
  int h;
  const float* scale;         // [slots]
  const int32_t* rel;         // [slots]
  const int32_t* block_ids;   // [chunks]
  int block_rows;             // R
  float* out;                 // [num_nodes, h], zero-filled
  int64_t num_nodes;
};

// LPR lanes a segment, CPL columns a lane: a column tile of LPR * CPL.
template <typename T, int LPR, int CPL>
__global__ void __launch_bounds__(THREADS) sorted_scatter_kernel(Args a) {
  constexpr int SEGS = THREADS / LPR;
  constexpr int SEG_LEN = CHUNK / SEGS;
  constexpr int TILE = LPR * CPL;
  static_assert(SEG_LEN % UNROLL == 0, "a segment is whole unrolled steps");
  const T* __restrict__ msgs = static_cast<const T*>(a.msgs);
  const float* __restrict__ scale = a.scale;
  const int chunk = blockIdx.x;
  const int seg = threadIdx.x / LPR;
  const int col0 = blockIdx.y * TILE + threadIdx.x % LPR;
  const int64_t s0 = static_cast<int64_t>(chunk) * CHUNK + seg * SEG_LEN;
  const int64_t row0 = static_cast<int64_t>(a.block_ids[chunk]) * a.block_rows;

  float acc[CPL];
  int cur = -1;
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.0f;

  auto flush = [&]() {
    const int64_t row = row0 + cur;
    if (cur < 0 || row >= a.num_nodes) return;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = col0 + c * LPR;
      if (col >= a.h) continue;
      atomicAdd(a.out + row * a.h + col, acc[c]);
    }
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
        e[u][c] = ok ? scale[s] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r[u] < 0 || r[u] >= a.block_rows) continue;  // sentinel slot
      if (r[u] != cur) {
        flush();
        cur = r[u];
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[c] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[c] += x[u][c] * e[u][c];
    }
  }
  flush();
}

template <typename T, int LPR, int CPL>
int launch(const Args& a, int num_chunks, cudaStream_t s) {
  constexpr int TILE = LPR * CPL;
  const dim3 grid(static_cast<unsigned>(num_chunks),
                  static_cast<unsigned>((a.h + TILE - 1) / TILE));
  sorted_scatter_kernel<T, LPR, CPL><<<grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_width(const Args& a, int num_chunks, cudaStream_t s) {
  if (a.h <= 4) return launch<T, 4, 1>(a, num_chunks, s);
  if (a.h <= 32) return launch<T, 32, 1>(a, num_chunks, s);
  return launch<T, 32, 2>(a, num_chunks, s);
}

// dtype codes shared with the Python wrapper.
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

}  // namespace

// The C entry point. Returns the cudaError_t of its launch
// (cudaGetLastError right after it); 0 is success.
extern "C" int sorted_segment_sum_scaled_launch(
    int device, int dtype, const void* msgs, int64_t ld, int h,
    const float* scale, const int32_t* rel, const int32_t* block_ids,
    int num_chunks, int block_rows, float* out, int64_t num_nodes,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_chunks <= 0 || h <= 0 || ld < h || block_rows <= 0
      || num_nodes <= 0 || scale == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{msgs, ld, h, scale, rel, block_ids, block_rows, out,
               num_nodes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return by_width<float>(a, num_chunks, s);
  if (dtype == DTYPE_BF16) return by_width<__nv_bfloat16>(a, num_chunks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* sorted_scatter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
