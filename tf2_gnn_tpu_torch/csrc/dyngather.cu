// Per-lane dynamic row gather summed over shifts, for Hopper (sm_90a),
// bound through a plain C interface (ctypes) by
// tf2_gnn_tpu_torch/ops/probes.py. It computes
//
//   out[r, c] = sum over s < reps of f32(table[(idx[r, c] + s) mod R, c])
//
// for a table [R, C] (f32 or bf16), int32 indices [R, C] and an f32 output
// [R, C] written once (the sum starts from zero). It replaces the Pallas
// TPU kernel of benchmarks/dyngather_probe.py:22-51 (build's kernel,
// pallas_call :37), a probe of Mosaic's per-lane sublane gather
// (jnp.take_along_axis over axis 0 of a VMEM-resident table, one grid step
// a shift, accumulated into the output block).
//
// Design. A GPU gathers per lane natively, so the simple form is the right
// one: one thread per (r, c), neighbouring threads on neighbouring columns,
// which loops over the reps shifts (the TPU's sequential grid axis) with
// the row index wrapped by one compare, adds each gathered value to a
// register in shift order and stores the sum once. The index and the
// output move coalesced; each gather reads one element of a row chosen by
// the data, so neighbouring lanes touch unrelated rows (sector-sized reads
// of 4 or 2 useful bytes) and the table, 4 MiB in f32 at the probe's size,
// is served from L2 after its first touch.
//
// Bound. Memory: the table, the indices and the f32 output once each; the
// reps adds an element are far below the card's f32 rate. At the probe's
// size (R 8192, C 128, 64 shifts) that is 12.6 MB in f32 (10.5 MB in bf16),
// about 0.0038 ms at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dyngather_kernel(const T* __restrict__ table,
                     const int32_t* __restrict__ idx, int64_t rows, int cols,
                     int reps, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= rows * cols) return;
  const int c = static_cast<int>(i % cols);
  // Floor modulo, as the reference's % on int32: negative indices wrap.
  int64_t row = static_cast<int64_t>(idx[i]) % rows;
  if (row < 0) row += rows;
  float acc = 0.0f;
  for (int s = 0; s < reps; ++s) {
    acc += to_f32(table[row * cols + c]);
    if (++row == rows) row = 0;
  }
  out[i] = acc;
}

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

}  // namespace

// Returns the cudaError_t of the launch (cudaGetLastError right after it);
// 0 is success.
extern "C" int dyngather_launch(int device, int dtype, const void* table,
                                int64_t rows, int cols, const int32_t* idx,
                                int reps, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || cols <= 0 || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (rows * cols + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    dyngather_kernel<float><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        static_cast<const float*>(table), idx, rows, cols, reps, out);
  } else if (dtype == DTYPE_BF16) {
    dyngather_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
            static_cast<const __nv_bfloat16*>(table), idx, rows, cols, reps,
            out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dyngather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
