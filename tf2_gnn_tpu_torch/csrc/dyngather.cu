// Per-lane dynamic row gather summed over shifts, for Hopper (sm_90a),
// bound through a plain C interface (ctypes) by
// tf2_gnn_tpu_torch/ops/probes.py. It computes
//
//   out[r, c] = sum over s < reps of f32(table[(idx[r, c] + s) mod R, c])
//
// for a table [R, C] (f32 or bf16), int32 indices [R, C] and an f32 output
// [R, C] written once (the sum starts from zero and adds in shift order).
// It replaces the Pallas TPU kernel of benchmarks/dyngather_probe.py:22-51
// (build's kernel, pallas_call :37), a probe of Mosaic's per-lane sublane
// gather (jnp.take_along_axis over axis 0 of a table held in VMEM, one
// grid step a shift, accumulated into the output block).
//
// Design. The TPU probe measures gathers from memory on the chip, so this
// kernel gathers from shared memory, Hopper's counterpart of VMEM
// (dyngather_shared_kernel). A block owns a strip of W columns (16 bytes
// of each row at the shipped widths: W = 4 in f32, 8 in bf16) and a range
// of output rows. It copies the strip, table[:, c0:c0+W], into dynamic
// shared memory as [R][W] (cp.async of W elements where the row stride,
// the base and the strip allow, else element by element), then every
// per-lane gather reads shared memory. A warp's lanes lie over 32 / W
// output rows by W columns, so a load's lanes hit bank W * (row mod 32/W)
// + c: only lanes of one column whose gathered rows collide mod 32 / W
// conflict. Each thread walks its row with one compare and wrap; its loads
// do not depend on one another, so several are in flight. The strips'
// row ranges split the grid over the card's SMs; each block restages its
// strip from L2. The launcher takes W from the caller (probes.strip_cols,
// a function of R, C and the dtype): W halves while the strip exceeds the
// shared memory a block may take, and a table whose one-column strip
// still does not fit takes the global form (dyngather_global_kernel), one
// thread an (r, c) gathering from global memory (L2) with the same walk.
//
// Bound. Memory: the table, the indices and the f32 output once each; the
// reps adds an element are far below the card's f32 rate. At the probe's
// size (R 8192, C 128, 64 shifts) that is 12.6 MB in f32 (10.5 MB in bf16),
// about 0.0038 ms at 3.35 TB/s. The shared form is bound instead by its
// R * C * reps shared-memory gathers (bank conflicts between lanes of a
// warp load), the global form by the L2 sectors of its gathers (32 bytes
// for 4 or 2 useful ones).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int GLOBAL_THREADS = 256;
constexpr int SHARED_THREADS = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(GLOBAL_THREADS)
    dyngather_global_kernel(const T* __restrict__ table,
                            const int32_t* __restrict__ idx, int64_t rows,
                            int cols, int reps, float* __restrict__ out) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * GLOBAL_THREADS + threadIdx.x;
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

// One asynchronous copy of BYTES (4, 8 or 16) from global to shared memory.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(gmem), "n"(BYTES));
  }
}

// Grid: strips * splits blocks, block b owning strip b / splits (columns
// [W * strip, W * strip + W), cut at C) and the rows [r0, r1) of range
// b % splits. ``vector``: the strip is whole and every row's W elements
// start on a multiple of W * sizeof(T) bytes (4, 8 or 16), so one cp.async
// moves them.
template <typename T, int W>
__global__ void __launch_bounds__(SHARED_THREADS)
    dyngather_shared_kernel(const T* __restrict__ table,
                            const int32_t* __restrict__ idx, int rows,
                            int cols, int reps, int splits, int split_rows,
                            bool vector, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* strip = reinterpret_cast<T*>(smem_raw);
  const int strip_id = blockIdx.x / splits;
  const int c0 = strip_id * W;
  const int width = min(W, cols - c0);
  const int r0 = (blockIdx.x % splits) * split_rows;
  const int r1 = min(rows, r0 + split_rows);

  constexpr int UNIT = W * static_cast<int>(sizeof(T));
  if constexpr (UNIT == 4 || UNIT == 8 || UNIT == 16) {
    if (vector) {
      for (int r = threadIdx.x; r < rows; r += SHARED_THREADS)
        cp_async<UNIT>(strip + r * W,
                       table + static_cast<int64_t>(r) * cols + c0);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
  }
  if (!vector) {
    for (int i = threadIdx.x; i < rows * W; i += SHARED_THREADS) {
      const int cc = i % W;
      if (cc < width)
        strip[i] = table[static_cast<int64_t>(i / W) * cols + c0 + cc];
    }
  }
  __syncthreads();

  // Lane j of the block: output row r0 + j / W, column c0 + j % W.
  const int n = (r1 - r0) * W;
  for (int j = threadIdx.x; j < n; j += SHARED_THREADS) {
    const int cc = j % W;
    if (cc >= width) continue;
    const int64_t at = static_cast<int64_t>(r0 + j / W) * cols + c0 + cc;
    int row = idx[at] % rows;  // floor modulo, as in the global form
    if (row < 0) row += rows;
    const T* column = strip + cc;
    float acc = 0.0f;
#pragma unroll 8
    for (int s = 0; s < reps; ++s) {
      acc += to_f32(column[row * W]);
      if (++row == rows) row = 0;
    }
    out[at] = acc;
  }
}

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

template <typename T>
int launch_global(const T* table, int64_t rows, int cols, const int32_t* idx,
                  int reps, float* out, cudaStream_t stream) {
  const int64_t blocks = (rows * cols + GLOBAL_THREADS - 1) / GLOBAL_THREADS;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  dyngather_global_kernel<T>
      <<<static_cast<unsigned>(blocks), GLOBAL_THREADS, 0, stream>>>(
          table, idx, rows, cols, reps, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
int launch_shared(int device, const T* table, int64_t rows, int cols,
                  const int32_t* idx, int reps, float* out,
                  cudaStream_t stream) {
  int max_smem = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t smem = rows * W * static_cast<int64_t>(sizeof(T));
  if (smem > max_smem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dyngather_shared_kernel<T, W>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, SHARED_THREADS, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // As many row ranges a strip as keep the grid within one wave of
  // resident blocks, each range with work for at least every thread.
  const int64_t strips = (cols + W - 1) / W;
  int64_t splits = static_cast<int64_t>(sms) * per_sm / strips;
  if (splits > rows * W / SHARED_THREADS) splits = rows * W / SHARED_THREADS;
  if (splits < 1) splits = 1;
  const int64_t split_rows = (rows + splits - 1) / splits;
  splits = (rows + split_rows - 1) / split_rows;
  if (strips * splits > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int UNIT = W * static_cast<int>(sizeof(T));
  const bool vector = (UNIT == 4 || UNIT == 8 || UNIT == 16) &&
                      cols % W == 0 &&
                      reinterpret_cast<uintptr_t>(table) % UNIT == 0;
  kernel<<<static_cast<unsigned>(strips * splits), SHARED_THREADS,
           static_cast<size_t>(smem), stream>>>(
      table, idx, static_cast<int>(rows), cols, reps,
      static_cast<int>(splits), static_cast<int>(split_rows), vector, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int device, const T* table, int64_t rows, int cols,
           const int32_t* idx, int reps, int strip_cols, float* out,
           cudaStream_t stream) {
  switch (strip_cols) {
    case 0:
      return launch_global<T>(table, rows, cols, idx, reps, out, stream);
    case 1:
      return launch_shared<T, 1>(device, table, rows, cols, idx, reps, out,
                                 stream);
    case 2:
      return launch_shared<T, 2>(device, table, rows, cols, idx, reps, out,
                                 stream);
    case 4:
      return launch_shared<T, 4>(device, table, rows, cols, idx, reps, out,
                                 stream);
    case 8:
      return launch_shared<T, 8>(device, table, rows, cols, idx, reps, out,
                                 stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strip_cols: the columns a block stages in shared memory (1, 2, 4 or 8),
// or 0 for the global form. Returns the cudaError_t of the launch
// (cudaGetLastError right after it); 0 is success.
extern "C" int dyngather_launch(int device, int dtype, const void* table,
                                int64_t rows, int cols, const int32_t* idx,
                                int reps, int strip_cols, float* out,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || cols <= 0 || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return launch<float>(device, static_cast<const float*>(table), rows, cols,
                         idx, reps, strip_cols, out, s);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(
        device, static_cast<const __nv_bfloat16*>(table), rows, cols, idx,
        reps, strip_cols, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* dyngather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
