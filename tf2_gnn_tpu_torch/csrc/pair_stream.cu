// Streamed block-pair SpMM kernels for Hopper (sm_90a), bound through a
// plain C interface (ctypes) by tf2_gnn_tpu_torch/ops/pair_spmm.py.
//
// The three entry points compute the plan-slot semantics of the JAX
// package's jnp twins (tf2_gnn_tpu/ops/pair_spmm.py::_pair_spmm_stream_jnp,
// ::_pair_spmm_stream_joint_jnp and ::_pair_spmm_jnp):
//
//   for every slot s of group g (chunk c = s / E_C) with rel_src, rel_tgt < BLK:
//     out[grp_tgt[g] * BLK + rel_tgt[s], :] +=
//         scale[s] * f32(tables[grp_type[g] * v + src_blk[c] * BLK + rel_src[s], :])
//
// into an f32 output, rows outside it dropped. They replace three Pallas
// TPU kernels:
//
//   pair_stream_launch        <- tf2_gnn_tpu/ops/pair_spmm.py:800
//                                (_pair_spmm_stream_device, pallas_call :895).
//                                K1: GLOBAL output blocks (ty * V/BLK +
//                                local), the backward of every layer over the
//                                backward plan with all-zero types. Kernel:
//                                pair_stream_kernel, over the plan arrays.
//   pair_stream_joint_launch  <- tf2_gnn_tpu/ops/pair_spmm.py:973
//                                (_pair_spmm_stream_joint_device, pallas_call
//                                :1057). K2: the joint sum over edge types
//                                into one [Vo, H] output, the forward of
//                                every layer. Kernel: row_owner_kernel.
//   pair_spmm_launch          <- tf2_gnn_tpu/ops/pair_spmm.py:585
//                                (_pair_spmm_device, pallas_call :678; its
//                                jnp twin _pair_spmm_jnp). B3: one direction
//                                of a MERGED plan; RGAT runs it once per head
//                                on a head-major [L*V, head_dim + 1] table
//                                whose last column is ones (the
//                                denominators), with that head's expd row as
//                                the scale; the probes P1/P2 run it on their
//                                plans. Kernel: row_owner_kernel. Unlike the
//                                TPU kernel, which rounds onehot * scale to
//                                the table dtype, the scale stays f32, as in
//                                the jnp twin.
//
// K1's design (pair_stream_kernel). One thread block per (plan group,
// 64-column tile) accumulates into a [128, 64] f32 shared tile with
// shared-memory atomics and adds the touched rows into a zero-initialised
// output with global atomics; it walks every slot of the plan, padded or
// not.
//
// K2 and B3's design (row_owner_kernel). They read the plan's compact form
// (ops/pair_spmm.py::slot_rows), built once per batch: the valid slots whose
// target lies in the output, sorted stably by target row into a CSR
// (row_ptr [out_rows + 1]; per slot its clipped absolute source row and its
// plan slot, whose per-call scale is scale[slot]). One warp owns one output
// row (8 rows a block): it loads up to 32 of the row's (source, slot)
// entries with one coalesced load each, gathers their scales, broadcasts
// them with __shfl_sync, and gathers 8 source rows at a time into registers
// before their FMAs, so 8 independent row loads are in flight per warp
// (register unrolling, not a cp.async ring: each value is used once, so a
// ring would only add a trip through shared memory and its waits; 16 in
// flight doubled the narrow path's registers and slowed it). The sum
// is f32 in registers, in the row's slot order, and each output element is
// stored exactly once (0 for a row without slots): no shared tile, no
// atomics, no zero-fill, and the same sum order on every run. The in-degree
// of a node is even (PPI: mean 29, max 49; QM9: mean 3.2, max 11), so a
// warp a row is balanced.
//
// Loads. Where a row is a whole number of 16-byte vectors (H * itemsize %
// 16 == 0) and the table and output are 16-byte aligned, a lane loads 16 B
// (8 bf16 or 4 f32 columns) per instruction: 512 B per warp instruction
// (K2 at H = 320 and 128 in bf16; at H = 128 half the lanes hold the row's
// 16 vectors, 256 B per instruction). Otherwise (B3's H = 81, rows of 162 B)
// a lane loads one element: 64 B per warp instruction in bf16, 128 B in f32.
// Lanes past H are masked; the table is not padded. A lane holds up to 2
// vectors or 4 columns of a row; wider rows take more column tiles
// (gridDim.y), each walking the row's entries again.
//
// Why not the tensor cores or TMA. There is no dense product: each gathered
// element takes one multiply-add, 2 flops per element, far below the card's
// ridge. Hopper's TMA copies tiles and has no row-gather mode, so the
// gathers are per-lane loads.
//
// Bound. Bytes: the distinct table rows the valid slots read, 8 B per valid
// slot (its source index and its scale), 4 B per output row pointer and the
// f32 output written once; 2 flops per valid slot and column. Bytes bound
// it: the tables fit in the 50 MB L2 (PPI [24192, 320] bf16 15.5 MB, QM9
// [81920, 128] bf16 21 MB), so the gathers wait on L2 latency, and the
// number of gathers in flight per warp sets the time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BLK = 128;     // rows per node block
constexpr int E_C = 128;     // slots per chunk
constexpr int HT = 64;       // feature columns per thread block (K1)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS_PER_LANE = HT / 32;
constexpr int UNROLL = 4;    // valid slots gathered before their adds (K1)
constexpr int ROW_WARPS = 8;                 // output rows per block
constexpr int ROW_THREADS = 32 * ROW_WARPS;
constexpr int IN_FLIGHT = 8;                 // row gathers before their FMAs
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

// ---------------------------------------------------------------------------
// The row-owner kernel of K2 and B3.

struct RowArgs {
  const void* tables;
  int h;
  const float* scale;
  const int32_t* row_ptr;   // [out_rows + 1]
  const int32_t* src_row;   // [n] clipped absolute table rows
  const int32_t* slot;      // [n] plan slots (the scale's index)
  int64_t out_rows;
  float* out;               // [out_rows, h]
};

// A table element's bits as a 32-bit word, and its f32 value.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPerVector = 4;
  __device__ static __forceinline__ uint32_t load(const void* p, int64_t i) {
    return __ldg(static_cast<const unsigned int*>(p) + i);
  }
  __device__ static __forceinline__ float value(uint32_t bits) {
    return __uint_as_float(bits);
  }
  __device__ static __forceinline__ void fma_vector(float* acc, uint4 x,
                                                    float c) {
    acc[0] = fmaf(c, __uint_as_float(x.x), acc[0]);
    acc[1] = fmaf(c, __uint_as_float(x.y), acc[1]);
    acc[2] = fmaf(c, __uint_as_float(x.z), acc[2]);
    acc[3] = fmaf(c, __uint_as_float(x.w), acc[3]);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerVector = 8;
  __device__ static __forceinline__ uint32_t load(const void* p, int64_t i) {
    return __ldg(static_cast<const unsigned short*>(p) + i);
  }
  // bf16 is the upper half of an f32: the conversion is a shift.
  __device__ static __forceinline__ float value(uint32_t bits) {
    return __uint_as_float(bits << 16);
  }
  __device__ static __forceinline__ void fma_vector(float* acc, uint4 x,
                                                    float c) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = fmaf(c, __uint_as_float(w[i] << 16), acc[2 * i]);
      acc[2 * i + 1] = fmaf(c, __uint_as_float(w[i] & 0xffff0000u),
                            acc[2 * i + 1]);
    }
  }
};

// kVector: a lane's unit is a 16-byte vector of the row, else one element;
// W: units per lane in this column tile (blockIdx.y).
template <typename T, bool kVector, int W>
__global__ void __launch_bounds__(ROW_THREADS) row_owner_kernel(RowArgs a) {
  using Unit = std::conditional_t<kVector, uint4, uint32_t>;
  constexpr int kElems = kVector ? Elem<T>::kPerVector : 1;  // per unit
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * ROW_WARPS + (threadIdx.x >> 5);
  if (row >= a.out_rows) return;  // warp-uniform
  const int units = a.h / kElems;  // per table row
  const int unit0 = blockIdx.y * 32 * W + lane;

  float acc[W][kElems];
#pragma unroll
  for (int k = 0; k < W; ++k)
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[k][e] = 0.0f;

  const int begin = __ldg(a.row_ptr + row);
  const int end = __ldg(a.row_ptr + row + 1);
  for (int base = begin; base < end; base += 32) {
    const int count = min(32, end - base);  // warp-uniform
    int src = 0;
    float sc = 0.0f;
    if (lane < count) {
      src = __ldg(a.src_row + base + lane);
      sc = __ldg(a.scale + __ldg(a.slot + base + lane));
    }
    // j0 is a multiple of IN_FLIGHT (which divides 32) below count <= 32,
    // so j0 + u < 32: every shuffle reads a lane of this warp.
    for (int j0 = 0; j0 < count; j0 += IN_FLIGHT) {
      Unit val[IN_FLIGHT][W];
      float c[IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int64_t r = __shfl_sync(FULL, src, j0 + u);
        c[u] = __shfl_sync(FULL, sc, j0 + u);
        const bool ok = j0 + u < count;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int unit = unit0 + 32 * k;
          if constexpr (kVector) {
            val[u][k] = (ok && unit < units)
                            ? __ldg(static_cast<const uint4*>(a.tables)
                                    + r * units + unit)
                            : make_uint4(0u, 0u, 0u, 0u);
          } else {
            val[u][k] = (ok && unit < units)
                            ? Elem<T>::load(a.tables, r * units + unit)
                            : 0u;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        if (j0 + u >= count) break;  // warp-uniform
#pragma unroll
        for (int k = 0; k < W; ++k) {
          if constexpr (kVector) {
            Elem<T>::fma_vector(acc[k], val[u][k], c[u]);
          } else {
            acc[k][0] = fmaf(c[u], Elem<T>::value(val[u][k]), acc[k][0]);
          }
        }
      }
    }
  }

  float* out_row = a.out + row * a.h;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int unit = unit0 + 32 * k;
    if (unit >= units) continue;
    if constexpr (kVector) {
      float4* o = reinterpret_cast<float4*>(out_row + unit * kElems);
#pragma unroll
      for (int e = 0; e < kElems; e += 4) {
        o[e / 4] = make_float4(acc[k][e], acc[k][e + 1], acc[k][e + 2],
                               acc[k][e + 3]);
      }
    } else {
      out_row[unit] = acc[k][0];
    }
  }
}

template <typename T>
void launch_row_owner(bool vector, int w, dim3 grid, cudaStream_t s,
                      const RowArgs& a) {
  if (vector) {
    if (w == 1) {
      row_owner_kernel<T, true, 1><<<grid, ROW_THREADS, 0, s>>>(a);
    } else {
      row_owner_kernel<T, true, 2><<<grid, ROW_THREADS, 0, s>>>(a);
    }
    return;
  }
  switch (w) {
    case 1: row_owner_kernel<T, false, 1><<<grid, ROW_THREADS, 0, s>>>(a); break;
    case 2: row_owner_kernel<T, false, 2><<<grid, ROW_THREADS, 0, s>>>(a); break;
    case 3: row_owner_kernel<T, false, 3><<<grid, ROW_THREADS, 0, s>>>(a); break;
    default: row_owner_kernel<T, false, 4><<<grid, ROW_THREADS, 0, s>>>(a); break;
  }
}

// dtype codes shared with the Python wrapper.
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int row_owner_launch(int device, int dtype, const void* tables, int h,
                     const float* scale, const int32_t* row_ptr,
                     const int32_t* src_row, const int32_t* slot,
                     int64_t out_rows, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h <= 0 || out_rows <= 0 || (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int itemsize = dtype == DTYPE_F32 ? 4 : 2;
  const bool vector = static_cast<int64_t>(h) * itemsize % 16 == 0 &&
                      aligned16(tables) && aligned16(out);
  const int units = vector ? h * itemsize / 16 : h;
  const int max_w = vector ? 2 : 4;
  const int w = min((units + 31) / 32, max_w);
  RowArgs a{tables, h, scale, row_ptr, src_row, slot, out_rows, out};
  dim3 grid(static_cast<unsigned>((out_rows + ROW_WARPS - 1) / ROW_WARPS),
            (units + 32 * w - 1) / (32 * w));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    launch_row_owner<float>(vector, w, grid, s, a);
  } else {
    launch_row_owner<__nv_bfloat16>(vector, w, grid, s, a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points. Each returns the cudaError_t of the launch
// (cudaGetLastError right after it); 0 is success.

extern "C" int pair_stream_launch(int device, int dtype, const void* tables,
                                  int64_t table_rows, int h,
                                  const float* scale, const int32_t* rel_src,
                                  const int32_t* rel_tgt,
                                  const int32_t* src_blk,
                                  const int32_t* grp_tgt,
                                  const int32_t* grp_type, int num_groups,
                                  int group, int v, float* out,
                                  int64_t out_rows, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_groups <= 0 || group <= 0 || h <= 0 || table_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  StreamArgs a{tables, table_rows, h, scale, rel_src, rel_tgt, src_blk,
               grp_tgt, grp_type, group, v, out, out_rows};
  dim3 grid(num_groups, (h + HT - 1) / HT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    pair_stream_kernel<float><<<grid, THREADS, 0, s>>>(a);
  } else if (dtype == DTYPE_BF16) {
    pair_stream_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2 and B3: the same kernel over the compact form of their plans.
extern "C" int pair_stream_joint_launch(int device, int dtype,
                                        const void* tables, int h,
                                        const float* scale,
                                        const int32_t* row_ptr,
                                        const int32_t* src_row,
                                        const int32_t* slot, int64_t out_rows,
                                        float* out, void* stream) {
  return row_owner_launch(device, dtype, tables, h, scale, row_ptr, src_row,
                          slot, out_rows, out, stream);
}

extern "C" int pair_spmm_launch(int device, int dtype, const void* tables,
                                int h, const float* scale,
                                const int32_t* row_ptr,
                                const int32_t* src_row, const int32_t* slot,
                                int64_t out_rows, float* out, void* stream) {
  return row_owner_launch(device, dtype, tables, h, scale, row_ptr, src_row,
                          slot, out_rows, out, stream);
}

extern "C" const char* pair_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
