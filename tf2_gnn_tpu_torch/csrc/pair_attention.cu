// Relational-attention kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes) by tf2_gnn_tpu_torch/ops/pair_attention.py. Both read a
// MERGED pair plan (ops/pair_spmm.py::build_pair_plans): per slot s of
// group g (chunk c = s / E_C), padded where rel >= BLK,
//
//   a = src_blk[c] * BLK + rel_src[s],   b = grp_tgt[g] * BLK + rel_tgt[s].
//
// The packed score table is [rows, 2K] (source halves | target halves, both
// in the stacked l * vs + node row space); m is the f32 [V, K] softmax
// stabiliser, already rounded to the stream dtype by the caller. Products
// and sums run in f32; exp is expf (not __expf), so a kernel agrees with
// its plain version to f32 rounding.
//
// expd_kernel  <- tf2_gnn_tpu/ops/pair_attention.py:304
//                 (_expd_kernel_device, pallas_call :427; jnp twin
//                 _expd_kernel_jnp), forward plan, no slope output. Per slot
//                 (a = source row u, b = target node t):
//                   out[k, s] = exp(leaky(ss[u, k] + ts[(u / vs) * vs + t, k])
//                                   - m[t, k]),  0 on padded slots.
//                 Output [K, slots]: each head's row is the contiguous
//                 per-slot scale of its head-major B3 launch. The TPU kernel
//                 builds one-hot gather matmuls and tiles the K columns to 16
//                 lanes; here one thread takes one slot: gathers, exp, K
//                 coalesced stores. Bound: bytes (the plan's 8 B a slot, the
//                 score and stabiliser rows, 4K B a slot written).
//
// bwd_fused_kernel <- tf2_gnn_tpu/ops/pair_attention.py:661
//                 (_bwd_fused_device, pallas_call :860; jnp twin
//                 _bwd_fused_jnp), backward plan (a = target node t, b =
//                 source row u). Per valid slot, with e = expd recomputed
//                 from the scores and m, slope = p >= 0 ? 1 : 0.2 and
//                   de[k] = sum over hd of table[u, hd*K+k] * dw[t, hd*K+k]
//                           + d_denom[t, k],   d_p = e * slope * de:
//                   d_ss[u] += d_p,   d_ts[(u / vs) * vs + t] += d_p,
//                   d_table[u, hd*K+k] += e[k] * dw[t, hd*K+k].
//                 One thread block per backward group: its chunks share one
//                 128-row source block. Phase 1: one warp per valid slot
//                 reads the two whole rows (the head sum needs all H
//                 columns); lane l sums the columns of head l % K (K divides
//                 32), an xor-shuffle reduce leaves head k's sum in lane k,
//                 which computes e and d_p, keeps e in shared memory, adds
//                 d_p into a shared [128, K] d_ss tile and d_ts with a global
//                 atomicAdd (its rows l * vs + t are scattered). Phase 2
//                 sweeps 64-column tiles as K1 does: each valid slot's dw row
//                 segment times e, summed into a shared [128, 64] f32 tile
//                 with shared atomics, then added into d_table with one
//                 global atomicAdd per touched element. Groups of one source
//                 block run concurrently, so d_ss and d_table take global
//                 atomics too, and f32 sums land in a run-dependent order.
//                 Bound: bytes, the table and cotangent rows read and the
//                 f32 outputs written; the f32 operations (4 a valid slot
//                 and column) take about a quarter of that time on the PPI
//                 shapes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLK = 128;
constexpr int E_C = 128;
constexpr float LEAKY_SLOPE = 0.2f;
constexpr int EXPD_THREADS = 256;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HT = 64;       // d_table feature tile
constexpr int COLS_PER_LANE = HT / 32;
constexpr int UNROLL = 4;    // valid slots gathered before their adds
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Row indices clip into [0, n), as the twins' jnp.take(mode="clip").
__device__ __forceinline__ int64_t clip(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ float leaky(float p) {
  return p >= 0.0f ? p : LEAKY_SLOPE * p;
}

template <typename S>
__global__ void __launch_bounds__(EXPD_THREADS)
    expd_kernel(const S* __restrict__ scores, int64_t rows,
                const float* __restrict__ maxes, int v, int k,
                const int32_t* __restrict__ rel_src,
                const int32_t* __restrict__ rel_tgt,
                const int32_t* __restrict__ src_blk,
                const int32_t* __restrict__ grp_tgt, int group, int64_t slots,
                int vs, float* __restrict__ out) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * EXPD_THREADS
                    + threadIdx.x;
  if (s >= slots) return;
  const int rs = rel_src[s];
  const int rt = rel_tgt[s];
  if (!(rs < BLK && rt < BLK)) {
    for (int j = 0; j < k; ++j) out[j * slots + s] = 0.0f;
    return;
  }
  const int64_t c = s / E_C;
  const int64_t u = static_cast<int64_t>(src_blk[c]) * BLK + rs;
  const int64_t t = static_cast<int64_t>(grp_tgt[c / group]) * BLK + rt;
  const S* ss = scores + clip(u, rows) * 2 * k;
  const S* ts = scores + clip((u / vs) * vs + t, rows) * 2 * k + k;
  const float* mx = maxes + clip(t, v) * k;
  for (int j = 0; j < k; ++j) {
    const float p = to_f32(ss[j]) + to_f32(ts[j]);
    out[j * slots + s] = expf(leaky(p) - mx[j]);
  }
}

struct BwdArgs {
  const void* table;      // [rows, h] stream dtype
  const void* dw;         // [v, h] stream dtype
  const float* d_denom;   // [v, k]
  const void* scores;     // [rows, 2k] stream dtype
  const float* maxes;     // [v, k]
  int64_t rows;
  int h, k, v, vs;
  const int32_t* rel_src;
  const int32_t* rel_tgt;
  const int32_t* src_blk;
  const int32_t* grp_tgt;
  int group;
  float* d_ss;            // [rows, k]
  float* d_ts;            // [rows, k]
  float* d_table;         // [rows, h]
};

// Dynamic shared memory: e per slot and head, the d_table tile, the d_ss
// tile and the touched-row flags.
__host__ __device__ inline size_t bwd_smem_bytes(int group, int k) {
  return (static_cast<size_t>(group) * E_C * k + BLK * HT + BLK * k)
             * sizeof(float)
         + BLK * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) bwd_fused_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int num_slots = a.group * E_C;
  const int k = a.k;
  float* e_s = smem;                                   // [num_slots, k]
  float* acc = e_s + static_cast<size_t>(num_slots) * k;  // [BLK, HT]
  float* dss = acc + BLK * HT;                         // [BLK, k]
  int* touched = reinterpret_cast<int*>(dss + BLK * k);  // [BLK]

  const T* __restrict__ table = static_cast<const T*>(a.table);
  const T* __restrict__ dw = static_cast<const T*>(a.dw);
  const T* __restrict__ scores = static_cast<const T*>(a.scores);
  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t u_base = static_cast<int64_t>(a.grp_tgt[g]) * BLK;
  const int64_t slot0 = static_cast<int64_t>(g) * num_slots;

  for (int i = threadIdx.x; i < BLK * k; i += THREADS) dss[i] = 0.0f;
  for (int i = threadIdx.x; i < BLK; i += THREADS) touched[i] = 0;
  __syncthreads();

  // Phase 1: e and d_p per valid slot, one warp per slot.
  for (int base = warp * 32; base < num_slots; base += WARPS * 32) {
    const int64_t s = slot0 + base + lane;
    const int rs = a.rel_src[s];   // plan-"src": the target node
    const int rt = a.rel_tgt[s];   // plan-"tgt": the source row
    const bool valid = rs >= 0 && rs < BLK && rt >= 0 && rt < BLK;
    const int64_t t = static_cast<int64_t>(a.src_blk[s / E_C]) * BLK
                      + (valid ? rs : 0);
    if (valid) touched[rt] = 1;
    unsigned mask = __ballot_sync(FULL, valid);
    while (mask) {
      const int j = __ffs(mask) - 1;
      mask &= mask - 1;
      const int64_t tj = __shfl_sync(FULL, t, j);
      const int ru = __shfl_sync(FULL, rt, j);
      const int64_t u = u_base + ru;
      const T* urow = table + clip(u, a.rows) * a.h;
      const T* trow = dw + clip(tj, a.v) * a.h;
      float partial = 0.0f;
#pragma unroll 4
      for (int col = lane; col < a.h; col += 32) {
        partial += to_f32(urow[col]) * to_f32(trow[col]);
      }
      // Lane l summed the columns of head l % k; fold lanes of one head.
      for (int off = 16; off >= k; off >>= 1) {
        partial += __shfl_xor_sync(FULL, partial, off);
      }
      if (lane < k) {
        const int64_t ltype_base = (u / a.vs) * a.vs;
        const float p =
            to_f32(scores[clip(u, a.rows) * 2 * k + lane])
            + to_f32(scores[clip(ltype_base + tj, a.rows) * 2 * k + k + lane]);
        const int64_t tc = clip(tj, a.v);
        const float e = expf(leaky(p) - a.maxes[tc * k + lane]);
        const float slope = p >= 0.0f ? 1.0f : LEAKY_SLOPE;
        const float d_p = e * slope * (partial + a.d_denom[tc * k + lane]);
        e_s[(base + j) * k + lane] = e;
        if (u < a.rows) atomicAdd(&dss[ru * k + lane], d_p);
        const int64_t ts_row = ltype_base + tj;
        if (ts_row < a.rows) atomicAdd(&a.d_ts[ts_row * k + lane], d_p);
      }
    }
  }
  __syncthreads();

  // Phase 2: d_table, one 64-column tile at a time.
  for (int col0 = 0; col0 < a.h; col0 += HT) {
    for (int i = threadIdx.x; i < BLK * HT; i += THREADS) acc[i] = 0.0f;
    __syncthreads();
    for (int base = warp * 32; base < num_slots; base += WARPS * 32) {
      const int64_t s = slot0 + base + lane;
      const int rs = a.rel_src[s];
      const int rt = a.rel_tgt[s];
      const bool valid = rs >= 0 && rs < BLK && rt >= 0 && rt < BLK;
      const int64_t trow = clip(
          static_cast<int64_t>(a.src_blk[s / E_C]) * BLK + (valid ? rs : 0),
          a.v);
      unsigned mask = __ballot_sync(FULL, valid);
      while (mask) {
        int64_t r[UNROLL];
        int ru[UNROLL];
        float e[UNROLL];
        bool ok[UNROLL];
#pragma unroll
        for (int q = 0; q < UNROLL; ++q) {
          ok[q] = mask != 0;
          const int j = ok[q] ? __ffs(mask) - 1 : 0;
          if (ok[q]) mask &= mask - 1;
          r[q] = __shfl_sync(FULL, trow, j);
          ru[q] = __shfl_sync(FULL, rt, j);
          // Every column a lane touches belongs to head lane % k.
          e[q] = ok[q] ? e_s[(base + j) * k + lane % k] : 0.0f;
        }
        float val[UNROLL][COLS_PER_LANE];
#pragma unroll
        for (int q = 0; q < UNROLL; ++q) {
#pragma unroll
          for (int c = 0; c < COLS_PER_LANE; ++c) {
            const int col = col0 + lane + 32 * c;
            val[q][c] = (ok[q] && col < a.h) ? to_f32(dw[r[q] * a.h + col])
                                             : 0.0f;
          }
        }
#pragma unroll
        for (int q = 0; q < UNROLL; ++q) {
          if (!ok[q]) continue;
#pragma unroll
          for (int c = 0; c < COLS_PER_LANE; ++c) {
            const int col = lane + 32 * c;
            if (col0 + col < a.h) {
              atomicAdd(&acc[ru[q] * HT + col], val[q][c] * e[q]);
            }
          }
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BLK * HT; i += THREADS) {
      const int rr = i / HT;
      const int col = col0 + i % HT;
      const int64_t row = u_base + rr;
      if (touched[rr] && col < a.h && row < a.rows) {
        atomicAdd(&a.d_table[row * a.h + col], acc[i]);
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < BLK * k; i += THREADS) {
    const int rr = i / k;
    const int64_t row = u_base + rr;
    if (touched[rr] && row < a.rows) {
      atomicAdd(&a.d_ss[row * k + i % k], dss[i]);
    }
  }
}

// dtype codes shared with the Python wrapper.
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

bool heads_ok(int k) { return k > 0 && k <= 32 && 32 % k == 0; }

}  // namespace

// C entry points. Each returns the cudaError_t of its launch
// (cudaGetLastError right after it); 0 is success.

extern "C" int pair_attention_expd_launch(
    int device, int dtype, const void* scores, int64_t rows,
    const float* maxes, int v, int k, const int32_t* rel_src,
    const int32_t* rel_tgt, const int32_t* src_blk, const int32_t* grp_tgt,
    int group, int64_t slots, int vs, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!heads_ok(k) || group <= 0 || slots <= 0 || rows <= 0 || v <= 0
      || vs <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((slots + EXPD_THREADS - 1)
                                        / EXPD_THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    expd_kernel<float><<<grid, EXPD_THREADS, 0, s>>>(
        static_cast<const float*>(scores), rows, maxes, v, k, rel_src,
        rel_tgt, src_blk, grp_tgt, group, slots, vs, out);
  } else if (dtype == DTYPE_BF16) {
    expd_kernel<__nv_bfloat16><<<grid, EXPD_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(scores), rows, maxes, v, k,
        rel_src, rel_tgt, src_blk, grp_tgt, group, slots, vs, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_bwd(const BwdArgs& a, int num_groups, cudaStream_t s) {
  const size_t smem = bwd_smem_bytes(a.group, a.k);
  // Above 48 KB a block's shared memory must be raised explicitly.
  cudaError_t err = cudaFuncSetAttribute(
      bwd_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_fused_kernel<T><<<num_groups, THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pair_attention_bwd_fused_launch(
    int device, int dtype, const void* table, const void* dw,
    const float* d_denom, const void* scores, const float* maxes,
    int64_t rows, int h, int k, int v, int vs, const int32_t* rel_src,
    const int32_t* rel_tgt, const int32_t* src_blk, const int32_t* grp_tgt,
    int group, int num_groups, float* d_ss, float* d_ts, float* d_table,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!heads_ok(k) || h <= 0 || h % k || group <= 0 || num_groups <= 0
      || rows <= 0 || v <= 0 || vs <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a{table, dw, d_denom, scores, maxes, rows, h, k, v, vs,
                  rel_src, rel_tgt, src_blk, grp_tgt, group, d_ss, d_ts,
                  d_table};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return launch_bwd<float>(a, num_groups, s);
  if (dtype == DTYPE_BF16) return launch_bwd<__nv_bfloat16>(a, num_groups, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* pair_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
