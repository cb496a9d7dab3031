// Relational-attention kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes) by tf2_gnn_tpu_torch/ops/pair_attention.py. All four
// read a pair plan (ops/pair_spmm.py::build_pair_plans; merged over the edge
// types, or one type's plan over its [V]-row slab): per slot s of group g
// (chunk c = s / E_C), padded where rel >= BLK,
//
//   a = src_blk[c] * BLK + rel_src[s],   b = grp_tgt[g] * BLK + rel_tgt[s].
//
// The packed score table is [rows, 2K] (source halves | target halves, both
// in the stacked l * vs + node row space); m is the f32 [V, K] softmax
// stabiliser, already rounded to the stream dtype by the caller. Products
// and sums run in f32; exp is expf (not __expf), so a kernel agrees with
// its plain version to f32 rounding.
//
// max_kernel   <- tf2_gnn_tpu/ops/pair_attention.py:174
//                 (_max_kernel_device, pallas_call :262; jnp twin
//                 _max_kernel_jnp), forward plan, the "exact" stabiliser.
//                 Per valid slot (a = source row u, b = target node t):
//                   out[t, k] = max(out[t, k],
//                                   leaky(ss[u, k] + ts[(u / vs) * vs + t, k]))
//                 into an output the wrapper fills with NEG, so a target
//                 with no in-edges reads NEG. The TPU kernel gathers both
//                 score halves with one-hot matmuls and takes a masked
//                 [BLK, E_C] max per head, carrying the output block across
//                 its sequential grid. Here one thread block takes one plan
//                 group (its chunks share one target block); each thread
//                 takes slots in turn, computes the K logits in f32 and folds
//                 them into a shared [128, K] max tile; the tile's entries
//                 then go out with one global atomic max each. Both maxes are
//                 the integer atomic of float_atomics.cuh, and a max does not
//                 depend on order, so the kernel equals its plain version
//                 exactly. Bound: bytes (the plan's 8 B a slot, the score
//                 rows, the f32 output); 4 f32 operations a slot and head.
//
// agg_kernel   <- tf2_gnn_tpu/ops/pair_attention.py:484
//                 (_agg_kernel_device, pallas_call :596; jnp twin
//                 _agg_kernel_jnp), forward plan, the hk-major aggregation
//                 that RGAT takes where K > 4 * ceil(H / 128) or head_dim + 1
//                 > 128. Per valid slot, with e = expd[:, s] (B8's [K, slots]
//                 output; the TPU streams its transpose, [slots, 16]):
//                   weighted[t, hd*K + k] += e[k] * table[u, hd*K + k],
//                   denom[t, k] += e[k].
//                 B3's structure: one thread block per (plan group, 64-column
//                 tile) gathers its valid slots' row segments warp-wide, adds
//                 e-scaled values into a shared [128, 64] f32 tile with
//                 shared atomics and adds the touched rows into the zeroed
//                 output with global atomics. K divides 32 and 64, so lane l
//                 always holds columns of head l % K and reads one e per
//                 slot. Only the blocks of column tile 0 sum the
//                 denominators (lanes l < K, into a shared [128, K] tile), as
//                 only the TPU's t == 0 sweep does; otherwise they would be
//                 counted once a tile. The TPU kernel rounds each scaled
//                 message to the table dtype before its one-hot product; like
//                 the jnp twin, this kernel keeps it f32 (ROADMAP queue C).
//                 Bound: bytes (the distinct table rows, the valid slots'
//                 f32 expd, the plan, the f32 outputs); 2 operations a valid
//                 slot and column.
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

#include "float_atomics.cuh"

namespace {

constexpr int BLK = 128;
constexpr int E_C = 128;
constexpr float LEAKY_SLOPE = 0.2f;
constexpr float NEG = -1e30f;   // the stabiliser of a target with no in-edges
constexpr int MAX_HEADS = 32;
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

template <typename S>
__global__ void __launch_bounds__(THREADS)
    max_kernel(const S* __restrict__ scores, int64_t rows, int v, int k,
               const int32_t* __restrict__ rel_src,
               const int32_t* __restrict__ rel_tgt,
               const int32_t* __restrict__ src_blk,
               const int32_t* __restrict__ grp_tgt, int group, int vs,
               float* __restrict__ out) {
  __shared__ float tile[BLK * MAX_HEADS];
  for (int i = threadIdx.x; i < BLK * k; i += THREADS) tile[i] = NEG;
  __syncthreads();

  const int num_slots = group * E_C;
  const int64_t slot0 = static_cast<int64_t>(blockIdx.x) * num_slots;
  const int64_t t_base = static_cast<int64_t>(grp_tgt[blockIdx.x]) * BLK;
  for (int i = threadIdx.x; i < num_slots; i += THREADS) {
    const int64_t s = slot0 + i;
    const int rs = rel_src[s];
    const int rt = rel_tgt[s];
    if (!(rs >= 0 && rs < BLK && rt >= 0 && rt < BLK)) continue;
    const int64_t u = static_cast<int64_t>(src_blk[s / E_C]) * BLK + rs;
    const S* ss = scores + clip(u, rows) * 2 * k;
    const S* ts = scores + clip((u / vs) * vs + t_base + rt, rows) * 2 * k + k;
    for (int j = 0; j < k; ++j) {
      atomic_max_f32(&tile[rt * k + j], leaky(to_f32(ss[j]) + to_f32(ts[j])));
    }
  }
  __syncthreads();

  // Entries still at the NEG fill leave the output's NEG as it is.
  for (int i = threadIdx.x; i < BLK * k; i += THREADS) {
    const int64_t t = t_base + i / k;
    const float m = tile[i];
    if (t < v && __float_as_int(m) != __float_as_int(NEG)) {
      atomic_max_f32(&out[t * k + i % k], m);
    }
  }
}

struct AggArgs {
  const void* table;      // [rows, h] stream dtype, hk-major heads
  int64_t rows;
  int h, k, v;
  const float* expd;      // [k, slots]
  int64_t slots;
  const int32_t* rel_src;
  const int32_t* rel_tgt;
  const int32_t* src_blk;
  const int32_t* grp_tgt;
  int group;
  float* denom;           // [v, k], zeroed
  float* weighted;        // [v, h], zeroed
};

// Dynamic shared memory: the weighted tile, the denominator tile and the
// touched-row flags.
__host__ __device__ inline size_t agg_smem_bytes(int k) {
  return (static_cast<size_t>(BLK) * HT + BLK * k) * sizeof(float)
         + BLK * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) agg_kernel(AggArgs a) {
  extern __shared__ float smem[];
  const int k = a.k;
  float* acc = smem;                                     // [BLK, HT]
  float* den = acc + BLK * HT;                           // [BLK, k]
  int* touched = reinterpret_cast<int*>(den + BLK * k);  // [BLK]

  const T* __restrict__ table = static_cast<const T*>(a.table);
  const int g = blockIdx.x;
  const int col0 = blockIdx.y * HT;
  const bool with_denom = blockIdx.y == 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // Column col0 + lane + 32 * c belongs to head lane % k (k divides 32).
  const float* __restrict__ e_row = a.expd + (lane % k) * a.slots;

  for (int i = threadIdx.x; i < BLK * HT; i += THREADS) acc[i] = 0.0f;
  for (int i = threadIdx.x; i < BLK * k; i += THREADS) den[i] = 0.0f;
  for (int i = threadIdx.x; i < BLK; i += THREADS) touched[i] = 0;
  __syncthreads();

  const int num_slots = a.group * E_C;
  const int64_t slot0 = static_cast<int64_t>(g) * num_slots;
  for (int base = warp * 32; base < num_slots; base += WARPS * 32) {
    const int64_t s = slot0 + base + lane;
    const int rs = a.rel_src[s];
    const int rt = a.rel_tgt[s];
    const bool valid = rs >= 0 && rs < BLK && rt >= 0 && rt < BLK;
    const int64_t row = clip(
        static_cast<int64_t>(a.src_blk[s / E_C]) * BLK + (valid ? rs : 0),
        a.rows);
    if (valid) touched[rt] = 1;
    unsigned mask = __ballot_sync(FULL, valid);
    while (mask) {
      int64_t r[UNROLL];
      int t[UNROLL];
      float e[UNROLL];
      bool ok[UNROLL];
#pragma unroll
      for (int q = 0; q < UNROLL; ++q) {
        ok[q] = mask != 0;
        const int j = ok[q] ? __ffs(mask) - 1 : 0;
        if (ok[q]) mask &= mask - 1;
        r[q] = __shfl_sync(FULL, row, j);
        t[q] = __shfl_sync(FULL, rt, j);
        e[q] = ok[q] ? e_row[slot0 + base + j] : 0.0f;
      }
      float val[UNROLL][COLS_PER_LANE];
#pragma unroll
      for (int q = 0; q < UNROLL; ++q) {
#pragma unroll
        for (int c = 0; c < COLS_PER_LANE; ++c) {
          const int col = col0 + lane + 32 * c;
          val[q][c] = (ok[q] && col < a.h) ? to_f32(table[r[q] * a.h + col])
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
            atomicAdd(&acc[t[q] * HT + col], val[q][c] * e[q]);
          }
        }
        // Lane l < k holds head l's e.
        if (with_denom && lane < k) atomicAdd(&den[t[q] * k + lane], e[q]);
      }
    }
  }
  __syncthreads();

  const int64_t out_base = static_cast<int64_t>(a.grp_tgt[g]) * BLK;
  for (int i = threadIdx.x; i < BLK * HT; i += THREADS) {
    const int rr = i / HT;
    const int col = col0 + i % HT;
    const int64_t orow = out_base + rr;
    if (touched[rr] && col < a.h && orow < a.v) {
      atomicAdd(&a.weighted[orow * a.h + col], acc[i]);
    }
  }
  if (with_denom) {
    for (int i = threadIdx.x; i < BLK * k; i += THREADS) {
      const int rr = i / k;
      const int64_t orow = out_base + rr;
      if (touched[rr] && orow < a.v) {
        atomicAdd(&a.denom[orow * k + i % k], den[i]);
      }
    }
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

extern "C" int pair_attention_max_launch(
    int device, int dtype, const void* scores, int64_t rows, int v, int k,
    const int32_t* rel_src, const int32_t* rel_tgt, const int32_t* src_blk,
    const int32_t* grp_tgt, int group, int num_groups, int vs, float* out,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!heads_ok(k) || group <= 0 || num_groups <= 0 || rows <= 0 || v <= 0
      || vs <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    max_kernel<float><<<num_groups, THREADS, 0, s>>>(
        static_cast<const float*>(scores), rows, v, k, rel_src, rel_tgt,
        src_blk, grp_tgt, group, vs, out);
  } else if (dtype == DTYPE_BF16) {
    max_kernel<__nv_bfloat16><<<num_groups, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(scores), rows, v, k, rel_src,
        rel_tgt, src_blk, grp_tgt, group, vs, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_agg(const AggArgs& a, int num_groups, cudaStream_t s) {
  const size_t smem = agg_smem_bytes(a.k);
  cudaError_t err = cudaFuncSetAttribute(
      agg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(num_groups),
                  static_cast<unsigned>((a.h + HT - 1) / HT));
  agg_kernel<T><<<grid, THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pair_attention_agg_launch(
    int device, int dtype, const void* table, int64_t rows, int h, int k,
    const float* expd, int64_t slots, const int32_t* rel_src,
    const int32_t* rel_tgt, const int32_t* src_blk, const int32_t* grp_tgt,
    int group, int num_groups, int v, float* denom, float* weighted,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!heads_ok(k) || h <= 0 || h % k || group <= 0 || num_groups <= 0
      || rows <= 0 || v <= 0
      || slots != static_cast<int64_t>(num_groups) * group * E_C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AggArgs a{table, rows, h, k, v, expd, slots, rel_src, rel_tgt,
                  src_blk, grp_tgt, group, denom, weighted};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return launch_agg<float>(a, num_groups, s);
  if (dtype == DTYPE_BF16) return launch_agg<__nv_bfloat16>(a, num_groups, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
