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
// bwd_rows_kernel <- tf2_gnn_tpu/ops/pair_attention.py:661
//                 (_bwd_fused_device, pallas_call :860; jnp twin
//                 _bwd_fused_jnp), B9, over the backward plan (its plan-"src"
//                 is the target node t, its plan-"tgt" the source row u). Per
//                 valid slot, with e = expd recomputed from the scores and m,
//                 slope = p >= 0 ? 1 : 0.2 and
//                   de[k] = sum over hd of table[u, hd*K+k] * dw[t, hd*K+k]
//                           + d_denom[t, k],   d_p = e * slope * de:
//                   d_ss[u] += d_p,   d_ts[(u / vs) * vs + t] += d_p,
//                   d_table[u, hd*K+k] += e[k] * dw[t, hd*K+k].
//                 The row owner by source row u, over the backward plan's
//                 compact form (ops/pair_spmm.py::slot_rows into the rows of
//                 u from the v rows of dw, MergedPlan.bwd_rows: the valid
//                 slots as a CSR by u, each with clip(t, v)) and each
//                 entry's target-score row clip((u / vs) * vs + t, rows)
//                 (ops/pair_spmm.py::TsRows), both built once per batch and
//                 kept on the plan. One warp owns u: it holds table[u] in
//                 registers, gathers each entry's dw row (with its m,
//                 d_denom and target score), folds the entry's head sums
//                 across the warp, computes e and d_p, and keeps d_ss[u]
//                 and d_table[u] as f32 register sums in the row's slot
//                 order, each stored once. d_ts is scattered to other rows,
//                 so each entry's d_p goes to an f32 [n, K] scratch row,
//                 and a second pass, csrc/pair_stream.cu's row owner
//                 (pair_attention_ts_launch), sums those rows by d_ts row
//                 over the second CSR of TsRows. No padded slot is walked,
//                 nothing goes through shared memory, there are no atomics
//                 and two launches give the same bits. Heads: the columns
//                 are hk-major (head = column % K, K divides 32). A lane
//                 unit is 8 bytes (4 bf16 or 2 f32 columns, so a lane holds
//                 min(K, 4 or 2) heads) or one element (every column of a
//                 lane of head lane % K): 8-byte units where a row has at
//                 least a warp of them; the head sums fold by a
//                 reduce-scatter (below), so each lane computes one head's
//                 e and d_p. The whole row lives in one warp's registers: H
//                 up to 512 with element units, 384 bf16 (192 f32) with
//                 8-byte units; wider rows are refused, and the route gate
//                 (ops/pair_attention.py::pair_attention_applicable) sends
//                 their layers to the sorted-scatter route. Bound: bytes (the distinct table, dw and
//                 score rows, the f32 m and d_denom rows, the compact
//                 forms, the f32 outputs); the f32 operations (4 a valid
//                 slot and column) take about a quarter of that time on
//                 the PPI shapes. Like the other row owners it waits on L2
//                 latency: few gathers in flight and low registers (more
//                 resident warps) ran faster on an H100 than deep unrolling.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "float_atomics.cuh"
#include "lane_units.cuh"

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

// B9, pass 1: the row owner by source row u.

struct BwdRowsArgs {
  const void* table;         // [rows, h] stream dtype, hk-major heads
  const void* dw;            // [v, h] stream dtype
  const float* d_denom;      // [v, k]
  const void* scores;        // [rows, 2k] stream dtype
  const float* maxes;        // [v, k]
  int h;
  const int32_t* row_ptr;    // [rows + 1]: entries by source row u
  const int32_t* t_row;      // [n] the target node, clipped into [0, v)
  const int32_t* score_row;  // [n] clip((u / vs) * vs + t, rows)
  int64_t rows;
  float* d_ss;               // [rows, k]
  float* d_table;            // [rows, h]
  float* d_p;                // [n, k]: each entry's d_p, for pass 2
};

// One warp owns source row u; W units of UB bytes a lane cover the row.
// Element i of each of a lane's units lies in a column of head
// (lane * E + i) % K, the same for all its units (K divides 32 and 32 * E
// columns separate them), so a lane folds its products into HL head sums;
// lanes that differ only in bits >= STOP hold the same heads. A
// reduce-scatter folds those sums across the warp: its first log2(HL)
// steps (xor 16, 8, ...) halve the sums a lane keeps, so that afterwards
// a lane holds the warp's whole sum of one head, head0 + sel with sel its
// top log2(HL) bits; it computes that head's e and d_p alone, and takes
// the e of its other heads from the lanes that hold them.
template <typename T, int UB, int W, int K>
__global__ void __launch_bounds__(ROW_THREADS) bwd_rows_kernel(BwdRowsArgs a) {
  using U = Unit<T, UB>;
  constexpr int E = U::kElems;
  constexpr int HL = K < E ? K : E;         // heads a lane holds
  constexpr int STOP = K > E ? K / E : 1;
  constexpr int LOG_HL = HL == 1 ? 0 : (HL == 2 ? 1 : 2);
  static_assert(HL == 1 << LOG_HL, "HL: 1, 2 or 4");
  // The lanes of one head after the reduce-scatter differ in the bits of
  // PLAIN_MASK; lane & ~SEL_MASK | j << SEL_SHIFT holds head head0 + j.
  constexpr int SEL_SHIFT = 5 - LOG_HL;
  constexpr int SEL_MASK = (HL - 1) << SEL_SHIFT;
  constexpr int PLAIN_MASK = ((32 >> LOG_HL) - 1) & ~(STOP - 1);
  // Gathers in flight: one at H = 320 (64 registers, 4 blocks an SM), two
  // at H = 64; on an H100 deeper unrolling ran slower, its registers
  // costing resident warps.
  constexpr int IN_FLIGHT = W * U::kWords <= 4 ? 2 : 1;
  const int lane = threadIdx.x & 31;
  const int64_t u =
      static_cast<int64_t>(blockIdx.x) * ROW_WARPS + (threadIdx.x >> 5);
  if (u >= a.rows) return;  // warp-uniform
  const int units = a.h / E;
  const int head0 = (lane * E) % K;  // the lane's heads: head0 + j, j < HL
  const int head = head0 + (lane >> SEL_SHIFT) % HL;  // after the fold
  const bool writer = (lane & PLAIN_MASK) == 0;       // one lane a head

  float tab[W][E], acc[W][E];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int unit = lane + 32 * k;
    U::unpack(unit < units ? U::load(a.table, u * units + unit) : U::zero(),
              tab[k]);
#pragma unroll
    for (int i = 0; i < E; ++i) acc[k][i] = 0.0f;
  }
  const float ss = to_f32(static_cast<const T*>(a.scores)[u * 2 * K + head]);
  float dss = 0.0f;

  const int begin = __ldg(a.row_ptr + u);
  const int end = __ldg(a.row_ptr + u + 1);
  for (int base = begin; base < end; base += 32) {
    const int count = min(32, end - base);  // warp-uniform
    // Entry j of the round sits in lane j.
    int t = 0, sr = 0;
    if (lane < count) {
      t = __ldg(a.t_row + base + lane);
      sr = __ldg(a.score_row + base + lane);
    }
    for (int j0 = 0; j0 < count; j0 += IN_FLIGHT) {
      typename U::Raw val[IN_FLIGHT][W];
      float ts[IN_FLIGHT], mx[IN_FLIGHT], dd[IN_FLIGHT];
#pragma unroll
      for (int q = 0; q < IN_FLIGHT; ++q) {
        const int j = (j0 + q) & 31;
        const int64_t tq = __shfl_sync(FULL, t, j);
        const int64_t sq = __shfl_sync(FULL, sr, j);
        const bool ok = j0 + q < count;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int unit = lane + 32 * k;
          val[q][k] = (ok && unit < units) ? U::load(a.dw, tq * units + unit)
                                           : U::zero();
        }
        // The target score, m and d_denom of the lane's head after the fold.
        ts[q] = ok ? to_f32(static_cast<const T*>(a.scores)[sq * 2 * K + K
                                                             + head])
                   : 0.0f;
        mx[q] = ok ? __ldg(a.maxes + tq * K + head) : 0.0f;
        dd[q] = ok ? __ldg(a.d_denom + tq * K + head) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < IN_FLIGHT; ++q) {
        if (j0 + q >= count) break;  // warp-uniform
        float x[W][E];
        float part[HL];
#pragma unroll
        for (int jh = 0; jh < HL; ++jh) part[jh] = 0.0f;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          U::unpack(val[q][k], x[k]);
#pragma unroll
          for (int i = 0; i < E; ++i) {
            part[i % HL] = fmaf(tab[k][i], x[k][i], part[i % HL]);
          }
        }
        // The reduce-scatter: halve the kept sums, then fold the rest.
#pragma unroll
        for (int s = 0; s < LOG_HL; ++s) {
          const int off = 16 >> s;
          const int half = HL >> (s + 1);
          const bool upper = lane & off;
#pragma unroll
          for (int j = 0; j < half; ++j) {
            const float keep = upper ? part[j + half] : part[j];
            const float give = upper ? part[j] : part[j + half];
            part[j] = keep + __shfl_xor_sync(FULL, give, off);
          }
        }
        float sum = part[0];
#pragma unroll
        for (int off = 16 >> LOG_HL; off >= STOP; off >>= 1) {
          sum += __shfl_xor_sync(FULL, sum, off);
        }
        const float p = ss + ts[q];
        const float e = expf(leaky(p) - mx[q]);
        const float slope = p >= 0.0f ? 1.0f : LEAKY_SLOPE;
        const float d_p = e * slope * (sum + dd[q]);
        dss += d_p;
        if (writer) {
          a.d_p[static_cast<int64_t>(base + j0 + q) * K + head] = d_p;
        }
        float eh[HL];
#pragma unroll
        for (int jh = 0; jh < HL; ++jh) {
          eh[jh] = HL == 1 ? e
                           : __shfl_sync(FULL, e,
                                         (lane & ~SEL_MASK)
                                             | (jh << SEL_SHIFT));
        }
#pragma unroll
        for (int k = 0; k < W; ++k) {
#pragma unroll
          for (int i = 0; i < E; ++i) {
            acc[k][i] = fmaf(x[k][i], eh[i % HL], acc[k][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int unit = lane + 32 * k;
    if (unit < units) {
      store_f32<E>(a.d_table + u * a.h + static_cast<int64_t>(unit) * E,
                   acc[k]);
    }
  }
  if (writer) a.d_ss[u * K + head] = dss;
}

template <typename T, int UB, int W, int K>
void launch_bwd_w(dim3 grid, cudaStream_t s, const BwdRowsArgs& a) {
  bwd_rows_kernel<T, UB, W, K><<<grid, ROW_THREADS, 0, s>>>(a);
}

// Units a lane, instantiated: 8-byte units 1 or 3, element units 1, 2, 4,
// 10 or 16; the smallest that holds the row. (5 8-byte units a lane
// spilled at bf16.)
template <typename T, int UB, int K>
void launch_bwd_units(int units, dim3 grid, cudaStream_t s,
                      const BwdRowsArgs& a) {
  const int need = (units + 31) / 32;
  if constexpr (UB == 8) {
    if (need <= 1) launch_bwd_w<T, UB, 1, K>(grid, s, a);
    else launch_bwd_w<T, UB, 3, K>(grid, s, a);
  } else {
    if (need <= 1) launch_bwd_w<T, UB, 1, K>(grid, s, a);
    else if (need <= 2) launch_bwd_w<T, UB, 2, K>(grid, s, a);
    else if (need <= 4) launch_bwd_w<T, UB, 4, K>(grid, s, a);
    else if (need <= 10) launch_bwd_w<T, UB, 10, K>(grid, s, a);
    else launch_bwd_w<T, UB, 16, K>(grid, s, a);
  }
}

template <typename T, int UB>
void launch_bwd_heads(int k, int units, dim3 grid, cudaStream_t s,
                      const BwdRowsArgs& a) {
  switch (k) {
    case 1: launch_bwd_units<T, UB, 1>(units, grid, s, a); break;
    case 2: launch_bwd_units<T, UB, 2>(units, grid, s, a); break;
    case 4: launch_bwd_units<T, UB, 4>(units, grid, s, a); break;
    default: launch_bwd_units<T, UB, 8>(units, grid, s, a); break;
  }
}

// The most lane units a row may have: 3 8-byte or 16 element units a lane.
constexpr int MAX_UNITS_8 = 32 * 3;
constexpr int MAX_UNITS_1 = 32 * 16;

template <typename T>
int launch_bwd(int k, const BwdRowsArgs& a, cudaStream_t s) {
  constexpr int kItem = static_cast<int>(sizeof(T));
  const int64_t row_bytes = static_cast<int64_t>(a.h) * kItem;
  // 8-byte units where a row has a warp of them and the row and the
  // tables' alignment allow them: on an H100 the faster at K = 4, H = 320
  // bf16, and element units at K = 8, H = 64 bf16 (PERF.md).
  const bool eight = row_bytes % 8 == 0 && row_bytes / 8 >= 32
                     && row_bytes / 8 <= MAX_UNITS_8 && aligned(a.table, 8)
                     && aligned(a.dw, 8) && aligned(a.d_table, 16);
  if (!eight && a.h > MAX_UNITS_1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(
      static_cast<unsigned>((a.rows + ROW_WARPS - 1) / ROW_WARPS));
  if (eight) {
    launch_bwd_heads<T, 8>(k, a.h * kItem / 8, grid, s, a);
  } else {
    launch_bwd_heads<T, kItem>(k, a.h, grid, s, a);
  }
  return static_cast<int>(cudaGetLastError());
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

// B9's first pass: d_ss and d_table, f32 [rows, k] and [rows, h], every
// element stored once, and each entry's d_p into d_p [n, k].
extern "C" int pair_attention_bwd_rows_launch(
    int device, int dtype, const void* table, const void* dw,
    const float* d_denom, const void* scores, const float* maxes,
    int64_t rows, int h, int k, const int32_t* row_ptr, const int32_t* t_row,
    const int32_t* score_row, float* d_ss, float* d_table, float* d_p,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(k == 1 || k == 2 || k == 4 || k == 8) || h <= 0 || h % k
      || rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdRowsArgs a{table, dw, d_denom, scores, maxes, h, row_ptr, t_row,
                      score_row, rows, d_ss, d_table, d_p};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return launch_bwd<float>(k, a, s);
  if (dtype == DTYPE_BF16) return launch_bwd<__nv_bfloat16>(k, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* pair_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
