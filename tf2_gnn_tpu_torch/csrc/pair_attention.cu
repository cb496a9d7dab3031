// Relational-attention kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes) by tf2_gnn_tpu_torch/ops/pair_attention.py. Both
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
//                 8-byte units. Wider rows take the tiled form,
//                 bwd_rows_tiled_kernel, as the reference's kernel takes any
//                 width: per entry, in slot order, the head sums over every
//                 column tile of table[u] (re-read from L1 a tile at a
//                 time) and dw[t], then e and d_p; then per column tile of
//                 d_table[u] the entries again (dw[t] and e, recomputed
//                 from the same f32 inputs by the same instructions), into
//                 f32 register sums stored once a tile. Bound: bytes (the
//                 distinct table, dw and score rows, the f32 m and d_denom
//                 rows, the compact forms, the f32 outputs); the f32
//                 operations (4 a valid
//                 slot and column) take about a quarter of that time on
//                 the PPI shapes. Like the other row owners it waits on L2
//                 latency: few gathers in flight and low registers (more
//                 resident warps) ran faster on an H100 than deep unrolling.
//                 The tiled form reads dw[t] twice and table[u] once an
//                 entry (from L1), for rows its registers cannot hold.
//
// B10, RGAT's hk-major aggregation, is csrc/pair_stream.cu's
// head_rows_kernel over the forward plan's compact form, and B11, the
// "exact" stabiliser, its max_rows_kernel over the same form.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "lane_units.cuh"

namespace {

constexpr int BLK = 128;
constexpr int E_C = 128;
constexpr float LEAKY_SLOPE = 0.2f;
constexpr int EXPD_THREADS = 256;

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

// One warp owns source row u; units of E elements, W a lane (a tile, in
// the tiled form), cover the row. Element i of each of a lane's units lies
// in a column of head (lane * E + i) % K, the same for all its units (K
// divides 32 and 32 * E columns separate them), so a lane folds its
// products into HL head sums; lanes that differ only in bits >= STOP hold
// the same heads. A reduce-scatter folds those sums across the warp: its
// first log2(HL) steps (xor 16, 8, ...) halve the sums a lane keeps, so
// that afterwards a lane holds the warp's whole sum of one head, head0 +
// sel with sel its top log2(HL) bits; it computes that head's e and d_p
// alone, and takes the e of its other heads from the lanes that hold them.
template <int E, int K>
struct Heads {
  static constexpr int HL = K < E ? K : E;  // heads a lane holds
  static constexpr int STOP = K > E ? K / E : 1;
  static constexpr int LOG_HL = HL == 1 ? 0 : (HL == 2 ? 1 : 2);
  static_assert(HL == 1 << LOG_HL, "HL: 1, 2 or 4");
  // The lanes of one head after the reduce-scatter differ in the bits of
  // PLAIN_MASK; lane & ~SEL_MASK | j << SEL_SHIFT holds head head0 + j.
  static constexpr int SEL_SHIFT = 5 - LOG_HL;
  static constexpr int SEL_MASK = (HL - 1) << SEL_SHIFT;
  static constexpr int PLAIN_MASK = ((32 >> LOG_HL) - 1) & ~(STOP - 1);

  // The warp's sum of the lane's head (head0 + (lane >> SEL_SHIFT) % HL)
  // from each lane's HL partial head sums.
  __device__ static __forceinline__ float fold(float* part, int lane) {
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
    return sum;
  }

  // eh[j]: the e of head head0 + j, from the lane that computed it.
  __device__ static __forceinline__ void share(float e, int lane,
                                               float* eh) {
#pragma unroll
    for (int jh = 0; jh < HL; ++jh) {
      eh[jh] = HL == 1 ? e
                       : __shfl_sync(FULL, e,
                                     (lane & ~SEL_MASK) | (jh << SEL_SHIFT));
    }
  }
};

template <typename T, int UB, int W, int K>
__global__ void __launch_bounds__(ROW_THREADS) bwd_rows_kernel(BwdRowsArgs a) {
  using U = Unit<T, UB>;
  using H = Heads<U::kElems, K>;
  constexpr int E = U::kElems;
  constexpr int HL = H::HL;
  // Gathers in flight: one (64 registers at H = 320, 4 blocks an SM); on
  // an H100 two ran slower at H = 64 too, and deeper unrolling slower
  // still, its registers costing resident warps (PERF.md).
  constexpr int IN_FLIGHT = 1;
  const int lane = threadIdx.x & 31;
  const int64_t u =
      static_cast<int64_t>(blockIdx.x) * ROW_WARPS + (threadIdx.x >> 5);
  if (u >= a.rows) return;  // warp-uniform
  const int units = a.h / E;
  const int head0 = (lane * E) % K;  // the lane's heads: head0 + j, j < HL
  const int head = head0 + (lane >> H::SEL_SHIFT) % HL;  // after the fold
  const bool writer = (lane & H::PLAIN_MASK) == 0;       // one lane a head

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
        const float sum = H::fold(part, lane);
        const float p = ss + ts[q];
        const float e = expf(leaky(p) - mx[q]);
        const float slope = p >= 0.0f ? 1.0f : LEAKY_SLOPE;
        const float d_p = e * slope * (sum + dd[q]);
        dss += d_p;
        if (writer) {
          a.d_p[static_cast<int64_t>(base + j0 + q) * K + head] = d_p;
        }
        float eh[HL];
        H::share(e, lane, eh);
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

// e = exp(leaky(p) - m) with no step contracted into an FMA, so that the
// tiled form's two walks over an entry compute one value.
__device__ __forceinline__ float entry_e(float p, float mx) {
  return expf(__fsub_rn(p >= 0.0f ? p : __fmul_rn(LEAKY_SLOPE, p), mx));
}

// B9's tiled form, for rows wider than the register form holds: W units a
// lane make a column tile of 32 * W units. One walk over u's entries sums
// each entry's heads over every tile (table[u]'s tile re-read from L1
// with dw[t]'s), then computes its e and d_p; then, per tile, a second
// walk sums d_table[u]'s tile in registers and stores it once.
template <typename T, int UB, int W, int K>
__global__ void __launch_bounds__(ROW_THREADS)
    bwd_rows_tiled_kernel(BwdRowsArgs a) {
  using U = Unit<T, UB>;
  using H = Heads<U::kElems, K>;
  constexpr int E = U::kElems;
  constexpr int HL = H::HL;
  constexpr int TILE = 32 * W;  // units
  const int lane = threadIdx.x & 31;
  const int64_t u =
      static_cast<int64_t>(blockIdx.x) * ROW_WARPS + (threadIdx.x >> 5);
  if (u >= a.rows) return;  // warp-uniform
  const int units = a.h / E;
  const int head = (lane * E) % K + (lane >> H::SEL_SHIFT) % HL;
  const bool writer = (lane & H::PLAIN_MASK) == 0;
  const T* scores = static_cast<const T*>(a.scores);
  const float ss = to_f32(scores[u * 2 * K + head]);
  const int begin = __ldg(a.row_ptr + u);
  const int end = __ldg(a.row_ptr + u + 1);

  float dss = 0.0f;
  for (int base = begin; base < end; base += 32) {
    const int count = min(32, end - base);  // warp-uniform
    int t = 0, sr = 0;
    if (lane < count) {
      t = __ldg(a.t_row + base + lane);
      sr = __ldg(a.score_row + base + lane);
    }
    for (int j = 0; j < count; ++j) {
      const int64_t tq = __shfl_sync(FULL, t, j);
      const int64_t sq = __shfl_sync(FULL, sr, j);
      const float ts = to_f32(scores[sq * 2 * K + K + head]);
      const float mx = __ldg(a.maxes + tq * K + head);
      const float dd = __ldg(a.d_denom + tq * K + head);
      float part[HL];
#pragma unroll
      for (int jh = 0; jh < HL; ++jh) part[jh] = 0.0f;
      for (int tile = 0; tile < units; tile += TILE) {
        typename U::Raw tv[W], xv[W];
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int unit = tile + lane + 32 * k;
          const bool ok = unit < units;
          tv[k] = ok ? U::load(a.table, u * units + unit) : U::zero();
          xv[k] = ok ? U::load(a.dw, tq * units + unit) : U::zero();
        }
#pragma unroll
        for (int k = 0; k < W; ++k) {
          float tf[E], xf[E];
          U::unpack(tv[k], tf);
          U::unpack(xv[k], xf);
#pragma unroll
          for (int i = 0; i < E; ++i) {
            part[i % HL] = fmaf(tf[i], xf[i], part[i % HL]);
          }
        }
      }
      const float sum = H::fold(part, lane);
      const float p = ss + ts;
      const float d_p = entry_e(p, mx) * (p >= 0.0f ? 1.0f : LEAKY_SLOPE)
                        * (sum + dd);
      dss += d_p;
      if (writer) a.d_p[static_cast<int64_t>(base + j) * K + head] = d_p;
    }
  }
  if (writer) a.d_ss[u * K + head] = dss;

  for (int tile = 0; tile < units; tile += TILE) {
    float acc[W][E];
#pragma unroll
    for (int k = 0; k < W; ++k)
#pragma unroll
      for (int i = 0; i < E; ++i) acc[k][i] = 0.0f;
    for (int base = begin; base < end; base += 32) {
      const int count = min(32, end - base);  // warp-uniform
      int t = 0, sr = 0;
      if (lane < count) {
        t = __ldg(a.t_row + base + lane);
        sr = __ldg(a.score_row + base + lane);
      }
      for (int j = 0; j < count; ++j) {
        const int64_t tq = __shfl_sync(FULL, t, j);
        const int64_t sq = __shfl_sync(FULL, sr, j);
        typename U::Raw xv[W];
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int unit = tile + lane + 32 * k;
          xv[k] = unit < units ? U::load(a.dw, tq * units + unit)
                               : U::zero();
        }
        const float e = entry_e(ss + to_f32(scores[sq * 2 * K + K + head]),
                                __ldg(a.maxes + tq * K + head));
        float eh[HL];
        H::share(e, lane, eh);
#pragma unroll
        for (int k = 0; k < W; ++k) {
          float xf[E];
          U::unpack(xv[k], xf);
#pragma unroll
          for (int i = 0; i < E; ++i) {
            acc[k][i] = fmaf(xf[i], eh[i % HL], acc[k][i]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int unit = tile + lane + 32 * k;
      if (unit < units) {
        store_f32<E>(a.d_table + u * a.h + static_cast<int64_t>(unit) * E,
                     acc[k]);
      }
    }
  }
}

template <typename T, int UB, int W, int K, bool kTiled>
void launch_bwd_w(dim3 grid, cudaStream_t s, const BwdRowsArgs& a) {
  if constexpr (kTiled) {
    bwd_rows_tiled_kernel<T, UB, W, K><<<grid, ROW_THREADS, 0, s>>>(a);
  } else {
    bwd_rows_kernel<T, UB, W, K><<<grid, ROW_THREADS, 0, s>>>(a);
  }
}

// Units a lane, instantiated: in the register form 8-byte units 1 or 3,
// element units 1, 2, 4, 10 or 16, the smallest that holds the row (5
// 8-byte units a lane spilled at bf16); in the tiled form 3 8-byte or 8
// element units a tile.
template <typename T, int UB, int K>
void launch_bwd_units(int units, bool tiled, dim3 grid, cudaStream_t s,
                      const BwdRowsArgs& a) {
  const int need = (units + 31) / 32;
  if constexpr (UB == 8) {
    if (tiled) launch_bwd_w<T, UB, 3, K, true>(grid, s, a);
    else if (need <= 1) launch_bwd_w<T, UB, 1, K, false>(grid, s, a);
    else launch_bwd_w<T, UB, 3, K, false>(grid, s, a);
  } else {
    if (tiled) launch_bwd_w<T, UB, 8, K, true>(grid, s, a);
    else if (need <= 1) launch_bwd_w<T, UB, 1, K, false>(grid, s, a);
    else if (need <= 2) launch_bwd_w<T, UB, 2, K, false>(grid, s, a);
    else if (need <= 4) launch_bwd_w<T, UB, 4, K, false>(grid, s, a);
    else if (need <= 10) launch_bwd_w<T, UB, 10, K, false>(grid, s, a);
    else launch_bwd_w<T, UB, 16, K, false>(grid, s, a);
  }
}

template <typename T, int UB>
void launch_bwd_heads(int k, int units, bool tiled, dim3 grid,
                      cudaStream_t s, const BwdRowsArgs& a) {
  switch (k) {
    case 1: launch_bwd_units<T, UB, 1>(units, tiled, grid, s, a); break;
    case 2: launch_bwd_units<T, UB, 2>(units, tiled, grid, s, a); break;
    case 4: launch_bwd_units<T, UB, 4>(units, tiled, grid, s, a); break;
    default: launch_bwd_units<T, UB, 8>(units, tiled, grid, s, a); break;
  }
}

// The most lane units a row of the register form may have: 3 8-byte or
// 16 element units a lane.
constexpr int MAX_UNITS_8 = 32 * 3;
constexpr int MAX_UNITS_1 = 32 * 16;

template <typename T>
int launch_bwd(int k, const BwdRowsArgs& a, cudaStream_t s) {
  constexpr int kItem = static_cast<int>(sizeof(T));
  const int64_t row_bytes = static_cast<int64_t>(a.h) * kItem;
  // 8-byte units where a row has a warp of them and the row and the
  // tables' alignment allow them: on an H100 the faster at K = 4, H = 320
  // bf16, and element units at K = 8, H = 64 bf16 (PERF.md). A row that
  // neither register form holds takes the tiled form, in 8-byte units
  // where they fit.
  const bool eight_fits = row_bytes % 8 == 0 && row_bytes / 8 >= 32
                          && aligned(a.table, 8) && aligned(a.dw, 8)
                          && aligned(a.d_table, 16);
  const bool eight = eight_fits && row_bytes / 8 <= MAX_UNITS_8;
  const bool tiled = !eight && a.h > MAX_UNITS_1;
  const dim3 grid(
      static_cast<unsigned>((a.rows + ROW_WARPS - 1) / ROW_WARPS));
  if (eight || (tiled && eight_fits)) {
    launch_bwd_heads<T, 8>(k, a.h * kItem / 8, tiled, grid, s, a);
  } else {
    launch_bwd_heads<T, kItem>(k, a.h, tiled, grid, s, a);
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
