// Relu-pair kernels of the target-state edge MLP with one hidden layer, for
// Hopper (sm_90a), bound through a plain C interface (ctypes) by
// tf2_gnn_tpu_torch/ops/pair_edge_mlp.py. All four compute a function of a
// MERGED-TARGET pair plan (ops/pair_spmm.py::build_pair_plans(
// merge_targets=True)): per slot s of group g (chunk c = s / E_C), padded
// where rel >= BLK,
//
//   src = src_blk[c] * BLK + rel_src[s],   tgt = grp_tgt[g] * BLK + rel_tgt[s],
//
// with A the stacked per-type source halves [L*S, H] and B the target halves
// [L*V, H] in merged-target layout, whose row space IS the forward plan's
// output row space. They compute the plan-slot semantics of the JAX
// package's jnp twins (tf2_gnn_tpu/ops/pair_edge_mlp.py::_relu_pair_*_jnp),
// in f32 from stream-dtype (f32 or bf16) tables into f32 outputs, each sum
// term in the twins' order, z = A[src] + B[tgt]:
//
//   relu_pair_fwd   <- tf2_gnn_tpu/ops/pair_edge_mlp.py:84
//                      (_relu_pair_fwd_device, pallas_call :171), B6, forward
//                      plan: R[tgt] += max(z, 0) * s. The eval forward.
//   relu_pair_fwd_m <- pair_edge_mlp.py:188 (_relu_pair_fwd_m_device,
//                      pallas_call :289), B4, forward plan: R as above and
//                      M[tgt] += (z > 0 ? s : 0) in the same sweep. The
//                      training forward (the backward's dB is M * g).
//   relu_pair_da    <- pair_edge_mlp.py:420 (_relu_pair_da_device,
//                      pallas_call :523), B5, BACKWARD plan, whose "source"
//                      is the original target t (rows of B and of the f32
//                      cotangent g) and whose output rows are A's rows u:
//                      dA[u] += (A[u] + B[t] > 0 ? g[t] : 0) * s.
//   relu_pair_db    <- pair_edge_mlp.py:308 (_relu_pair_db_device,
//                      pallas_call :402), B7, forward plan:
//                      dB[tgt] = g[tgt] * sum of (z > 0 ? s : 0), the sum
//                      first and g's product once, as the jnp twin. No call
//                      path runs it, in the JAX package either.
//
// Unlike the TPU kernels, which round the cotangent g to the stream dtype
// (pair_edge_mlp.py:416, 537), g stays f32 here, as in the jnp twins.
//
// The TPU kernels build one-hot factors and run three or four MXU matmuls
// per chunk, because Mosaic cannot gather rows: the source half stays
// resident in VMEM and the target half streams through the output block
// index. Hopper gathers rows natively.
//
// B4, B6 and B7, one row owner (relu_pair_rows_kernel, in one of three
// modes: R for B6, R and M for B4, M times g for B7, which computes no R
// and multiplies its M by g[t]'s units of the same columns, read as B5
// reads g, once at the store). The forward plan's output row t is also B's
// row t, so one warp
// owns an output row: it reads the row's entries from the plan's compact
// form (ops/pair_spmm.py::slot_rows, the valid slots as a CSR by output
// row, each with its clipped source row and its plan slot, built once per
// batch and kept on the plan as MergedPlan.fwd_rows, which both read),
// holds B[clip(t)] in registers, gathers the entries' rows of A one at a
// time and keeps R and M as f32 register sums in the row's slot order,
// each element stored once.
//
// B5, a row owner by A's row (relu_pair_da_rows_kernel). The backward
// plan's output row u is A's row u: one warp holds A[u] in registers and
// walks u's entries from the backward plan's compact form
// (MergedPlan.bwd_rows: u's valid slots in slot order, u past A's rows
// dropped, each with its target t clipped into B's rows and its slot); for
// each it gathers B[t] and the f32 g[t] over the same columns and adds
// (z > 0 ? g : 0) * s into f32 registers, stored once.
//
// In all four no padded slot is walked, nothing is staged in shared
// memory, there are no atomics and two launches give the same bits. A lane
// unit is 8 bytes of the stream dtype (4 bf16 or 2 f32 columns; bf16
// H = 320 is 80 units, 3 a lane; B5 and B7 read g's matching 16 or 8
// bytes) where the row and its tables' alignment allow them, else one
// element (10 a lane at H = 320); wider rows take more column tiles
// (gridDim.y), each walking the row's entries again. The first port's B7
// (a block a plan group and 64-column tile, B's output block staged in
// 48.5-64.5 KB of shared memory, every slot walked, shared and global
// atomics into a zero-filled output, its sums in a run-dependent order) is
// retired.
//
// Bound. Memory: each input read once (the distinct gathered rows, the
// output-indexed table's rows, for dA and dB the f32 cotangent rows), the
// compact form (8 B an entry and 4 B an output row) and the f32 outputs
// written once. The arithmetic (3 to 7 f32 operations a
// valid slot and column) is far below the card's f32 rate. The row owners
// wait on L2 latency: a warp's gathers are dependent rounds of short row
// segments, and more of them in flight cost registers, which cost resident
// warps (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "lane_units.cuh"

namespace {

// dtype codes shared with the Python wrapper.
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

template <int V>
using Int = std::integral_constant<int, V>;

// ---------------------------------------------------------------------------
// B4, B6 and B7: the row owner over the forward plan's compact form.

// What it computes: R (B6), R and M (B4), or M times g (B7).
enum class Mode { kR, kRM, kMG };

struct RowsArgs {
  const void* a;            // [a_rows, h], rows contiguous
  const void* b;            // [b_rows, h]
  int64_t b_rows;
  const float* g;           // [out_rows, h] f32 cotangent, B7 only
  int h;
  const float* scale;       // [slots]
  const int32_t* row_ptr;   // [out_rows + 1]
  const int32_t* src_row;   // [n] rows of A, clipped
  const int32_t* slot;      // [n] plan slots (the scale's index)
  int64_t out_rows;
  float* out;               // [out_rows, h]: R (B4, B6) or dB (B7)
  float* m;                 // [out_rows, h], B4 only
};

// One warp owns output row t; W units of UB bytes a lane in this column
// tile (blockIdx.y); kMode picks the sums (R, M or both) and the store
// (B7 multiplies M by g's units G of the same E columns). IN_FLIGHT
// entries' rows of A are gathered before their adds (a lane's W units of
// one row are always in flight together). The kernel waits on L2 latency,
// and on an H100 at H = 320 (PERF.md, tools/relu_pair_variants.py) more
// resident warps hid it better than more rows in flight: one row takes B6
// from 57 to 48 registers (5 blocks an SM against 4) and 7-12% less time,
// and with element units halves B4's and B6's time; B4 in 8-byte units
// (64 registers either way) ran as fast with one as with two. At H = 64
// the choice made no difference.
template <typename T, int UB, int W, Mode kMode>
__global__ void __launch_bounds__(ROW_THREADS)
    relu_pair_rows_kernel(RowsArgs a) {
  using U = Unit<T, UB>;
  constexpr int E = U::kElems;
  using G = Unit<float, 4 * E>;
  constexpr bool kR = kMode != Mode::kMG;
  constexpr bool kM = kMode != Mode::kR;
  constexpr int IN_FLIGHT = 1;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * ROW_WARPS + (threadIdx.x >> 5);
  if (row >= a.out_rows) return;  // warp-uniform
  const int units = a.h / E;      // per table row
  const int unit0 = blockIdx.y * 32 * W + lane;
  const int64_t b_row = row < a.b_rows ? row : a.b_rows - 1;

  float bv[W][E], r[W][E], m[W][E];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int unit = unit0 + 32 * k;
    U::unpack(unit < units ? U::load(a.b, b_row * units + unit) : U::zero(),
              bv[k]);
#pragma unroll
    for (int e = 0; e < E; ++e) r[k][e] = m[k][e] = 0.0f;
  }

  const int begin = __ldg(a.row_ptr + row);
  const int end = __ldg(a.row_ptr + row + 1);
  for (int base = begin; base < end; base += 32) {
    const int count = min(32, end - base);  // warp-uniform
    // Entry j of the round sits in lane j.
    int src = 0;
    float sc = 0.0f;
    if (lane < count) {
      src = __ldg(a.src_row + base + lane);
      sc = __ldg(a.scale + __ldg(a.slot + base + lane));
    }
    for (int j0 = 0; j0 < count; j0 += IN_FLIGHT) {
      typename U::Raw val[IN_FLIGHT][W];
      float c[IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int j = (j0 + u) & 31;
        const int64_t s = __shfl_sync(FULL, src, j);
        c[u] = __shfl_sync(FULL, sc, j);
        const bool ok = j0 + u < count;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int unit = unit0 + 32 * k;
          val[u][k] = (ok && unit < units) ? U::load(a.a, s * units + unit)
                                           : U::zero();
        }
      }
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        if (j0 + u >= count) break;  // warp-uniform
#pragma unroll
        for (int k = 0; k < W; ++k) {
          float x[E];
          U::unpack(val[u][k], x);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            // The twins add the source half first: z = A[src] + B[tgt].
            const float z = x[e] + bv[k][e];
            if constexpr (kR) r[k][e] += fmaxf(z, 0.0f) * c[u];
            if constexpr (kM) m[k][e] += z > 0.0f ? c[u] : 0.0f;
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int unit = unit0 + 32 * k;
    if (unit >= units) continue;
    const int64_t o = row * a.h + static_cast<int64_t>(unit) * E;
    if constexpr (kMode == Mode::kMG) {
      float y[E];
      G::unpack(G::load(a.g, row * units + unit), y);
#pragma unroll
      for (int e = 0; e < E; ++e) m[k][e] *= y[e];
      store_f32<E>(a.out + o, m[k]);
    } else {
      store_f32<E>(a.out + o, r[k]);
      if constexpr (kM) store_f32<E>(a.m + o, m[k]);
    }
  }
}

// ---------------------------------------------------------------------------
// B5: the row owner by A's row over the backward plan's compact form.

struct DaRowsArgs {
  const void* a;            // [out_rows, h] or more rows: row u is owned
  const void* b;            // [b_rows, h]
  const float* g;           // [b_rows, h] f32 cotangent, rows contiguous
  int h;
  const float* scale;       // [slots] the backward plan's
  const int32_t* row_ptr;   // [out_rows + 1]: entries by A's row u
  const int32_t* t_row;     // [n] the target t, clipped into B's rows
  const int32_t* slot;      // [n] plan slots (the scale's index)
  int64_t out_rows;
  float* da;                // [out_rows, h]
};

// One warp owns A's row u; W units of UB bytes of the stream dtype a lane
// in this column tile (blockIdx.y), and g's units G of the same E columns
// (16 bytes beside 8-byte bf16 units, 8 beside f32 ones, one f32 beside an
// element). IN_FLIGHT entries' rows of B and g are gathered before their
// adds: on an H100 at H = 320 (PERF.md, tools/relu_pair_variants.py) two
// took 80 registers against one's 64 (3 blocks an SM against 4) and ran
// slower, by a third in element units.
template <typename T, int UB, int W>
__global__ void __launch_bounds__(ROW_THREADS)
    relu_pair_da_rows_kernel(DaRowsArgs a) {
  using U = Unit<T, UB>;
  constexpr int E = U::kElems;
  using G = Unit<float, 4 * E>;
  constexpr int IN_FLIGHT = 1;
  const int lane = threadIdx.x & 31;
  const int64_t u =
      static_cast<int64_t>(blockIdx.x) * ROW_WARPS + (threadIdx.x >> 5);
  if (u >= a.out_rows) return;  // warp-uniform
  const int units = a.h / E;    // per table row, in B and in g
  const int unit0 = blockIdx.y * 32 * W + lane;

  float av[W][E], acc[W][E];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int unit = unit0 + 32 * k;
    U::unpack(unit < units ? U::load(a.a, u * units + unit) : U::zero(),
              av[k]);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[k][e] = 0.0f;
  }

  const int begin = __ldg(a.row_ptr + u);
  const int end = __ldg(a.row_ptr + u + 1);
  for (int base = begin; base < end; base += 32) {
    const int count = min(32, end - base);  // warp-uniform
    // Entry j of the round sits in lane j.
    int t = 0;
    float sc = 0.0f;
    if (lane < count) {
      t = __ldg(a.t_row + base + lane);
      sc = __ldg(a.scale + __ldg(a.slot + base + lane));
    }
    for (int j0 = 0; j0 < count; j0 += IN_FLIGHT) {
      typename U::Raw bv[IN_FLIGHT][W];
      typename G::Raw gv[IN_FLIGHT][W];
      float c[IN_FLIGHT];
#pragma unroll
      for (int q = 0; q < IN_FLIGHT; ++q) {
        const int j = (j0 + q) & 31;
        const int64_t tq = __shfl_sync(FULL, t, j);
        c[q] = __shfl_sync(FULL, sc, j);
        const bool ok = j0 + q < count;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int unit = unit0 + 32 * k;
          const bool in = ok && unit < units;
          bv[q][k] = in ? U::load(a.b, tq * units + unit) : U::zero();
          gv[q][k] = in ? G::load(a.g, tq * units + unit) : G::zero();
        }
      }
#pragma unroll
      for (int q = 0; q < IN_FLIGHT; ++q) {
        if (j0 + q >= count) break;  // warp-uniform
#pragma unroll
        for (int k = 0; k < W; ++k) {
          float x[E], y[E];
          U::unpack(bv[q][k], x);
          G::unpack(gv[q][k], y);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            // The twins' order: z = A[u] + B[t].
            const float z = av[k][e] + x[e];
            acc[k][e] += (z > 0.0f ? y[e] : 0.0f) * c[q];
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int unit = unit0 + 32 * k;
    if (unit < units) {
      store_f32<E>(a.da + u * a.h + static_cast<int64_t>(unit) * E, acc[k]);
    }
  }
}

// ---------------------------------------------------------------------------
// The row owners' launch: lane unit, units a lane, grid.

// Units a lane, instantiated: 8-byte units 1, 3 or 5 (bf16 H up to 128,
// 384, 640 in one tile; f32 half that), element units 1, 2, 4 or 10 (H up
// to 32, 64, 128, 320); the smallest that holds the row, else the largest
// and more column tiles.
int rows_w(bool eight, int units) {
  const int need = (units + 31) / 32;
  if (eight) return need <= 1 ? 1 : (need <= 3 ? 3 : 5);
  return need <= 1 ? 1 : (need <= 2 ? 2 : (need <= 4 ? 4 : 10));
}

// Calls kernel(Int<UB>, Int<W>, grid) for a row of h elements of T over
// `rows` warps: 8-byte units where `eight` (the caller checked the row and
// the pointers), else one element a lane.
template <typename T, typename F>
int launch_rows(bool eight, int h, int64_t rows, F&& kernel) {
  constexpr int kItem = static_cast<int>(sizeof(T));
  const int units = eight ? h * kItem / 8 : h;
  const int w = rows_w(eight, units);
  const dim3 grid(static_cast<unsigned>((rows + ROW_WARPS - 1) / ROW_WARPS),
                  static_cast<unsigned>((units + 32 * w - 1) / (32 * w)));
  auto by_w = [&](auto ub) {
    if constexpr (decltype(ub)::value == 8) {
      if (w == 1) kernel(ub, Int<1>{}, grid);
      else if (w == 3) kernel(ub, Int<3>{}, grid);
      else kernel(ub, Int<5>{}, grid);
    } else {
      if (w == 1) kernel(ub, Int<1>{}, grid);
      else if (w == 2) kernel(ub, Int<2>{}, grid);
      else if (w == 4) kernel(ub, Int<4>{}, grid);
      else kernel(ub, Int<10>{}, grid);
    }
  };
  if (eight) {
    by_w(Int<8>{});
  } else {
    by_w(Int<kItem>{});
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const RowsArgs& a, Mode mode, cudaStream_t s) {
  // 8-byte units where the row, both tables and the outputs allow them (on
  // an H100 2.5 times faster at bf16 H = 320 than one element a lane,
  // PERF.md), with B7's g the same columns' 16 (bf16) or 8 (f32) bytes;
  // else one element a lane.
  const bool eight = static_cast<int64_t>(a.h) * sizeof(T) % 8 == 0
                     && aligned(a.a, 8) && aligned(a.b, 8)
                     && aligned(a.out, 16)
                     && (mode != Mode::kRM || aligned(a.m, 16))
                     && (mode != Mode::kMG
                         || aligned(a.g, static_cast<int>(32 / sizeof(T))));
  return launch_rows<T>(eight, a.h, a.out_rows,
                        [&](auto ub, auto w, dim3 grid) {
    constexpr int UB = decltype(ub)::value, W = decltype(w)::value;
    if (mode == Mode::kR) {
      relu_pair_rows_kernel<T, UB, W, Mode::kR>
          <<<grid, ROW_THREADS, 0, s>>>(a);
    } else if (mode == Mode::kRM) {
      relu_pair_rows_kernel<T, UB, W, Mode::kRM>
          <<<grid, ROW_THREADS, 0, s>>>(a);
    } else {
      relu_pair_rows_kernel<T, UB, W, Mode::kMG>
          <<<grid, ROW_THREADS, 0, s>>>(a);
    }
  });
}

int rows_launch(int device, int dtype, Mode mode, const RowsArgs& a,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.h <= 0 || a.b_rows <= 0 || a.out_rows <= 0
      || (mode == Mode::kMG && !a.g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return launch_fwd<float>(a, mode, s);
  if (dtype == DTYPE_BF16) return launch_fwd<__nv_bfloat16>(a, mode, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_da(const DaRowsArgs& a, cudaStream_t s) {
  // 8-byte units of B and A where the row and the tables allow them, with
  // g's 16 (bf16) or 8 (f32) bytes of the same columns.
  const bool eight = static_cast<int64_t>(a.h) * sizeof(T) % 8 == 0
                     && aligned(a.a, 8) && aligned(a.b, 8)
                     && aligned(a.g, static_cast<int>(32 / sizeof(T)))
                     && aligned(a.da, 16);
  return launch_rows<T>(eight, a.h, a.out_rows,
                        [&](auto ub, auto w, dim3 grid) {
    relu_pair_da_rows_kernel<T, decltype(ub)::value, decltype(w)::value>
        <<<grid, ROW_THREADS, 0, s>>>(a);
  });
}

}  // namespace

// C entry points. Each returns the cudaError_t of its launch
// (cudaGetLastError right after it); 0 is success.

// B4 (m given) and B6 (m null): R (and M), f32 [out_rows, h], every element
// stored once.
extern "C" int relu_pair_rows_launch(
    int device, int dtype, const void* a_tab, const void* b_tab,
    int64_t b_rows, int h, const float* scale, const int32_t* row_ptr,
    const int32_t* src_row, const int32_t* slot, int64_t out_rows, float* r,
    float* m, void* stream) {
  const RowsArgs a{a_tab, b_tab, b_rows, nullptr, h, scale, row_ptr,
                   src_row, slot, out_rows, r, m};
  return rows_launch(device, dtype, m ? Mode::kRM : Mode::kR, a, stream);
}

// B7: dB = M * g, f32 [out_rows, h], every element stored once.
extern "C" int relu_pair_db_rows_launch(
    int device, int dtype, const void* a_tab, const void* b_tab,
    int64_t b_rows, const float* g, int h, const float* scale,
    const int32_t* row_ptr, const int32_t* src_row, const int32_t* slot,
    int64_t out_rows, float* db, void* stream) {
  const RowsArgs a{a_tab, b_tab, b_rows, g, h, scale, row_ptr, src_row, slot,
                   out_rows, db, nullptr};
  return rows_launch(device, dtype, Mode::kMG, a, stream);
}

// B5: dA, f32 [out_rows, h] (A's first out_rows rows), every element
// stored once.
extern "C" int relu_pair_da_rows_launch(
    int device, int dtype, const void* a_tab, const void* b_tab,
    const float* g, int h, const float* scale, const int32_t* row_ptr,
    const int32_t* t_row, const int32_t* slot, int64_t out_rows, float* da,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h <= 0 || out_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DaRowsArgs a{a_tab, b_tab, g, h, scale, row_ptr, t_row, slot,
                     out_rows, da};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return launch_da<float>(a, s);
  if (dtype == DTYPE_BF16) return launch_da<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* relu_pair_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
