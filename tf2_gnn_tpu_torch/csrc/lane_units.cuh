// Lane units of a table row and the other helpers of the row-owner kernels
// of csrc/pair_stream.cu, pair_edge_mlp.cu and pair_attention.cu (included,
// not built on its own; ops/cuda_build.py hashes it into every library's
// name).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

constexpr unsigned FULL = 0xffffffffu;
// A row-owner block: 8 warps, each owning one output row (or, in
// pair_stream.cu's sub-warp split, 32 / G rows).
constexpr int ROW_WARPS = 8;
constexpr int ROW_THREADS = 32 * ROW_WARPS;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Row indices clip into [0, n), as the twins' jnp.take(mode="clip").
__device__ __forceinline__ int64_t clip(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// A lane unit of UB bytes of a row of T (UB = 16 or 8, or sizeof(T) for
// one element) as 32-bit words: its load, its elements as f32 and its FMAs
// into kElems f32 sums, in column order. bf16 is the upper half of an f32,
// so its conversion is a shift (the low element of a word) or a mask (the
// high).
template <typename T, int UB>
struct Unit {
  static constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  static constexpr int kElems = UB / static_cast<int>(sizeof(T));
  static constexpr int kWords = UB >= 4 ? UB / 4 : 1;
  struct Raw {
    uint32_t w[kWords];
  };

  __device__ static __forceinline__ Raw zero() {
    Raw x;
#pragma unroll
    for (int i = 0; i < kWords; ++i) x.w[i] = 0u;
    return x;
  }

  __device__ static __forceinline__ Raw load(const void* p, int64_t i) {
    Raw x;
    if constexpr (UB == 16) {
      const uint4 v = __ldg(static_cast<const uint4*>(p) + i);
      x.w[0] = v.x; x.w[1] = v.y; x.w[2] = v.z; x.w[3] = v.w;
    } else if constexpr (UB == 8) {
      const uint2 v = __ldg(static_cast<const uint2*>(p) + i);
      x.w[0] = v.x; x.w[1] = v.y;
    } else if constexpr (UB == 4) {
      x.w[0] = __ldg(static_cast<const unsigned int*>(p) + i);
    } else {
      x.w[0] = __ldg(static_cast<const unsigned short*>(p) + i);
    }
    return x;
  }

  __device__ static __forceinline__ void unpack(const Raw& x, float* out) {
    if constexpr (!kBf16) {
#pragma unroll
      for (int i = 0; i < kWords; ++i) out[i] = __uint_as_float(x.w[i]);
    } else if constexpr (UB == 2) {
      out[0] = __uint_as_float(x.w[0] << 16);
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        out[2 * i] = __uint_as_float(x.w[i] << 16);
        out[2 * i + 1] = __uint_as_float(x.w[i] & 0xffff0000u);
      }
    }
  }

  __device__ static __forceinline__ void fma(float* acc, const Raw& x,
                                             float c) {
    if constexpr (!kBf16) {
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        acc[i] = fmaf(c, __uint_as_float(x.w[i]), acc[i]);
    } else if constexpr (UB == 2) {
      acc[0] = fmaf(c, __uint_as_float(x.w[0] << 16), acc[0]);
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        acc[2 * i] = fmaf(c, __uint_as_float(x.w[i] << 16), acc[2 * i]);
        acc[2 * i + 1] = fmaf(c, __uint_as_float(x.w[i] & 0xffff0000u),
                              acc[2 * i + 1]);
      }
    }
  }

  // As fma, with a scale per element (c[0:kElems]).
  __device__ static __forceinline__ void fma_each(float* acc, const Raw& x,
                                                  const float* c) {
    float v[kElems];
    unpack(x, v);
#pragma unroll
    for (int i = 0; i < kElems; ++i) acc[i] = fmaf(c[i], v[i], acc[i]);
  }
};

// kElems f32 values to out[0:kElems], as one vector store where kElems is
// 2 or a multiple of 4 (the caller keeps out aligned to it).
template <int kElems>
__device__ __forceinline__ void store_f32(float* out, const float* v) {
  if constexpr (kElems % 4 == 0) {
#pragma unroll
    for (int e = 0; e < kElems; e += 4) {
      reinterpret_cast<float4*>(out)[e / 4] =
          make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
    }
  } else if constexpr (kElems == 2) {
    *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
  } else {
    *out = v[0];
  }
}
