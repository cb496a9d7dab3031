// Float atomics shared by the kernels of csrc/*.cu (included, not built on
// its own; ops/cuda_build.py hashes it into every library's name).
#pragma once

#include <cuda_runtime.h>

// Float max as an integer atomic, on global or shared memory: values with the
// sign bit clear order like their int bits, values with it set order
// inversely to their unsigned bits; a -inf or NEG fill is below every larger
// value both ways, and +0.0 ranks above -0.0. The result does not depend on
// the order of the calls, so a max reduced with it is exact.
__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}
