// The value encoding and launch helpers of the matcher kernels (K2, K4, K5,
// K6 on csrc/nn_tc.cuh): the bias of an invalid row or column, the
// order-preserving int encoding of a float for atomicMax, and the grid of a
// grid-stride pass.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

namespace {

constexpr float NEG = -1e9f;  // bias of an invalid row or column

// Order-preserving int encoding of a float (for atomicMax): a < b as floats
// iff enc(a) < enc(b) as ints (no NaN; −0 sorts below +0, so the kernels
// add a +0 bias before they encode).
__device__ __forceinline__ int enc(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float dec(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// Blocks of 256 threads for a grid-stride loop over n elements.
inline unsigned grid_for(size_t n) {
  const size_t blocks = (n + 255) / 256;
  return (unsigned)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

}  // namespace
