// Shared pieces of the CUDA-core matcher kernels, K2 (match.cu) and K4
// (match_ratio.cu), and the value encoding of K5 and K6 (nn_tc.cuh): the
// block tiling, the descriptor
// loads, the k-major shared-memory staging, the 8×4 f32 FMA tile that
// computes each similarity once, in registers, for both reductions, and the
// order-preserving int encoding of a float for atomicMax.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

namespace {

constexpr int BM = 128;       // query rows per block
constexpr int BN = 64;        // bank columns per tile
constexpr int THREADS = 256;  // 16 × 16; thread tile 8 rows × 4 columns
constexpr float NEG = -1e9f;  // bias of an invalid row or column
constexpr int KC_MAX = 128;   // descriptor columns staged at once past C = 256

// Order-preserving int encoding of a float (for atomicMax): a < b as floats
// iff enc(a) < enc(b) as ints (no NaN; −0 sorts below +0, and an f32 FMA
// chain that starts at +0 never yields −0).
__device__ __forceinline__ int enc(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float dec(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Stage rows [row0, row0+rows), columns [k0, k0+kc) of a [n, C] matrix into
// smem k-major: dst[(k - k0) * rows + r]; rows past n are zero.
template <typename T>
__device__ __forceinline__ void stage_cols(float* dst, const T* src, int row0, int rows,
                                           int n, int C, int k0, int kc) {
  const int c4 = kc / 4;
  for (int idx = threadIdx.x; idx < rows * c4; idx += THREADS) {
    const int r = idx % rows, k = (idx / rows) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) v = load4(src + (size_t)(row0 + r) * C + k0 + k);
    dst[(k + 0) * rows + r] = v.x;
    dst[(k + 1) * rows + r] = v.y;
    dst[(k + 2) * rows + r] = v.z;
    dst[(k + 3) * rows + r] = v.w;
  }
}

// Stage rows [row0, row0+rows) of a [n, C] matrix, all columns.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0, int rows, int n,
                                      int C) {
  stage_cols(dst, src, row0, rows, n, C, 0, C);
}

// acc[r][c] += q_s rows ty*8+r · d_s columns tx*4+c, an f32 FMA chain over
// k = 0..kc-1 (q_s is [kc][BM], d_s is [kc][BN], both k-major).
__device__ __forceinline__ void dot_tile_acc(float (&acc)[8][4], const float* q_s,
                                             const float* d_s, int ty, int tx, int kc) {
  for (int k = 0; k < kc; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(q_s + k * BM + ty * 8);
    const float4 a1 = *reinterpret_cast<const float4*>(q_s + k * BM + ty * 8 + 4);
    const float4 w = *reinterpret_cast<const float4*>(d_s + k * BN + tx * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      acc[r][0] = fmaf(a[r], w.x, acc[r][0]);
      acc[r][1] = fmaf(a[r], w.y, acc[r][1]);
      acc[r][2] = fmaf(a[r], w.z, acc[r][2]);
      acc[r][3] = fmaf(a[r], w.w, acc[r][3]);
    }
  }
}

// The similarity tile of every matcher kernel: acc[r][c] = q row
// (row0 + ty*8 + r) · bank row (j0 + tx*4 + c), one f32 FMA chain over
// k = 0..C-1 in ascending order, staged KC columns at a time (q_s [KC][BM],
// d_s [KC][BN]). With KC == C (C <= 256) the caller stages the q stripe
// once, before its first tile.
// Starts and ends with every thread past a __syncthreads() of its own loop,
// so the caller's shared reductions of the previous tile are complete.
// Because fmaf(a, b, s) == fmaf(b, a, s), swapping q and the bank gives
// bit-identical products.
template <typename T>
__device__ __forceinline__ void sim_tile(float (&acc)[8][4], float* q_s, float* d_s,
                                         const T* q, const T* db, int row0, int N1, int j0,
                                         int N2, int C, int KC, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < C; k0 += KC) {
    const int kc = min(KC, C - k0);
    __syncthreads();  // the previous chunk's and tile's shared reads are done
    if (KC != C) stage_cols(q_s, q, row0, BM, N1, C, k0, kc);
    stage_cols(d_s, db, j0, BN, N2, C, k0, kc);
    __syncthreads();
    dot_tile_acc(acc, q_s, d_s, ty, tx, kc);
  }
}

// Blocks of 256 threads for a grid-stride loop over n elements.
inline unsigned grid_for(size_t n) {
  const size_t blocks = (n + 255) / 256;
  return (unsigned)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

}  // namespace
