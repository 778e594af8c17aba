// K5 — bidirectional nearest neighbour (max and argmax both ways) for Hopper
// (sm_90a), plain C interface.
//
// Replaces: sfd2_tpu/ops/pallas_match.py::nn_argmax_pallas (_kernel), the
// tiled kernel that the JAX package's NNM matcher takes for banks too large
// for its full-width kernel (mutual_nn_match_pallas, :385-396).
// Contract: sfd2_torch/ops/matching.py::nn_argmax —
//   s[b,i,j] = d0[b,i]·d1[b,j]; per row i the max and argmax of
//   s + bias1[b,j] over j, per column j the max and argmax of s + bias0[b,i]
//   over i, bias = −1e9 on invalid rows/columns; on an exact tie the lowest
//   index wins, both ways.
//
// What bounds it on this card: operations. At the large-bank threshold
// (N1 = N2 = 68,992, C = 128) one pair is 2·68,992²·128 ≈ 1.22 TFLOP of f32
// FMA work against 71 MB of descriptors (~17,000 FLOP/byte).
//
// Design: K2's row stripe (csrc/match_common.cuh). A block owns BM=128 rows
// of one batch entry and walks all of N2 in BN=64-wide tiles; every s[i,j]
// is computed once in registers (8×4 per thread) and read by both
// reductions. Rows keep a running max and first argmax (columns arrive in
// ascending order, strictly-greater update; the 16 column lanes merge with
// ties to the lower index). Columns: the TPU carried (max, argmax) across a
// sequential grid in VMEM; here blocks run in parallel and unordered, so a
// block reduces each column over its 128 rows (rows ascending, strictly
// greater) and does one 64-bit atomicMax per column on
// (order-preserving encoding of the value) << 32 | (0xFFFFFFFF − row):
// the largest value wins and, among equal values, the lowest row — exact
// and independent of block order, with O(N2) scratch. C is staged in
// chunks of KC_MAX columns, so any C % 4 == 0 fits shared memory (one
// stage of the query stripe when C <= KC_MAX). Ragged N1/N2 are masked
// in-kernel. bf16 descriptors are widened to f32 when staged. No tensor
// cores, TMA or double buffering yet.
#include <math.h>
#include <stdint.h>

#include "match_common.cuh"

namespace {

__device__ __forceinline__ unsigned long long pack(float v, int row) {
  const unsigned hi = static_cast<unsigned>(enc(v)) ^ 0x80000000u;
  return (static_cast<unsigned long long>(hi) << 32) | (0xFFFFFFFFu - static_cast<unsigned>(row));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
argmax_kernel(const T* __restrict__ d0, const T* __restrict__ d1,
              const uint8_t* __restrict__ v0, const uint8_t* __restrict__ v1,
              long long sd0, long long sd1, long long sv0, long long sv1, int N1, int N2,
              int C, int KC, float* __restrict__ rmax, int* __restrict__ ridx,
              unsigned long long* __restrict__ ckey) {
  extern __shared__ float smem[];
  float* q_s = smem;                                     // [KC][BM]
  float* d_s = q_s + KC * BM;                            // [KC][BN]
  float* redv = d_s + KC * BN;                           // [16][BN] column partial maxima
  int* redi = reinterpret_cast<int*>(redv + 16 * BN);    // [16][BN] their rows

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const T* q = d0 + b * sd0;
  const T* db = d1 + b * sd1;
  const uint8_t* qv = v0 + b * sv0;
  const uint8_t* dv = v1 + b * sv1;

  if (KC == C) stage(q_s, q, row0, BM, N1, C);

  float rbias[8], best[8];
  bool rin[8];
  int besti[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = row0 + ty * 8 + r;
    rin[r] = i < N1;
    rbias[r] = (rin[r] && qv[i]) ? 0.f : NEG;
    best[r] = -INFINITY;
    besti[r] = 0;
  }

  for (int j0 = 0; j0 < N2; j0 += BN) {
    float acc[8][4];
    sim_tile(acc, q_s, d_s, q, db, row0, N1, j0, N2, C, KC, ty, tx);

#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx * 4 + c;
      const bool cin = j < N2;
      const float cbias = (cin && dv[j]) ? 0.f : NEG;
      float cm = -INFINITY;
      int ci = row0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float s_row = acc[r][c] + cbias;
        if (cin && s_row > best[r]) {  // ascending j: strict > keeps the first
          best[r] = s_row;
          besti[r] = j;
        }
        const float s_col = acc[r][c] + rbias[r];
        if (rin[r] && s_col > cm) {  // ascending rows: strict > keeps the first
          cm = s_col;
          ci = row0 + ty * 8 + r;
        }
      }
      redv[ty * BN + tx * 4 + c] = cm;
      redi[ty * BN + tx * 4 + c] = ci;
    }
    __syncthreads();
    if (tid < BN && j0 + tid < N2) {
      float m = redv[tid];
      int mi = redi[tid];
#pragma unroll
      for (int t = 1; t < 16; ++t) {  // slices in ascending row order
        const float v = redv[t * BN + tid];
        if (v > m) {
          m = v;
          mi = redi[t * BN + tid];
        }
      }
      atomicMax(ckey + (size_t)b * N2 + j0 + tid, pack(m, mi));
    }
  }

  // Merge the 16 column-slices of each row (lanes tx of one half-warp).
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float v = best[r];
    int vi = besti[r];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, vi, off);
      if (ov > v || (ov == v && oi < vi)) {
        v = ov;
        vi = oi;
      }
    }
    const int i = row0 + ty * 8 + r;
    if (tx == 0 && i < N1) {
      rmax[(size_t)b * N1 + i] = v;
      ridx[(size_t)b * N1 + i] = vi;
    }
  }
}

__global__ void unpack_kernel(const unsigned long long* __restrict__ ckey, size_t n,
                              float* __restrict__ cmax, int* __restrict__ cidx) {
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    const unsigned long long k = ckey[t];
    cmax[t] = dec(static_cast<int>(static_cast<unsigned>(k >> 32) ^ 0x80000000u));
    cidx[t] = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(k & 0xFFFFFFFFu));
  }
}

template <typename T>
int launch(const T* d0, const T* d1, const uint8_t* v0, const uint8_t* v1, long long sd0,
           long long sd1, long long sv0, long long sv1, int B, int N1, int N2, int C,
           float* rmax, int* ridx, unsigned long long* ckey, float* cmax, int* cidx,
           cudaStream_t stream) {
  const int KC = C < KC_MAX ? C : KC_MAX;
  const size_t smem = sizeof(float) * ((size_t)KC * (BM + BN) + 32 * BN);
  cudaError_t err = cudaFuncSetAttribute(
      argmax_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t ncol = (size_t)B * N2;
  err = cudaMemsetAsync(ckey, 0, ncol * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N1 + BM - 1) / BM, B);
  argmax_kernel<T><<<grid, THREADS, smem, stream>>>(d0, d1, v0, v1, sd0, sd1, sv0, sv1, N1,
                                                    N2, C, KC, rmax, ridx, ckey);
  unpack_kernel<<<grid_for(ncol), 256, 0, stream>>>(ckey, ncol, cmax, cidx);
  return (int)cudaGetLastError();
}

}  // namespace

// Batch strides (sd*, sv*) are in elements; 0 broadcasts one query to every
// batch entry. C % 4 == 0. ckey is [B, N2] scratch.
extern "C" int sfd2_nn_argmax(const void* d0, const void* d1, const uint8_t* v0,
                              const uint8_t* v1, long long sd0, long long sd1, long long sv0,
                              long long sv1, int B, int N1, int N2, int C, int bf16,
                              float* rmax, int* ridx, void* ckey, float* cmax, int* cidx,
                              void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  unsigned long long* k = reinterpret_cast<unsigned long long*>(ckey);
  if (bf16)
    return launch(reinterpret_cast<const __nv_bfloat16*>(d0),
                  reinterpret_cast<const __nv_bfloat16*>(d1), v0, v1, sd0, sd1, sv0, sv1, B,
                  N1, N2, C, rmax, ridx, k, cmax, cidx, s);
  return launch(reinterpret_cast<const float*>(d0), reinterpret_cast<const float*>(d1), v0, v1,
                sd0, sd1, sv0, sv1, B, N1, N2, C, rmax, ridx, k, cmax, cidx, s);
}

extern "C" const char* sfd2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
