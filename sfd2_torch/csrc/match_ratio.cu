// K4 — fused mutual-nearest-neighbour + symmetric ratio matcher for Hopper
// (sm_90a), plain C interface.
//
// Replaces: sfd2_tpu/ops/pallas_match.py::mutual_nn_ratio_match_pallas
// (_kernel_top2_mutual + _make_epilogue_ratio/_gather_chunks).
// Contract: sfd2_torch/ops/matching.py::mutual_nn_ratio_match —
//   s[b,i,j] = (d0[b,i]·d1[b,j] + bias1[b,j]) + bias0[b,i], bias = −1e9 on
//   invalid rows/columns; per row the max, its first-occurrence argmax nn12
//   and the multiset second value (the max with the argmax entry set to
//   −2e9); per column the multiset top-2 (a column max reached by two rows
//   gives c2 == c1). Row i is matched to nn12[i] iff it is alive
//   (rmax > −5e8), valid, rmax == c1[nn12] (bit equality of one computed
//   value), dist(rmax)/(dist(rmax2) + 1e-8) <= ratio and
//   dist(c1)/(dist(c2) + 1e-8) <= ratio at nn12, with
//   dist(v) = sqrt(max(2 − 2v, 0)).
//
// What bounds it on this card: operations. DB-pair matching at the map
// building shape [16, 4096, 128] × [16, 4096, 128] is 2·16·4096²·128 ≈
// 69 GFLOP of f32 FMA work against ~67 MB of descriptors.
//
// Design: K2's (csrc/match.cu; the tiling, staging and FMA tile are shared
// in csrc/match_common.cuh). A block owns BM=128 rows of one batch entry,
// staged once in shared memory, and walks all of N2 in BN=64 tiles; every
// s[i,j] is computed once in registers (8×4 per thread) and read by both
// reductions (past C = 256, C is staged in KC_MAX-wide chunks, as in K2).
// Rows keep (max, first argmax, second) and merge across the 16
// column lanes with the multiset top-2 rule. Columns: K2's single
// order-preserving atomicMax cannot carry a second value, so each block
// writes its per-column (c1, c2) over its 128 rows to a scratch
// [B, ceil(N1/128), N2, 2], and a merge kernel folds the row blocks with the
// same rule — commutative, so the result does not depend on block order.
// The epilogue computes 2 − 2s, the square roots and the divisions with
// round-to-nearest intrinsics (no FMA contraction), as the plain version's
// separate elementwise ops round them, so no ratio decision at the
// threshold flips on contraction. Ragged N1/N2 are masked in-kernel. bf16
// descriptors are widened to f32 when staged. No tensor cores, TMA or
// double buffering yet.
#include <math.h>
#include <stdint.h>

#include "match_common.cuh"

namespace {

constexpr float NEG2 = -2e9f;  // the reference's masked / initial value

// Multiset top-2 of two (first, second) pairs.
__device__ __forceinline__ void merge_top2(float& a1, float& a2, float b1, float b2) {
  const float second = fmaxf(fminf(a1, b1), fmaxf(a2, b2));
  a1 = fmaxf(a1, b1);
  a2 = second;
}

__device__ __forceinline__ float dist(float v) {
  return __fsqrt_rn(fmaxf(__fsub_rn(2.f, __fmul_rn(2.f, v)), 0.f));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
top2_kernel(const T* __restrict__ d0, const T* __restrict__ d1, const uint8_t* __restrict__ v0,
            const uint8_t* __restrict__ v1, long long sd0, long long sd1, long long sv0,
            long long sv1, int N1, int N2, int C, int KC, float* __restrict__ rmax,
            int* __restrict__ ridx, float* __restrict__ rmax2, float2* __restrict__ part) {
  extern __shared__ float smem[];
  float* q_s = smem;            // [KC][BM]
  float* d_s = q_s + KC * BM;   // [KC][BN]
  float* red1 = d_s + KC * BN;  // [16][BN] column partial firsts
  float* red2 = red1 + 16 * BN;  // [16][BN] column partial seconds

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const T* q = d0 + b * sd0;
  const T* db = d1 + b * sd1;
  const uint8_t* qv = v0 + b * sv0;
  const uint8_t* dv = v1 + b * sv1;

  if (KC == C) stage(q_s, q, row0, BM, N1, C);

  float rbias[8];
  bool rin[8];
  float best[8], second[8];
  int besti[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = row0 + ty * 8 + r;
    rin[r] = i < N1;
    rbias[r] = (rin[r] && qv[i]) ? 0.f : NEG;
    best[r] = -INFINITY;
    second[r] = NEG2;
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
      float c1 = NEG2, c2 = NEG2;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float s = (acc[r][c] + cbias) + rbias[r];
        if (cin) {  // columns arrive in ascending j: strict > keeps the first
          if (s > best[r]) {
            second[r] = fmaxf(second[r], best[r]);
            best[r] = s;
            besti[r] = j;
          } else {
            second[r] = fmaxf(second[r], s);
          }
        }
        if (rin[r]) {
          if (s > c1) {
            c2 = c1;
            c1 = s;
          } else {
            c2 = fmaxf(c2, s);
          }
        }
      }
      red1[ty * BN + tx * 4 + c] = c1;
      red2[ty * BN + tx * 4 + c] = c2;
    }
    __syncthreads();
    if (tid < BN && j0 + tid < N2) {
      float m1 = red1[tid], m2 = red2[tid];
#pragma unroll
      for (int t = 1; t < 16; ++t) merge_top2(m1, m2, red1[t * BN + tid], red2[t * BN + tid]);
      part[((size_t)b * gridDim.x + blockIdx.x) * N2 + j0 + tid] = make_float2(m1, m2);
    }
  }

  // Merge the 16 column-slices of each row (lanes tx of one half-warp).
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float v = best[r], v2 = second[r];
    int vi = besti[r];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const float ov2 = __shfl_xor_sync(0xffffffffu, v2, off);
      const int oi = __shfl_xor_sync(0xffffffffu, vi, off);
      v2 = fmaxf(fminf(v, ov), fmaxf(v2, ov2));
      if (ov > v || (ov == v && oi < vi)) {
        v = ov;
        vi = oi;
      }
    }
    const int i = row0 + ty * 8 + r;
    if (tx == 0 && i < N1) {
      rmax[(size_t)b * N1 + i] = v;
      ridx[(size_t)b * N1 + i] = vi;
      rmax2[(size_t)b * N1 + i] = v2;
    }
  }
}

// Fold the row blocks' column partials: cm1/cm2 [B, N2].
__global__ void merge_kernel(const float2* __restrict__ part, int B, int n_rb, int N2,
                             float* __restrict__ cm1, float* __restrict__ cm2) {
  const size_t n = (size_t)B * N2;
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(t / N2), j = (int)(t % N2);
    float m1 = NEG2, m2 = NEG2;
    for (int rb = 0; rb < n_rb; ++rb) {
      const float2 p = part[((size_t)b * n_rb + rb) * N2 + j];
      merge_top2(m1, m2, p.x, p.y);
    }
    cm1[t] = m1;
    cm2[t] = m2;
  }
}

__global__ void epilogue_kernel(const float* __restrict__ rmax, const int* __restrict__ ridx,
                                const float* __restrict__ rmax2, const float* __restrict__ cm1,
                                const float* __restrict__ cm2, const uint8_t* __restrict__ v0,
                                long long sv0, int B, int N1, int N2, float ratio,
                                int* __restrict__ matches, float* __restrict__ scores) {
  const size_t n = (size_t)B * N1;
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(t / N1), i = (int)(t % N1);
    const float r1 = rmax[t];
    const int nn = ridx[t];
    const float c1 = cm1[(size_t)b * N2 + nn], c2 = cm2[(size_t)b * N2 + nn];
    const float ratio12 = __fdiv_rn(dist(r1), __fadd_rn(dist(rmax2[t]), 1e-8f));
    const float ratio21 = __fdiv_rn(dist(c1), __fadd_rn(dist(c2), 1e-8f));
    const bool alive = r1 > NEG / 2;
    const bool ok = alive && v0[b * sv0 + i] && r1 == c1 && ratio12 <= ratio && ratio21 <= ratio;
    matches[t] = ok ? nn : -1;
    scores[t] = alive ? r1 : 0.f;
  }
}

template <typename T>
int launch(const T* d0, const T* d1, const uint8_t* v0, const uint8_t* v1, long long sd0,
           long long sd1, long long sv0, long long sv1, int B, int N1, int N2, int C,
           float ratio, float* rmax, int* ridx, float* rmax2, float2* part, float* cm1,
           float* cm2, int* matches, float* scores, cudaStream_t stream) {
  const int KC = C <= 256 ? C : KC_MAX;
  const size_t smem = sizeof(float) * ((size_t)KC * (BM + BN) + 32 * BN);
  cudaError_t err = cudaFuncSetAttribute(
      top2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_rb = (N1 + BM - 1) / BM;
  top2_kernel<T><<<dim3(n_rb, B), THREADS, smem, stream>>>(
      d0, d1, v0, v1, sd0, sd1, sv0, sv1, N1, N2, C, KC, rmax, ridx, rmax2, part);
  merge_kernel<<<grid_for((size_t)B * N2), 256, 0, stream>>>(part, B, n_rb, N2, cm1, cm2);
  epilogue_kernel<<<grid_for((size_t)B * N1), 256, 0, stream>>>(
      rmax, ridx, rmax2, cm1, cm2, v0, sv0, B, N1, N2, ratio, matches, scores);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows per block: the scratch `part` is [B, ceil(N1 / rows), N2, 2] float32.
extern "C" int sfd2_match_ratio_rows_per_block() { return BM; }

// Batch strides (sd*, sv*) are in elements; 0 broadcasts one query to
// every batch entry. C % 4 == 0.
extern "C" int sfd2_mutual_nn_ratio_match(const void* d0, const void* d1, const uint8_t* v0,
                                          const uint8_t* v1, long long sd0, long long sd1,
                                          long long sv0, long long sv1, int B, int N1, int N2,
                                          int C, int bf16, float ratio, float* rmax,
                                          int* ridx, float* rmax2, float* part, float* cm1,
                                          float* cm2, int* matches, float* scores,
                                          void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float2* p = reinterpret_cast<float2*>(part);
  if (bf16)
    return launch(reinterpret_cast<const __nv_bfloat16*>(d0),
                  reinterpret_cast<const __nv_bfloat16*>(d1), v0, v1, sd0, sd1, sv0, sv1, B,
                  N1, N2, C, ratio, rmax, ridx, rmax2, p, cm1, cm2, matches, scores, s);
  return launch(reinterpret_cast<const float*>(d0), reinterpret_cast<const float*>(d1), v0, v1,
                sd0, sd1, sv0, sv1, B, N1, N2, C, ratio, rmax, ridx, rmax2, p, cm1, cm2,
                matches, scores, s);
}

extern "C" const char* sfd2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
