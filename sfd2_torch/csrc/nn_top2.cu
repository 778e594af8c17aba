// K6 — bidirectional top-2 nearest neighbours for Hopper (sm_90a), plain C
// interface.
//
// Replaces: sfd2_tpu/ops/pallas_match.py::nn_top2_pallas (_kernel_top2), the
// tiled kernel that the JAX package's NNR matcher takes for banks too large
// for its full-width kernel (mutual_nn_ratio_match_pallas, :672-692).
// Contract: sfd2_torch/ops/matching.py::nn_top2 —
//   s[b,i,j] = d0[b,i]·d1[b,j]; per row i the max, its argmax and the second
//   value of s + bias1[b,j] over j; per column j the same of s + bias0[b,i]
//   over i; bias = −1e9 on invalid rows/columns; the argmax is the lowest
//   index on an exact tie; the second value is the multiset second (only the
//   argmax entry is masked, so a max reached twice gives second == max), and
//   −2e9 where the reduced axis has one entry.
//
// What bounds it on this card: operations. This design computes the
// similarity twice, so one pair at the large-bank threshold (N1 = N2 =
// 68,992, C = 128) costs 2 × 1.22 TFLOP of f32 FMA work; the function itself
// needs 1.22 TFLOP against 71 MB of descriptors.
//
// Design: a column top-2 with its argmax cannot ride one atomic (K5 packs
// value and row into 64 bits; a second value does not fit), and K4's
// per-row-block column scratch, B·⌈N1/128⌉·N2·8 bytes, is what this route
// exists to avoid at large N1·N2. So one row-stripe kernel (K2's tiling,
// csrc/match_common.cuh) reduces rows only, and is launched twice: on
// (d0, d1, valid1) for the rows and on (d1, d0, valid0) for the columns. Both
// launches accumulate each product over C in the same ascending order, and
// fmaf(a, b, s) == fmaf(b, a, s), so the two see bit-identical similarities
// and agree exactly on ties and on the back-pointer check. No scratch. Per
// row a running (max, first argmax, second) over ascending columns; the 16
// column lanes merge with the multiset rule max(min(a1, b1), max(a2, b2)) and
// ties to the lower index. C is staged in chunks of KC_MAX columns. Ragged
// sizes are masked in-kernel; bf16 is widened to f32 when staged. No tensor
// cores, TMA or double buffering yet.
#include <math.h>
#include <stdint.h>

#include "match_common.cuh"

namespace {

constexpr float NEG2 = -2e9f;  // the reference's masked / initial value

// Rows of `a` [NA, C] against the columns `bank` [NB, C] with the bias of
// the bank's validity: out1/outi/out2 [B, NA] = (max, first argmax, second).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
top2_rows_kernel(const T* __restrict__ a, const T* __restrict__ bank,
                 const uint8_t* __restrict__ vb, long long sa, long long sb, long long svb,
                 int NA, int NB, int C, int KC, float* __restrict__ out1,
                 int* __restrict__ outi, float* __restrict__ out2) {
  extern __shared__ float smem[];
  float* q_s = smem;           // [KC][BM]
  float* d_s = q_s + KC * BM;  // [KC][BN]

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const T* q = a + b * sa;
  const T* db = bank + b * sb;
  const uint8_t* dv = vb + b * svb;

  if (KC == C) stage(q_s, q, row0, BM, NA, C);

  float best[8], second[8];
  int besti[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    best[r] = -INFINITY;
    second[r] = NEG2;
    besti[r] = 0;
  }

  for (int j0 = 0; j0 < NB; j0 += BN) {
    float acc[8][4];
    sim_tile(acc, q_s, d_s, q, db, row0, NA, j0, NB, C, KC, ty, tx);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx * 4 + c;
      if (j >= NB) continue;
      const float cbias = dv[j] ? 0.f : NEG;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float s = acc[r][c] + cbias;
        if (s > best[r]) {  // ascending j: strict > keeps the first
          second[r] = fmaxf(second[r], best[r]);
          best[r] = s;
          besti[r] = j;
        } else {
          second[r] = fmaxf(second[r], s);
        }
      }
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
    if (tx == 0 && i < NA) {
      out1[(size_t)b * NA + i] = v;
      outi[(size_t)b * NA + i] = vi;
      out2[(size_t)b * NA + i] = v2;
    }
  }
}

template <typename T>
int launch(const T* d0, const T* d1, const uint8_t* v0, const uint8_t* v1, long long sd0,
           long long sd1, long long sv0, long long sv1, int B, int N1, int N2, int C,
           float* rmax, int* ridx, float* rmax2, float* cmax, int* cidx, float* cmax2,
           cudaStream_t stream) {
  const int KC = C < KC_MAX ? C : KC_MAX;
  const size_t smem = sizeof(float) * (size_t)KC * (BM + BN);
  cudaError_t err = cudaFuncSetAttribute(
      top2_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  top2_rows_kernel<T><<<dim3((N1 + BM - 1) / BM, B), THREADS, smem, stream>>>(
      d0, d1, v1, sd0, sd1, sv1, N1, N2, C, KC, rmax, ridx, rmax2);
  top2_rows_kernel<T><<<dim3((N2 + BM - 1) / BM, B), THREADS, smem, stream>>>(
      d1, d0, v0, sd1, sd0, sv0, N2, N1, C, KC, cmax, cidx, cmax2);
  return (int)cudaGetLastError();
}

}  // namespace

// Batch strides (sd*, sv*) are in elements; 0 broadcasts one query to every
// batch entry. C % 4 == 0.
extern "C" int sfd2_nn_top2(const void* d0, const void* d1, const uint8_t* v0,
                            const uint8_t* v1, long long sd0, long long sd1, long long sv0,
                            long long sv1, int B, int N1, int N2, int C, int bf16, float* rmax,
                            int* ridx, float* rmax2, float* cmax, int* cidx, float* cmax2,
                            void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16)
    return launch(reinterpret_cast<const __nv_bfloat16*>(d0),
                  reinterpret_cast<const __nv_bfloat16*>(d1), v0, v1, sd0, sd1, sv0, sv1, B,
                  N1, N2, C, rmax, ridx, rmax2, cmax, cidx, cmax2, s);
  return launch(reinterpret_cast<const float*>(d0), reinterpret_cast<const float*>(d1), v0, v1,
                sd0, sd1, sv0, sv1, B, N1, N2, C, rmax, ridx, rmax2, cmax, cidx, cmax2, s);
}

extern "C" const char* sfd2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
