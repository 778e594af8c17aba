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
// What bounds it on this card: operations, on the tensor cores. DB-pair
// matching at the map building shape [16, 4096, 128] × [16, 4096, 128] is
// 2·16·4096²·128 ≈ 69 GFLOP: 0.42 ms as 3×TF32 for f32 descriptors (495
// TFLOP/s ÷ 3), 0.07 ms in bf16 (989 TFLOP/s), against ~67 MB of f32
// descriptors.
//
// Design: K6's tensor-core tiles (csrc/nn_tc.cuh with the second values),
// then one last pass. Each 128 × 128 tile of S is computed once on the
// tensor cores (3×TF32 for f32, within ~1e-6 of the plain f32 product;
// bf16 × bf16 for bf16; any C % 4 == 0) and reduced both ways from the same
// accumulator; the tiles merge by 64-bit atomicMax on (enc(v), 0xFFFFFFFF −
// index) keys, and the second values by the loser rule, exact and in any
// tile order, on O(B·(N1 + N2)) scratch. As in K2 (csrc/match.cu), both
// biases are +0 where the row is valid and its best column is valid, so
// the keys and seconds hold the contract's rmax, rmax2, c1 and c2 there,
// and ratio_epilogue needs only the row's own validity. It computes 2 − 2s,
// the square roots and the divisions with round-to-nearest intrinsics (no
// FMA contraction), as the plain version's separate elementwise ops round
// them, so no ratio decision at the threshold flips on contraction.
#include "nn_tc.cuh"

namespace {

__device__ __forceinline__ float dist(float v) {
  return __fsqrt_rn(fmaxf(__fsub_rn(2.f, __fmul_rn(2.f, v)), 0.f));
}

// One thread per (b, i): matches [B, N1] (−1: none) and scores [B, N1].
// rsec/csec hold the encoded second values.
__global__ void ratio_epilogue(const unsigned long long* __restrict__ rkey,
                               const int* __restrict__ rsec,
                               const unsigned long long* __restrict__ ckey,
                               const int* __restrict__ csec, const uint8_t* __restrict__ v0,
                               long long sv0, int B, int N1, int N2, float ratio,
                               int* __restrict__ matches, float* __restrict__ scores) {
  const size_t n = (size_t)B * N1;
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(t / N1), i = (int)(t % N1);
    const unsigned long long k = rkey[t];
    const float r1 = key_value(k);
    const int nn = key_index(k);
    const size_t c = (size_t)b * N2 + nn;
    const float c1 = key_value(ckey[c]), c2 = dec(csec[c]);
    const float ratio12 = __fdiv_rn(dist(r1), __fadd_rn(dist(dec(rsec[t])), 1e-8f));
    const float ratio21 = __fdiv_rn(dist(c1), __fadd_rn(dist(c2), 1e-8f));
    const bool alive = v0[b * sv0 + i] && r1 > NEG / 2;
    const bool ok = alive && r1 == c1 && ratio12 <= ratio && ratio21 <= ratio;
    matches[t] = ok ? nn : -1;
    scores[t] = alive ? r1 : 0.f;
  }
}

template <typename T>
int launch(const void* d0, const void* d1, const uint8_t* v0, const uint8_t* v1, long long sd0,
           long long sd1, long long sv0, long long sv1, int B, int N1, int N2, int C, float ratio,
           void* op0, void* op1, unsigned long long* rkey, unsigned long long* ckey, int* rsec,
           int* csec, int* matches, float* scores, cudaStream_t stream) {
  const int err = nn_tc_run<T, true>(static_cast<const T*>(d0), static_cast<const T*>(d1), v0,
                                     v1, sd0, sd1, sv0, sv1, B, N1, N2, C, op0, op1, rkey, ckey,
                                     rsec, csec, stream);
  if (err != 0) return err;
  ratio_epilogue<<<grid_for((size_t)B * N1), 256, 0, stream>>>(rkey, rsec, ckey, csec, v0, sv0, B,
                                                               N1, N2, ratio, matches, scores);
  return (int)cudaGetLastError();
}

}  // namespace

// Batch strides (sd*, sv*) are in elements; 0 broadcasts one query to
// every batch entry. C % 4 == 0. op0/op1, rkey, ckey: nn_tc's scratch, as
// for sfd2_nn_top2; rsec [B, N1] and csec [B, N2] int32, the encoded second
// values (ops/cuda_match.py::nn_tc_scratch with seconds).
extern "C" int sfd2_mutual_nn_ratio_match(const void* d0, const void* d1, const uint8_t* v0,
                                          const uint8_t* v1, long long sd0, long long sd1,
                                          long long sv0, long long sv1, int B, int N1, int N2,
                                          int C, int bf16, float ratio, void* op0, void* op1,
                                          void* rkey, void* ckey, int* rsec, int* csec,
                                          int* matches, float* scores, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto* rk = reinterpret_cast<unsigned long long*>(rkey);
  auto* ck = reinterpret_cast<unsigned long long*>(ckey);
  if (bf16)
    return launch<__nv_bfloat16>(d0, d1, v0, v1, sd0, sd1, sv0, sv1, B, N1, N2, C, ratio, op0,
                                 op1, rk, ck, rsec, csec, matches, scores, s);
  return launch<float>(d0, d1, v0, v1, sd0, sd1, sv0, sv1, B, N1, N2, C, ratio, op0, op1, rk, ck,
                       rsec, csec, matches, scores, s);
}

extern "C" const char* sfd2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
