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
// What bounds it on this card: operations, on the tensor cores, as K5: one
// pair at the large-bank threshold (N1 = N2 = 68,992, C = 128) is 1.22
// TFLOP, 7.4 ms as 3×TF32 for f32 inputs (495 TFLOP/s ÷ 3), 1.23 ms for
// bf16 (989 TFLOP/s). Each similarity is computed once, as on the TPU.
//
// Design: K5's (csrc/nn_tc.cuh): 128 × 128 tiles of S in grouped order,
// walked by one persistent block per SM, a cp.async ring of 128-byte C
// chunks, wgmma (3×TF32 or bf16) into f32 accumulators. The row-stripe version computed S twice (one row-only
// kernel, launched again with the operands swapped) to avoid a
// per-row-block column scratch; here both directions reduce the same
// accumulator in the tile, and the tiles merge by atomics on O(B·(N1 + N2))
// scratch: the (max, argmax) key as K5's, the second value by the loser
// rule (the tile's own second, and whichever key lost its atomicMax),
// which is exact and independent of the order of the tiles.
#include "nn_tc.cuh"

// As sfd2_nn_argmax, plus rmax2 [B, N1] and cmax2 [B, N2] (the second
// values; the kernel keeps them encoded until its last pass).
extern "C" int sfd2_nn_top2(const void* d0, const void* d1, const uint8_t* v0,
                            const uint8_t* v1, long long sd0, long long sd1, long long sv0,
                            long long sv1, int B, int N1, int N2, int C, int bf16, void* op0,
                            void* op1, void* rkey, void* ckey, float* rmax, int* ridx,
                            float* rmax2, float* cmax, int* cidx, float* cmax2, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto* rk = reinterpret_cast<unsigned long long*>(rkey);
  auto* ck = reinterpret_cast<unsigned long long*>(ckey);
  if (bf16)
    return nn_tc_launch<__nv_bfloat16, true>(
        reinterpret_cast<const __nv_bfloat16*>(d0), reinterpret_cast<const __nv_bfloat16*>(d1),
        v0, v1, sd0, sd1, sv0, sv1, B, N1, N2, C, op0, op1, rk, ck, rmax, ridx, rmax2, cmax,
        cidx, cmax2, s);
  return nn_tc_launch<float, true>(reinterpret_cast<const float*>(d0),
                                   reinterpret_cast<const float*>(d1), v0, v1, sd0, sd1, sv0, sv1,
                                   B, N1, N2, C, op0, op1, rk, ck, rmax, ridx, rmax2, cmax, cidx,
                                   cmax2, s);
}

extern "C" const char* sfd2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
