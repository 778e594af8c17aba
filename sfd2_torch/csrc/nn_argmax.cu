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
// What bounds it on this card: operations, on the tensor cores. At the
// large-bank threshold (N1 = N2 = 68,992, C = 128) one pair is
// 2·68,992²·128 ≈ 1.22 TFLOP against 71 MB of f32 descriptors. f32 inputs
// run as 3×TF32 (three products per term): 3 × 1.22 TFLOP / 495 TFLOP/s =
// 7.4 ms; bf16 inputs one bf16 pass: 1.22 / 989 = 1.23 ms. At [1, 4096,
// 128] and [1, 2048, 512] (4.3 GFLOP each) the same bounds are 0.026 and
// 0.004 ms, under the launch and pre-pass overheads.
//
// Design (csrc/nn_tc.cuh, shared with K2, K4, K6), against what held the row-stripe
// version back:
// 1. Grid: the work items are the 128 × 128 tiles of S of all B pairs, in
//    grouped order, walked by one persistent block per SM, so [1, 2048] is
//    256 tiles and [1, 68,992]² 290,521, where a row stripe gave 16 and 539
//    blocks that each walked all of N2.
// 2. Staging: C arrives in 128-byte chunks through a cp.async ring of 2
//    (f32) or 3 (bf16) stages, so the next chunks load while this one
//    multiplies; no chunk of the query tile is staged twice.
// 3. Arithmetic: wgmma on the tensor cores (3×TF32 for f32, bf16 × bf16 for
//    bf16), f32 accumulation, not f32 FMA on CUDA cores.
// 4. Merge: rows and columns both reduce inside the tile, then one 64-bit
//    atomicMax per row and per column on (encoded value, 0xFFFFFFFF −
//    index): exact and order-free, O(B·(N1 + N2)) scratch.
#include "nn_tc.cuh"

// Batch strides (sd*, sv*) are in elements; 0 broadcasts one operand to
// every batch entry. C % 4 == 0. op0/op1: scratch for the padded operands,
// Cp = C rounded up to whole 128-byte rows, [B or 1, N, Cp] elements of the
// descriptor type, twice for f32; rkey [B, N1] and ckey [B, N2] 64-bit.
extern "C" int sfd2_nn_argmax(const void* d0, const void* d1, const uint8_t* v0,
                              const uint8_t* v1, long long sd0, long long sd1, long long sv0,
                              long long sv1, int B, int N1, int N2, int C, int bf16, void* op0,
                              void* op1, void* rkey, void* ckey, float* rmax, int* ridx,
                              float* cmax, int* cidx, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto* rk = reinterpret_cast<unsigned long long*>(rkey);
  auto* ck = reinterpret_cast<unsigned long long*>(ckey);
  if (bf16)
    return nn_tc_launch<__nv_bfloat16, false>(
        reinterpret_cast<const __nv_bfloat16*>(d0), reinterpret_cast<const __nv_bfloat16*>(d1),
        v0, v1, sd0, sd1, sv0, sv1, B, N1, N2, C, op0, op1, rk, ck, rmax, ridx, nullptr, cmax,
        cidx, nullptr, s);
  return nn_tc_launch<float, false>(reinterpret_cast<const float*>(d0),
                                    reinterpret_cast<const float*>(d1), v0, v1, sd0, sd1, sv0,
                                    sv1, B, N1, N2, C, op0, op1, rk, ck, rmax, ridx, nullptr, cmax,
                                    cidx, nullptr, s);
}

extern "C" const char* sfd2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
