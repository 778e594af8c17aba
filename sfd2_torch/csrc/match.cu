// K2 — fused mutual-nearest-neighbour matcher for Hopper (sm_90a), plain C
// interface.
//
// Replaces: sfd2_tpu/ops/pallas_match.py::mutual_nn_match_pallas
// (_kernel_mutual + _make_epilogue_mutual/_gather_chunks).
// Contract: sfd2_torch/ops/matching.py::mutual_nn_match —
//   s[b,i,j] = (d0[b,i]·d1[b,j] + bias1[b,j]) + bias0[b,i], bias = −1e9 on
//   invalid rows/columns; per row the max and first-occurrence argmax, per
//   column the max; row i is matched iff rmax[i] == cmax[nn12[i]] (bit
//   equality of one computed value), alive iff rmax > −5e8.
//
// What bounds it on this card: operations, on the tensor cores. The query
// path matches one query against 64 padded banks, [64, 4096, 128]:
// 2·64·4096²·128 ≈ 275 GFLOP, as 3×TF32 for f32 descriptors (495 TFLOP/s
// ÷ 3: 1.67 ms), one bf16 pass for bf16 (989 TFLOP/s: 0.28 ms), against
// ~136 MB of f32 descriptors.
//
// Design: K5's tensor-core tiles (csrc/nn_tc.cuh, without the second
// values), then one last pass. nn_tc cuts S into 128 × 128 tiles of all B
// pairs, walked by one persistent block per SM; C arrives in 128-byte
// chunks through a cp.async ring (any C % 4 == 0: a pre-pass pads it with
// zeros and, for f32, splits it into TF32 hi and lo); wgmma computes each
// tile as 3×TF32 (within ~1e-6 of the plain f32 product) or bf16 × bf16,
// into f32 accumulators. Rows reduce over s + col_bias and columns over
// s + row_bias, both from the same accumulator, and the tiles merge by one
// 64-bit atomicMax per row and per column on (enc(v), 0xFFFFFFFF − index).
// The contract's s adds both biases; they are +0 for a valid row and a
// valid column, so for an alive row i and its best column nn both keys hold
// the contract's value: the row key its rmax, the column key at nn its
// cmax, bit for bit. match_epilogue then needs only the row's own validity:
// an invalid row, whose key ignores its bias, is dead and scores 0.
#include "nn_tc.cuh"

namespace {

// One thread per (b, i): matches [B, N1] (−1: none) and scores [B, N1].
__global__ void match_epilogue(const unsigned long long* __restrict__ rkey,
                               const unsigned long long* __restrict__ ckey,
                               const uint8_t* __restrict__ v0, long long sv0, int B, int N1,
                               int N2, int* __restrict__ matches, float* __restrict__ scores) {
  const size_t n = (size_t)B * N1;
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(t / N1), i = (int)(t % N1);
    const unsigned long long k = rkey[t];
    const float r = key_value(k);
    const int nn = key_index(k);
    const bool alive = v0[b * sv0 + i] && r > NEG / 2;
    const bool ok = alive && r == key_value(ckey[(size_t)b * N2 + nn]);
    matches[t] = ok ? nn : -1;
    scores[t] = alive ? r : 0.f;
  }
}

template <typename T>
int launch(const void* d0, const void* d1, const uint8_t* v0, const uint8_t* v1, long long sd0,
           long long sd1, long long sv0, long long sv1, int B, int N1, int N2, int C, void* op0,
           void* op1, unsigned long long* rkey, unsigned long long* ckey, int* matches,
           float* scores, cudaStream_t stream) {
  const int err = nn_tc_run<T, false>(static_cast<const T*>(d0), static_cast<const T*>(d1), v0,
                                      v1, sd0, sd1, sv0, sv1, B, N1, N2, C, op0, op1, rkey, ckey,
                                      nullptr, nullptr, stream);
  if (err != 0) return err;
  match_epilogue<<<grid_for((size_t)B * N1), 256, 0, stream>>>(rkey, ckey, v0, sv0, B, N1, N2,
                                                               matches, scores);
  return (int)cudaGetLastError();
}

}  // namespace

// Batch strides (sd*, sv*) are in elements; 0 broadcasts one query to
// every batch entry. C % 4 == 0. op0/op1, rkey, ckey: nn_tc's scratch, as
// for sfd2_nn_argmax (ops/cuda_match.py::nn_tc_scratch).
extern "C" int sfd2_mutual_nn_match(const void* d0, const void* d1, const uint8_t* v0,
                                    const uint8_t* v1, long long sd0, long long sd1,
                                    long long sv0, long long sv1, int B, int N1, int N2, int C,
                                    int bf16, void* op0, void* op1, void* rkey, void* ckey,
                                    int* matches, float* scores, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto* rk = reinterpret_cast<unsigned long long*>(rkey);
  auto* ck = reinterpret_cast<unsigned long long*>(ckey);
  if (bf16)
    return launch<__nv_bfloat16>(d0, d1, v0, v1, sd0, sd1, sv0, sv1, B, N1, N2, C, op0, op1, rk,
                                 ck, matches, scores, s);
  return launch<float>(d0, d1, v0, v1, sd0, sd1, sv0, sv1, B, N1, N2, C, op0, op1, rk, ck,
                       matches, scores, s);
}

extern "C" const char* sfd2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
