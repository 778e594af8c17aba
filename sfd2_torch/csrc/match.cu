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
// What bounds it on this card: operations. The query path matches one
// query against 64 padded banks, [64, 4096, 128]: 2·64·4096²·128 ≈ 275
// GFLOP of f32 FMA work against ~268 MB of descriptors (~1000 FLOP/byte).
//
// Design: a block owns BM=128 query rows of one batch entry, staged once in
// shared memory (k-major, so each thread reads its 8 rows and 4 columns as
// float4s), and walks all of N2 in BN=64-wide tiles of d1. Every s[i,j] is
// computed once, in registers (8×4 per thread, f32 FMA chain over C);
// both reductions read that same value, so the equality test is exact.
// Rows keep a running max and first-occurrence argmax (strictly-greater
// update, columns scanned in ascending order, ties across threads broken
// to the lower index). Columns: the TPU carried cmax across a sequential
// grid in VMEM; here blocks run in parallel and unordered, so each block
// reduces a column over its 128 rows and does one atomicMax on an
// order-preserving int encoding of the float — exact and order-free.
// The epilogue is a plain indexed load of cmax at nn12. Ragged N1/N2 are
// masked in-kernel. bf16 descriptors are widened to f32 when staged.
// No tensor cores, TMA or double buffering yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int THREADS = 256;  // 16 × 16; thread tile 8 rows × 4 columns
constexpr float NEG = -1e9f;

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

// Stage rows [row0, row0+rows) of a [n, C] matrix into smem k-major:
// dst[k * rows + r]; rows past n are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0, int rows,
                                      int n, int C) {
  const int c4 = C / 4;
  for (int idx = threadIdx.x; idx < rows * c4; idx += THREADS) {
    const int r = idx % rows, k = (idx / rows) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) v = load4(src + (size_t)(row0 + r) * C + k);
    dst[(k + 0) * rows + r] = v.x;
    dst[(k + 1) * rows + r] = v.y;
    dst[(k + 2) * rows + r] = v.z;
    dst[(k + 3) * rows + r] = v.w;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
mutual_kernel(const T* __restrict__ d0, const T* __restrict__ d1,
              const uint8_t* __restrict__ v0, const uint8_t* __restrict__ v1,
              long long sd0, long long sd1, long long sv0, long long sv1,
              int N1, int N2, int C, float* __restrict__ rmax,
              int* __restrict__ ridx, int* __restrict__ cmax_enc) {
  extern __shared__ float smem[];
  float* q_s = smem;              // [C][BM]
  float* d_s = q_s + C * BM;      // [C][BN]
  float* red = d_s + C * BN;      // [16][BN] column partial maxima

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const T* q = d0 + b * sd0;
  const T* db = d1 + b * sd1;
  const uint8_t* qv = v0 + b * sv0;
  const uint8_t* dv = v1 + b * sv1;

  stage(q_s, q, row0, BM, N1, C);

  float rbias[8];
  bool rin[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = row0 + ty * 8 + r;
    rin[r] = i < N1;
    rbias[r] = (rin[r] && qv[i]) ? 0.f : NEG;
  }
  float best[8];
  int besti[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    best[r] = -INFINITY;
    besti[r] = 0;
  }

  for (int j0 = 0; j0 < N2; j0 += BN) {
    __syncthreads();  // previous tile's d_s / red reads are done
    stage(d_s, db, j0, BN, N2, C);
    __syncthreads();

    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int k = 0; k < C; ++k) {
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

    float cm[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx * 4 + c;
      const bool cin = j < N2;
      const float cbias = (cin && dv[j]) ? 0.f : NEG;
      cm[c] = -INFINITY;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float s = (acc[r][c] + cbias) + rbias[r];
        if (cin && s > best[r]) {
          best[r] = s;
          besti[r] = j;
        }
        if (rin[r]) cm[c] = fmaxf(cm[c], s);
      }
      red[ty * BN + tx * 4 + c] = cm[c];
    }
    __syncthreads();
    if (tid < BN && j0 + tid < N2) {
      float m = red[tid];
#pragma unroll
      for (int t = 1; t < 16; ++t) m = fmaxf(m, red[t * BN + tid]);
      atomicMax(cmax_enc + (size_t)b * N2 + j0 + tid, enc(m));
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

__global__ void fill_kernel(int* p, size_t n, float value) {
  const int e = enc(value);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    p[i] = e;
}

__global__ void epilogue_kernel(const float* __restrict__ rmax, const int* __restrict__ ridx,
                                const int* __restrict__ cmax_enc,
                                const uint8_t* __restrict__ v0, long long sv0,
                                int B, int N1, int N2, int* __restrict__ matches,
                                float* __restrict__ scores) {
  const size_t n = (size_t)B * N1;
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(t / N1), i = (int)(t % N1);
    const float r = rmax[t];
    const int nn = ridx[t];
    const bool alive = r > NEG / 2;
    const bool ok = alive && v0[b * sv0 + i] && r == dec(cmax_enc[(size_t)b * N2 + nn]);
    matches[t] = ok ? nn : -1;
    scores[t] = alive ? r : 0.f;
  }
}

template <typename T>
int launch(const T* d0, const T* d1, const uint8_t* v0, const uint8_t* v1,
           long long sd0, long long sd1, long long sv0, long long sv1, int B,
           int N1, int N2, int C, float* rmax, int* ridx, int* cmax_enc,
           int* matches, float* scores, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)C * (BM + BN) + 16 * BN);
  cudaError_t err = cudaFuncSetAttribute(
      mutual_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t ncol = (size_t)B * N2;
  fill_kernel<<<(unsigned)((ncol + 255) / 256 < 4096 ? (ncol + 255) / 256 : 4096), 256, 0,
                stream>>>(cmax_enc, ncol, 2.f * NEG);
  const dim3 grid((N1 + BM - 1) / BM, B);
  mutual_kernel<T><<<grid, THREADS, smem, stream>>>(d0, d1, v0, v1, sd0, sd1, sv0, sv1,
                                                    N1, N2, C, rmax, ridx, cmax_enc);
  const size_t nrow = (size_t)B * N1;
  epilogue_kernel<<<(unsigned)((nrow + 255) / 256 < 4096 ? (nrow + 255) / 256 : 4096), 256, 0,
                    stream>>>(rmax, ridx, cmax_enc, v0, sv0, B, N1, N2, matches, scores);
  return (int)cudaGetLastError();
}

}  // namespace

// Batch strides (sd*, sv*) are in elements; 0 broadcasts one query to
// every batch entry. C % 4 == 0 and C <= 256.
extern "C" int sfd2_mutual_nn_match(const void* d0, const void* d1, const uint8_t* v0,
                                    const uint8_t* v1, long long sd0, long long sd1,
                                    long long sv0, long long sv1, int B, int N1, int N2,
                                    int C, int bf16, float* rmax, int* ridx,
                                    int* cmax_enc, int* matches, float* scores,
                                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16)
    return launch(reinterpret_cast<const __nv_bfloat16*>(d0),
                  reinterpret_cast<const __nv_bfloat16*>(d1), v0, v1, sd0, sd1, sv0, sv1,
                  B, N1, N2, C, rmax, ridx, cmax_enc, matches, scores, s);
  return launch(reinterpret_cast<const float*>(d0), reinterpret_cast<const float*>(d1), v0,
                v1, sd0, sd1, sv0, sv1, B, N1, N2, C, rmax, ridx, cmax_enc, matches,
                scores, s);
}

extern "C" const char* sfd2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
