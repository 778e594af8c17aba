// K1 — fused ResSegNet encoder stem for Hopper (sm_90a), plain C interface.
//
// Replaces: sfd2_tpu/ops/pallas_stem.py::fused_stem_pallas (_stem_kernel).
// Contract: sfd2_torch/ops/stem.py::fused_stem_apply —
//   out1c = relu(conv1b_s2(relu(conv1a(x) + b1)) + b2), BNs folded,
//   x [B,H,W,3] f32 NHWC (H, W even) → out1c [B,H/2,W/2,64] f32 or bf16.
//
// What bounds it on this card: operations. Per 1024² image the direct form
// is 3.6 GFLOP (conv1a) + 19.3 GFLOP (conv1b) of f32 FMA work against
// 12.6 MB in and 67 MB out (f32), i.e. ~290 FLOP/byte, far above the f32
// CUDA-core ridge (67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte).
//
// Design: the one idea kept from the TPU kernel is that the full-resolution
// conv1a activation never reaches device memory. Each block owns an 8×8
// out1c tile × 64 channels. It stages the 19×19×3 input patch it needs in
// shared memory (zeros outside the image = conv1a's padding), computes the
// 17×17×64 out1a region into shared memory (zeros outside the image =
// conv1b's padding; pixel stride 65 floats to keep the conv1b reads free
// of bank conflicts), and runs conv1b (stride 2) plus the folded bias and
// ReLU from there, each thread holding a 4-pixel × 4-channel register
// tile. The direct 3×3 form is used rather than the s2d repack: the s2d
// form's structural zeros were free on the TPU's matrix unit but would
// double the FMA count here. No tensor cores, TMA or pipelining yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 8;               // out1c tile edge
constexpr int A_EDGE = 2 * TILE + 1;  // out1a region edge (17)
constexpr int X_EDGE = 2 * TILE + 3;  // input patch edge (19)
constexpr int C1 = 64;                // stem channels
constexpr int A_STRIDE = C1 + 1;      // floats per out1a pixel in smem
constexpr int THREADS = 256;

constexpr int A_FLOATS = A_EDGE * A_EDGE * A_STRIDE;
constexpr int X_FLOATS = X_EDGE * X_EDGE * 3;
constexpr int W1_FLOATS = 27 * C1;
constexpr size_t SMEM_BYTES = sizeof(float) * (A_FLOATS + X_FLOATS + W1_FLOATS + C1);

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

// w1: [3][3][3][64] (dy, dx, ci, co); w2: [3][3][64][64] (dy, dx, ci, co).
template <typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
stem_kernel(const float* __restrict__ x, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ w2,
            const float* __restrict__ b2, OutT* __restrict__ out, int H, int W) {
  extern __shared__ float smem[];
  float* a_s = smem;
  float* x_s = a_s + A_FLOATS;
  float* w1_s = x_s + X_FLOATS;
  float* b1_s = w1_s + W1_FLOATS;

  const int H2 = H / 2, W2 = W / 2;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TILE, ox0 = blockIdx.x * TILE;
  const int ay0 = 2 * oy0 - 1, ax0 = 2 * ox0 - 1;  // out1a region origin
  const int iy0 = ay0 - 1, ix0 = ax0 - 1;          // input patch origin
  const float* xb = x + (size_t)b * H * W * 3;
  const int tid = threadIdx.x;

  for (int i = tid; i < X_FLOATS; i += THREADS) {
    const int c = i % 3, pix = i / 3;
    const int gy = iy0 + pix / X_EDGE, gx = ix0 + pix % X_EDGE;
    x_s[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                 ? __ldg(xb + ((size_t)gy * W + gx) * 3 + c) : 0.f;
  }
  for (int i = tid; i < W1_FLOATS; i += THREADS) w1_s[i] = __ldg(w1 + i);
  if (tid < C1) b1_s[tid] = __ldg(b1 + tid);
  __syncthreads();

  // Stage A: conv1a + bias + ReLU for the 17×17 out1a region.
  {
    const int co = tid & (C1 - 1);
    float wr[27];
#pragma unroll
    for (int k = 0; k < 27; ++k) wr[k] = w1_s[k * C1 + co];
    const float bias = b1_s[co];
    for (int pix = tid >> 6; pix < A_EDGE * A_EDGE; pix += THREADS / C1) {
      const int r = pix / A_EDGE, col = pix % A_EDGE;
      const int gy = ay0 + r, gx = ax0 + col;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        float acc = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int ci = 0; ci < 3; ++ci)
              acc = fmaf(wr[(dy * 3 + dx) * 3 + ci],
                         x_s[((r + dy) * X_EDGE + col + dx) * 3 + ci], acc);
        v = fmaxf(acc + bias, 0.f);
      }
      a_s[pix * A_STRIDE + co] = v;
    }
  }
  __syncthreads();

  // Stage B: conv1b (stride 2) over the shared out1a region.
  const int cg = tid & 15;        // channels cg*4 .. cg*4+3
  const int pg = tid >> 4;        // 16 pixel groups of 4 along x
  const int ly = pg >> 1, lx0 = (pg & 1) * 4;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int dy = 0; dy < 3; ++dy) {
    for (int dx = 0; dx < 3; ++dx) {
      const float* arow = a_s + ((2 * ly + dy) * A_EDGE + 2 * lx0 + dx) * A_STRIDE;
      const float4* wk = reinterpret_cast<const float4*>(w2 + (dy * 3 + dx) * C1 * C1) + cg;
#pragma unroll 8
      for (int ci = 0; ci < C1; ++ci) {
        const float4 w = __ldg(wk + ci * (C1 / 4));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a = arow[j * 2 * A_STRIDE + ci];
          acc[j][0] = fmaf(a, w.x, acc[j][0]);
          acc[j][1] = fmaf(a, w.y, acc[j][1]);
          acc[j][2] = fmaf(a, w.z, acc[j][2]);
          acc[j][3] = fmaf(a, w.w, acc[j][3]);
        }
      }
    }
  }

  const float4 bb = __ldg(reinterpret_cast<const float4*>(b2) + cg);
  const int oy = oy0 + ly;
  if (oy >= H2) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ox = ox0 + lx0 + j;
    if (ox < W2) {
      OutT* p = out + (((size_t)b * H2 + oy) * W2 + ox) * C1 + cg * 4;
      store4(p, fmaxf(acc[j][0] + bb.x, 0.f), fmaxf(acc[j][1] + bb.y, 0.f),
             fmaxf(acc[j][2] + bb.z, 0.f), fmaxf(acc[j][3] + bb.w, 0.f));
    }
  }
}

template <typename OutT>
int launch(const float* x, const float* w1, const float* b1, const float* w2,
           const float* b2, OutT* out, int B, int H, int W, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W / 2 + TILE - 1) / TILE, (H / 2 + TILE - 1) / TILE, B);
  stem_kernel<OutT><<<grid, THREADS, SMEM_BYTES, stream>>>(x, w1, b1, w2, b2, out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sfd2_stem_forward(const float* x, const float* w1, const float* b1,
                                 const float* w2, const float* b2, void* out,
                                 int B, int H, int W, int out_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch(x, w1, b1, w2, b2, reinterpret_cast<__nv_bfloat16*>(out), B, H, W, s);
  return launch(x, w1, b1, w2, b2, reinterpret_cast<float*>(out), B, H, W, s);
}

extern "C" const char* sfd2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
