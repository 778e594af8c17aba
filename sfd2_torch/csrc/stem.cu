// K1 — fused ResSegNet encoder stem for Hopper (sm_90a only: wgmma), plain C
// interface.
//
// Replaces: sfd2_tpu/ops/pallas_stem.py::fused_stem_pallas (_stem_kernel).
// Contract: sfd2_torch/ops/stem.py::fused_stem_apply —
//   out1c = relu(conv1b_s2(relu(conv1a(x) + b1)) + b2), BNs folded,
//   x [B,H,W,3] f32 NHWC (H, W even) → out1c [B,H/2,W/2,64] f32 or bf16.
//
// What bounds it on this card: operations. Per 1024² image 3.6 GFLOP
// (conv1a) + 19.3 GFLOP (conv1b) against 12.6 MB in and 33.6 MB of bf16
// out. f32 accuracy on the tensor cores takes three TF32 products per term
// (3×TF32, as the matchers of nn_tc.cuh), so the least time is the work
// over 495 / 3 TFLOP/s: 0.556 ms per 4-image batch (f32 FMA on the CUDA
// cores: 1.37 ms).
//
// Design. As in the TPU kernel, the full-resolution conv1a activation never
// reaches device memory. Each block owns an 8 × 16 out1c tile × 64
// channels (one block per SM: 213 KB of shared memory). Both convolutions
// run on the tensor cores as wgmma m64n64k8 with A in registers and B in
// shared memory, 3×TF32: per k-step of 8 the products lo·hi + hi·lo, then
// hi·hi, into one f32 accumulator; A is split into TF32 hi and lo with
// cvt.rna as it is loaded, B (the weights) arrives split, in the k order
// and 128-byte swizzle wgmma reads (ops/cuda_stem.py::stem_tc_w1_image,
// stem_tc_weight_image).
// - Stage A: the 19 × 35 × 3 input patch goes to shared memory (zeros
//   outside the image = conv1a's padding); conv1a is a GEMM over the 561
//   pixels of the 17 × 33 out1a region (9 row tiles of 64, alternating
//   between the two warpgroups), K = 27 taps × channels padded to 32, each
//   thread gathering its fragment straight from the patch.
//   relu(conv1a + b1) goes to shared memory split into the region's four
//   stride-2 parity planes (zeros outside the image = conv1b's padding).
//   Pixels are 64 floats; the 16-byte piece q of pixel p sits at
//   q ^ 4·(p mod 2), which keeps the fragment loads below free of bank
//   conflicts.
// - Stage B: conv1b is an implicit GEMM, M = the 128 tile
//   pixels (two warpgroups of 64: an 8 × 8 half each), N = 64, K = 9 taps ×
//   64 channels. Tap (dy, dx) reads parity plane (dy mod 2, dx mod 2)
//   shifted by (dy / 2, dx / 2): a dense window, no structural zeros (the
//   TPU kernel's s2d repack had them). The windows are not aligned to
//   wgmma's swizzle atoms, so A comes from registers: each thread loads its
//   fragment rows as float4 (four channels, two k-steps: the k order inside
//   a tap is permuted to match, in the weights too) and splits them into
//   TF32 hi and lo. The weights stream one tap (32 KB) at a time through a
//   two-slot cp.async ring, the next tap loading while this one multiplies
//   (conv1a's weights, 16 KB, sit in the second slot during stage A).
//   Bias, ReLU and the NHWC store come from the accumulator registers.
// The stages run in turn within a block, and one block fills an SM, so
// loads, the hi/lo split and the epilogues do not overlap the MMA.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 16;        // out1c tile: rows × columns
constexpr int A_H = 2 * TH + 1;       // out1a region rows (17)
constexpr int A_W = 2 * TW + 1;       // out1a region columns (33)
constexpr int X_H = A_H + 2, X_W = A_W + 2;  // input patch (19 × 35)
constexpr int C1 = 64;                // stem channels
constexpr int THREADS = 256;          // two warpgroups
constexpr int K1 = 32;                // conv1a's K: 27 (tap, channel) terms, zero-padded

// Parity planes of the out1a region: plane (pr, pc) holds region pixels
// (r, c) with r mod 2 = pr, c mod 2 = pc at (r / 2, c / 2).
constexpr int PR0 = (A_H + 1) / 2, PR1 = A_H / 2;  // plane rows: 9, 8
constexpr int PC0 = (A_W + 1) / 2, PC1 = A_W / 2;  // plane columns: 17, 16
constexpr int OFF01 = PR0 * PC0, OFF10 = OFF01 + PR0 * PC1, OFF11 = OFF10 + PR1 * PC0;
constexpr int PLANE_PIXELS = OFF11 + PR1 * PC1;    // 561 = A_H · A_W
constexpr int A_TILES = (PLANE_PIXELS + 63) / 64;  // stage A's 64-row tiles

constexpr int SLOT_BYTES = 2 * 2 * C1 * 128;       // one tap: hi, lo × 2 k-chunks × 64 rows × 128 B
constexpr int RING_BYTES = 2 * SLOT_BYTES;
constexpr int PLANE_FLOATS = PLANE_PIXELS * C1;
constexpr int X_FLOATS = X_H * X_W * 3;
constexpr int X_FLOATS_PAD = (X_FLOATS + 3) / 4 * 4;
constexpr int W1_BYTES = 2 * C1 * K1 * 4;        // conv1a's weight image: hi, lo × 64 rows × 128 B
// 1024 bytes of alignment slack, the ring, the planes, the patch, b1.
constexpr int SMEM_BYTES = 1024 + RING_BYTES + 4 * (PLANE_FLOATS + X_FLOATS_PAD + C1);
static_assert(SMEM_BYTES <= 232448, "one block per SM");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address, leading offset 16 B (unused for this layout),
// stride 1024 B between 8-row groups, layout 1 (128B swizzle).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 × 64 tile of this warpgroup] += A (64 × 8 tf32, registers) · B (64 × 8
// tf32, shared memory, K-major)ᵀ. A fragment: thread (warp w, lane 4g + t)
// holds rows 16w + g (a[0], a[2]) and 16w + g + 8 (a[1], a[3]), columns t
// (a[0], a[1]) and t + 4 (a[2], a[3]).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Keep the compiler from moving register reads or writes across the
// asynchronous wgmma group (and from reusing its A registers before the
// group has finished with them).
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int s = 0; s < N; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[s][i])::"memory");
}

// BYTES (a multiple of 16 · THREADS) of a weight image, contiguous in
// global memory, into shared memory at dst.
template <int BYTES>
__device__ __forceinline__ void load_image(uint32_t dst, const void* src) {
#pragma unroll
  for (int q = 0; q < BYTES / 16 / THREADS; ++q) {
    const int i = threadIdx.x + q * THREADS;
    cp_async16(dst + 16 * i, static_cast<const uint8_t*>(src) + 16 * i);
  }
}

// One tap of conv1b's weight image (32 KB) into a ring slot.
__device__ __forceinline__ void load_tap(uint32_t slot, const float* __restrict__ w2img, int tap) {
  load_image<SLOT_BYTES>(slot, reinterpret_cast<const uint8_t*>(w2img) + (size_t)tap * SLOT_BYTES);
}

// Patch offset (floats) of conv1a's k-th term, (dy, dx, ci) = k / 9,
// k / 3 mod 3, k mod 3; the padding terms (k ≥ 27) read the pixel itself
// against zero weights.
__device__ __forceinline__ int conv1a_offset(int k) {
  return k < 27 ? ((k / 9) * X_W + (k / 3) % 3) * 3 + k % 3 : 0;
}

__device__ __forceinline__ void split4(const float (&f)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(f[i]);
    lo[i] = tf32_rna(f[i] - __uint_as_float(hi[i]));
  }
}

// Float offset of channel piece q (4 channels) of plane pixel p.
__device__ __forceinline__ int piece(int p, int q) {
  return p * C1 + ((q ^ ((p & 1) << 2)) << 2);
}

__device__ __forceinline__ int plane_offset(int pr, int pc) {
  return pr ? (pc ? OFF11 : OFF10) : (pc ? OFF01 : 0);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Fragment rows of one chunk of 32 channels (kc) of one tap: for k-steps
// s = 0..3 of the chunk (channels 32kc + 8s ..), a[s] = {row g at k t,
// row g + 8 at k t, row g at k t + 4, row g + 8 at k t + 4}, where k t
// holds channel 32kc + 16(s / 2) + 4t + 2(s mod 2) and k t + 4 the next.
// p0 / p1: the plane pixels of rows g and g + 8.
__device__ __forceinline__ void load_split(const float* planes, int p0, int p1, int kc, int t,
                                           uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int q = 4 * (2 * kc + u) + t;  // the 16-byte piece of channels 16(2kc + u) + 4t ..
    const float4 v0 = *reinterpret_cast<const float4*>(planes + piece(p0, q));
    const float4 v1 = *reinterpret_cast<const float4*>(planes + piece(p1, q));
    const float f0[4] = {v0.x, v1.x, v0.y, v1.y}, f1[4] = {v0.z, v1.z, v0.w, v1.w};
    split4(f0, hi[2 * u], lo[2 * u]);
    split4(f1, hi[2 * u + 1], lo[2 * u + 1]);
  }
}

// The 12 wgmma of one 128-byte k-chunk (4 k-steps): lo·hi + hi·lo, then
// hi·hi, at B's hi part b_hi and lo part b_lo.
__device__ __forceinline__ void mma_chunk(float (&d)[32], const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4], uint32_t b_hi,
                                          uint32_t b_lo) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    wgmma_rs(d, lo[s], desc_sw128(b_hi + 32 * s));
    wgmma_rs(d, hi[s], desc_sw128(b_lo + 32 * s));
    wgmma_rs(d, hi[s], desc_sw128(b_hi + 32 * s));
  }
}

// w1img: stem_tc_w1_image(w1); w2img: stem_tc_weight_image(w2).
template <typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
stem_kernel(const float* __restrict__ x, const float* __restrict__ w1img,
            const float* __restrict__ b1, const float* __restrict__ w2img,
            const float* __restrict__ b2, OutT* __restrict__ out, int H, int W) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle atoms need 1024-byte alignment
  float* planes = reinterpret_cast<float*>(smem_raw + (ring - raw) + RING_BYTES);
  float* x_s = planes + PLANE_FLOATS;
  float* b1_s = x_s + X_FLOATS_PAD;

  const int H2 = H / 2, W2 = W / 2;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int ay0 = 2 * oy0 - 1, ax0 = 2 * ox0 - 1;  // out1a region origin
  const int iy0 = ay0 - 1, ix0 = ax0 - 1;          // input patch origin
  const float* xb = x + (size_t)b * H * W * 3;
  const int tid = threadIdx.x;

  load_image<W1_BYTES>(ring + SLOT_BYTES, w1img);  // conv1a's weights in the second slot
  load_tap(ring, w2img, 0);                        // tap 0's load under stage A
  cp_async_commit();
  for (int i = tid; i < X_FLOATS; i += THREADS) {
    const int c = i % 3, pix = i / 3;
    const int gy = iy0 + pix / X_W, gx = ix0 + pix % X_W;
    x_s[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                 ? __ldg(xb + ((size_t)gy * W + gx) * 3 + c) : 0.f;
  }
  if (tid < C1) b1_s[tid] = __ldg(b1 + tid);
  cp_async_wait<0>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  __syncthreads();

  const int wg = tid >> 7;  // warpgroup
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // Stage A: relu(conv1a + b1) of the out1a region into the parity planes.
  // Row tile mt holds region pixels 64mt .. 64mt + 63 (r = m / A_W, c = m mod
  // A_W); this thread's fragment rows are 16·warp + g (+ 8), its k-step s
  // terms k = 8s + t (+ 4).
  {
    int koff[4][2];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      koff[s][0] = conv1a_offset(8 * s + t);
      koff[s][1] = conv1a_offset(8 * s + t + 4);
    }
    const uint32_t w1_hi = ring + SLOT_BYTES, w1_lo = w1_hi + C1 * K1 * 4;
    for (int mt = wg; mt < A_TILES; mt += 2) {
      int m[2], xo[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[h] = 64 * mt + 16 * warp + g + 8 * h;
        const int mc = min(m[h], PLANE_PIXELS - 1);  // rows past the region load a real pixel
        xo[h] = ((mc / A_W) * X_W + mc % A_W) * 3;
      }
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float f[4] = {x_s[xo[0] + koff[s][0]], x_s[xo[1] + koff[s][0]],
                            x_s[xo[0] + koff[s][1]], x_s[xo[1] + koff[s][1]]};
        split4(f, ahi[s], alo[s]);
      }
      float d1[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) d1[i] = 0.f;
      fence_regs(ahi);
      fence_regs(alo);
      fence_acc(d1);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      mma_chunk(d1, ahi, alo, w1_hi, w1_lo);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d1);
      fence_regs(ahi);
      fence_regs(alo);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (m[h] >= PLANE_PIXELS) continue;
        const int r = m[h] / A_W, c = m[h] % A_W;
        const int gy = ay0 + r, gx = ax0 + c;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const int p = plane_offset(r & 1, c & 1) + (r >> 1) * ((c & 1) ? PC1 : PC0) + (c >> 1);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int co = 8 * i + 2 * t;
          store2(planes + piece(p, co >> 2) + (co & 3),
                 in ? fmaxf(d1[4 * i + 2 * h] + b1_s[co], 0.f) : 0.f,
                 in ? fmaxf(d1[4 * i + 2 * h + 1] + b1_s[co + 1], 0.f) : 0.f);
        }
      }
    }
  }
  __syncthreads();  // the planes are complete, and the second slot is free
#ifdef STEM_CONV1A_ONLY
  // Measurement variant (chip_smoke.py times it for stage A's share of the
  // kernel): no stage B; the tile's first out1a pixel is stored so that
  // stage A is not optimised away.
  cp_async_wait<0>();
  if (tid < C1 && oy0 < H2 && ox0 < W2) {
    OutT* o = out + (((size_t)b * H2 + oy0) * W2 + ox0) * C1 + (tid & ~1);
    if ((tid & 1) == 0) store2(o, planes[piece(0, tid >> 2) + (tid & 3)],
                               planes[piece(0, tid >> 2) + (tid & 3) + 1]);
  }
  return;
#endif
  load_tap(ring + SLOT_BYTES, w2img, 1);
  cp_async_commit();

  // Stage B: conv1b as an implicit GEMM over the 9 taps. Warpgroup wg takes
  // the tile's 8 × 8 half of columns 8wg .. 8wg + 7: fragment rows
  // 16·warp + g (+ 8) are out1c pixel (row 2·warp (+ 1), column 8wg + g).
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    cp_async_wait<1>();  // this tap's weights have landed (this thread's copies)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();
    const uint32_t slot = ring + (tap & 1) * SLOT_BYTES;
    const int dy = tap / 3, dx = tap % 3;
    const int pc = dx & 1;
    const int row = plane_offset(dy & 1, pc) + (2 * warp + (dy >> 1)) * (pc ? PC1 : PC0) +
                    8 * wg + g + (dx >> 1);
    const int p0 = row, p1 = row + (pc ? PC1 : PC0);
    uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
    load_split(planes, p0, p1, 0, t, ah0, al0);
    fence_regs(ah0);
    fence_regs(al0);
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    mma_chunk(d, ah0, al0, slot, slot + 2 * C1 * 128);  // slot: hi k-chunks 0, 1; lo 0, 1
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    load_split(planes, p0, p1, 1, t, ah1, al1);  // under the first chunk's products
    fence_regs(ah1);
    fence_regs(al1);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    mma_chunk(d, ah1, al1, slot + C1 * 128, slot + 3 * C1 * 128);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
    fence_regs(ah0);
    fence_regs(al0);
    fence_regs(ah1);
    fence_regs(al1);
    __syncthreads();  // both warpgroups are done with this slot
    if (tap + 2 < 9) load_tap(slot, w2img, tap + 2);
    cp_async_commit();  // (an empty group past the last tap keeps the wait count uniform)
  }

  // Epilogue: accumulator (row h: 16·warp + g + 8h, column 8i + 2t + c) at
  // d[4i + 2h + c] → bias, ReLU, NHWC.
  const int ox = ox0 + 8 * wg + g;
  if (ox >= W2) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int oy = oy0 + 2 * warp + h;
    if (oy < H2) {
      OutT* o = out + (((size_t)b * H2 + oy) * W2 + ox) * C1;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int co = 8 * i + 2 * t;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + co));
        store2(o + co, fmaxf(d[4 * i + 2 * h] + bb.x, 0.f), fmaxf(d[4 * i + 2 * h + 1] + bb.y, 0.f));
      }
    }
  }
}

template <typename OutT>
int launch(const float* x, const float* w1img, const float* b1, const float* w2img,
           const float* b2, OutT* out, int B, int H, int W, cudaStream_t stream) {
  // Per launch, not once per process: the attribute belongs to the current
  // device.
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W / 2 + TW - 1) / TW, (H / 2 + TH - 1) / TH, B);
  stem_kernel<OutT><<<grid, THREADS, SMEM_BYTES, stream>>>(x, w1img, b1, w2img, b2, out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sfd2_stem_forward(const float* x, const float* w1img, const float* b1,
                                 const float* w2img, const float* b2, void* out,
                                 int B, int H, int W, int out_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch(x, w1img, b1, w2img, b2, reinterpret_cast<__nv_bfloat16*>(out), B, H, W, s);
  return launch(x, w1img, b1, w2img, b2, reinterpret_cast<float*>(out), B, H, W, s);
}

extern "C" const char* sfd2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
