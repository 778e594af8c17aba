// Two-view F-RANSAC for Hopper (sm_90a), plain C interface: three kernels
// per batch of pairs, launched by one call.
//
// Replaces: no TPU kernel. The JAX package vmaps sfd2_tpu/sfm/twoview.py::
// verify_fundamental_ransac and leaves it to XLA; the port's plain version,
// sfd2_torch/sfm/twoview.py::verify_fundamental_ransac_core, runs as ~2,500
// small eager torch ops a batch, and at the map build's batches (32 pairs,
// 1,024 matches, 2,048 hypotheses) their host dispatch is the cost.
// Contract: sfd2_torch/sfm/twoview.py::verify_fundamental_ransac_core (and,
// with the in-kernel sampler, verify_fundamental_ransac): per pair, every
// hypothesis an eight-point fit of `_fit_fundamental_lanes` (Hartley
// normalisation, the 9x9 Gram shifted by 1e-6 of its mean diagonal,
// Cholesky, 4 rounds of 2-column inverse subspace iteration, 2x2
// Rayleigh-Ritz, de-normalisation, the rank-2 projection by the closed-form
// 3x3 smallest eigenvector, Frobenius normalisation; a Gram matrix that is
// not positive definite makes the hypothesis lose), scored by MSAC over all
// N positions (Sampson errors in `_sampson_terms`' FMA order, clamped at
// thr2, padding scored thr2); the lowest score wins (lowest index on ties);
// 4 steps of local optimisation (weights 1/(1 + e/thr2) on inliers, a
// weighted re-fit taken only where MSAC improves); the final inlier mask,
// its count and the success rule. float32 throughout.
//
// What bounds it on this card: operations on the CUDA cores. A map-build
// batch is 65,536 fits of ~5 kFLOP and 65,536 x 1,024 Sampson errors of 33
// FLOP (an FMA counted as 2): ~2.5 GFLOP, 37 us at 67 TFLOP/s; its inputs
// are 0.3 MB.
//
// Design. twoview_list: one CTA per pair writes its valid positions, in
// order, to global scratch (a block prefix sum, so any mask works, at any N).
// twoview_score: grid (B, ceil(H / SCORE_THREADS)), one thread per
// hypothesis. Each thread draws its 8 distinct positions from that list with
// counter-based Philox4x32-10 keyed by the caller's 64-bit key, the pair and
// the hypothesis (or reads them from sample_idx), fits F in registers, and
// sums the clamped Sampson errors over the valid matches, staged TILE at a
// time as float4 in shared memory (every thread reads the same word: a
// broadcast). A warp-shuffle and shared-memory argmin writes each CTA's best
// (MSAC, F), a "slab". twoview_refine: one CTA per pair reduces the slabs in
// order to the winner, then runs the 4 steps of local optimisation as block
// reductions (centroids, scales, the 45 Gram entries, MSAC; each pass
// recomputes its weights from F, so no per-match state is kept and any N
// fits) with the 9x9 solve on one thread, and writes [success, inliers...] as
// uint8, the count and F. sfd2_twoview_refine runs it alone from a given F.
// No atomics: every sum runs in one fixed order, so a launch is
// deterministic.
//
// Rounding. The fit's rank-2 projection works on F in pixel coordinates,
// where FᵀF spans ~10 decades: in float32 its smallest eigenvector is
// decided by rounding, and that step sets most of a fit's error (on the
// CPU, a float64 fit projected in float32 scores as badly as a float32 fit;
// a float32 fit projected in float64 nearly as well as a float64 one). So
// the kernel rounds where the plain version rounds: it is built with
// -fmad=false (ops/cuda_build.py::SOURCE_FLAGS), each product and sum that
// the plain version computes as separate torch ops is rounded twice here
// too, and fmaf is written out where the plain version's fused op or
// product (addcmul, matmul, Cholesky, triangular solves, norms) takes one.
// Built with contracted FMAs, the kernel kept 0.80–0.86 of the ground
// truth's inlier decisions where the plain version kept 0.91–0.96.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#define SCORE_THREADS 128  // hypotheses per CTA of twoview_score
constexpr int REFINE_THREADS = 256;
constexpr int TILE = 1024;   // matches staged in shared memory at a time
constexpr int SLAB = 10;     // floats per slab: MSAC, then F row-major
constexpr float INF = __builtin_huge_valf();

// Packed lower triangle of a symmetric 9x9 matrix; every index is a
// compile-time constant once the loops are unrolled, so the arrays stay in
// registers.
__host__ __device__ constexpr int S(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// (x2ᵀ F x1)² / the Sampson denominator, in _sampson_terms' order.
__device__ __forceinline__ float sampson(const float (&f)[9], float x1, float y1, float x2,
                                         float y2) {
  const float fx0 = fmaf(f[1], y1, fmaf(f[0], x1, f[2]));
  const float fx1 = fmaf(f[4], y1, fmaf(f[3], x1, f[5]));
  const float e = fmaf(y2, fx1, fmaf(x2, fx0, fmaf(f[7], y1, fmaf(f[6], x1, f[8]))));
  float den = fmaf(fx1, fx1, fx0 * fx0);
  const float ft0 = fmaf(f[3], y2, fmaf(f[0], x2, f[6]));
  den = fmaf(ft0, ft0, den);
  const float ft1 = fmaf(f[4], y2, fmaf(f[1], x2, f[7]));
  den = fmaf(ft1, ft1, den);
  return (e * e) / clamp_min(den, 1e-12f);
}

// MSAC term: the error clamped at thr2 (NaN stays NaN, as torch's clamp).
__device__ __forceinline__ float msac_term(float e, float thr2) { return e > thr2 ? thr2 : e; }

__device__ __forceinline__ void mat3(const float (&a)[9], const float (&b)[9], float (&c)[9]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      c[3 * r + k] = fmaf(a[3 * r + 2], b[6 + k], fmaf(a[3 * r + 1], b[3 + k], a[3 * r] * b[k]));
}

// Unit eigenvector of the smallest eigenvalue of a symmetric 3x3 matrix:
// sfm/twoview.py::_sym3_smallest_eigvec.
__device__ void sym3_smallest_eigvec(const float (&a)[9], float (&v)[3]) {
  const float q = (a[0] + a[4] + a[8]) / 3.0f;
  float bm[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) bm[i] = a[i] - ((i % 4 == 0) ? q : 0.0f);
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < 9; ++i) ss += bm[i] * bm[i];
  const float p = sqrtf(clamp_min(ss / 6.0f, 1e-30f));
#pragma unroll
  for (int i = 0; i < 9; ++i) bm[i] = bm[i] / p;
  const float det = bm[0] * (bm[4] * bm[8] - bm[5] * bm[7]) -
                    bm[1] * (bm[3] * bm[8] - bm[5] * bm[6]) +
                    bm[2] * (bm[3] * bm[7] - bm[4] * bm[6]);
  const float phi = acosf(fminf(fmaxf(det / 2.0f, -1.0f), 1.0f)) / 3.0f;
  const float lam = q + 2.0f * p * cosf(phi + 2.09439510239319549f);
  float c[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) c[i] = a[i] - ((i % 4 == 0) ? lam : 0.0f);
  // Cross products of the rows (0,1), (0,2), (1,2); the longest wins.
  float best[3] = {0.0f, 0.0f, 0.0f};
  float best_n = -1.0f;
  const int ra[3] = {0, 0, 1}, rb[3] = {1, 2, 2};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* u = c + 3 * ra[k];
    const float* w = c + 3 * rb[k];
    const float x = u[1] * w[2] - u[2] * w[1];
    const float y = u[2] * w[0] - u[0] * w[2];
    const float z = u[0] * w[1] - u[1] * w[0];
    const float n = sqrtf(x * x + y * y + z * z);
    if (n > best_n) {
      best_n = n;
      best[0] = x;
      best[1] = y;
      best[2] = z;
    }
  }
  if (best_n > 1e-20f) {
    const float d = clamp_min(best_n, 1e-30f);
    v[0] = best[0] / d;
    v[1] = best[1] / d;
    v[2] = best[2] / d;
  } else {
    v[0] = 1.0f;
    v[1] = 0.0f;
    v[2] = 0.0f;
  }
}

// sfm/twoview.py::_smallest_eigvec_spd on the shifted Gram matrix m (packed);
// false where its Cholesky factorisation fails.
__device__ bool smallest_eigvec_spd(const float (&m)[45], float (&sol)[9]) {
  float l[45];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    float s = m[S(j, j)];
#pragma unroll
    for (int k = 0; k < j; ++k) s = fmaf(-l[S(j, k)], l[S(j, k)], s);
    if (!(s > 0.0f)) return false;
    const float d = sqrtf(s);
    l[S(j, j)] = d;
#pragma unroll
    for (int i = j + 1; i < 9; ++i) {
      float t = m[S(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) t = fmaf(-l[S(i, k)], l[S(j, k)], t);
      l[S(i, j)] = t / d;
    }
  }
  const float third = 1.0f / 3.0f;  // 1/sqrt(9)
  float x0[9], x1[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    x0[i] = third;
    x1[i] = (i % 2 == 0) ? third : -third;
  }
#pragma unroll 1
  for (int it = 0; it < 4; ++it) {
    // L y = x, then Lᵀ x = y, for both columns.
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      float a = x0[i], b = x1[i];
#pragma unroll
      for (int k = 0; k < i; ++k) {
        a = fmaf(-l[S(i, k)], x0[k], a);
        b = fmaf(-l[S(i, k)], x1[k], b);
      }
      x0[i] = a / l[S(i, i)];
      x1[i] = b / l[S(i, i)];
    }
#pragma unroll
    for (int i = 8; i >= 0; --i) {
      float a = x0[i], b = x1[i];
#pragma unroll
      for (int k = i + 1; k < 9; ++k) {
        a = fmaf(-l[S(k, i)], x0[k], a);
        b = fmaf(-l[S(k, i)], x1[k], b);
      }
      x0[i] = a / l[S(i, i)];
      x1[i] = b / l[S(i, i)];
    }
    float n0 = 0.0f;
#pragma unroll
    for (int i = 0; i < 9; ++i) n0 = fmaf(x0[i], x0[i], n0);
    n0 = clamp_min(sqrtf(n0), 1e-30f);
    float dot = 0.0f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      x0[i] = x0[i] / n0;
      dot += x0[i] * x1[i];
    }
    float n1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      x1[i] = x1[i] - dot * x0[i];
      n1 = fmaf(x1[i], x1[i], n1);
    }
    n1 = clamp_min(sqrtf(n1), 1e-30f);
#pragma unroll
    for (int i = 0; i < 9; ++i) x1[i] = x1[i] / n1;
  }
  // Closed-form 2x2 Rayleigh-Ritz on span(x0, x1).
  float baa = 0.0f, bab = 0.0f, bcc = 0.0f;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    float m0 = 0.0f, m1 = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      m0 = fmaf(m[S(i, k)], x0[k], m0);
      m1 = fmaf(m[S(i, k)], x1[k], m1);
    }
    baa += x0[i] * m0;
    bab += x0[i] * m1;
    bcc += x1[i] * m1;
  }
  const float half = 0.5f * (baa - bcc);
  const float lam = 0.5f * (baa + bcc) - sqrtf(half * half + bab * bab);
  const bool use_a = fabsf(lam - baa) > fabsf(lam - bcc);
  float v0 = use_a ? bab : lam - bcc;
  float v1 = use_a ? lam - baa : bab;
  if (sqrtf(v0 * v0 + v1 * v1) < 1e-20f) {
    v0 = baa <= bcc ? 1.0f : 0.0f;
    v1 = 1.0f - v0;
  }
  const float vn = sqrtf(v0 * v0 + v1 * v1);
  const float a0 = v0 / vn, a1 = v1 / vn;
#pragma unroll
  for (int i = 0; i < 9; ++i) sol[i] = x0[i] * a0 + x1[i] * a1;
  return true;
}

// F from the unshifted Gram matrix g (packed, of the Hartley-normalised
// rows) and the two normalisations (centroid c, scale s): the rest of
// sfm/twoview.py::_fit_fundamental_lanes. False where the fit is not finite.
__device__ bool fit_from_gram(float (&g)[45], float c1x, float c1y, float s1, float c2x,
                              float c2y, float s2, float (&f)[9]) {
  float tr = 0.0f;
#pragma unroll
  for (int i = 0; i < 9; ++i) tr += g[S(i, i)];
  const float shift = 1e-6f * (tr / 9.0f) + 1e-30f;
#pragma unroll
  for (int i = 0; i < 9; ++i) g[S(i, i)] += shift;
  float fn[9];
  if (!smallest_eigvec_spd(g, fn)) return false;
  // F = T2ᵀ f T1, T = [[s, 0, -s cx], [0, s, -s cy], [0, 0, 1]].
  const float t1[9] = {s1, 0.0f, -s1 * c1x, 0.0f, s1, -s1 * c1y, 0.0f, 0.0f, 1.0f};
  const float t2t[9] = {s2, 0.0f, 0.0f, 0.0f, s2, 0.0f, -s2 * c2x, -s2 * c2y, 1.0f};
  float tmp[9], fd[9];
  mat3(t2t, fn, tmp);
  mat3(tmp, t1, fd);
  // Rank 2: F - (F v3) v3ᵀ, v3 the smallest eigenvector of FᵀF.
  float ft[9], ata[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) ft[3 * r + k] = fd[3 * k + r];
  mat3(ft, fd, ata);
  float v3[3];
  sym3_smallest_eigvec(ata, v3);
  float nrm = 0.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float fv = fmaf(fd[3 * r + 2], v3[2], fmaf(fd[3 * r + 1], v3[1], fd[3 * r] * v3[0]));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      f[3 * r + k] = fd[3 * r + k] - fv * v3[k];
      nrm = fmaf(f[3 * r + k], f[3 * r + k], nrm);
    }
  }
  nrm = clamp_min(sqrtf(nrm), 1e-30f);
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    f[i] = f[i] / nrm;
    ok = ok && isfinite(f[i]);
  }
  return ok;
}

// Adds the Gram entries of one epipolar row [x2x1, x2y1, x2, y2x1, y2y1,
// y2, x1, y1, 1] of normalised points, scaled by w.
__device__ __forceinline__ void add_row(float (&g)[45], float x1, float y1, float x2, float y2,
                                        float w) {
  const float r[9] = {x2 * x1 * w, x2 * y1 * w, x2 * w, y2 * x1 * w, y2 * y1 * w,
                      y2 * w,      x1 * w,      y1 * w, w};
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) g[S(i, j)] = fmaf(r[i], r[j], g[S(i, j)]);
}

// Philox4x32-10 (Salmon et al., SC'11).
__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// 8 distinct draws from [0, nv) (nv >= 8): Philox words on the counter
// (hypothesis, pair, block, key[1]) under key[0], each mapped to
// floor(word * nv / 2^32); a repeat is drawn again.
__device__ void draw_eight(const unsigned long long* key, int b, int hyp, int nv, int (&s)[8]) {
  const unsigned long long k0 = key[0];
  const uint2 k = make_uint2((uint32_t)k0, (uint32_t)(k0 >> 32));
  const uint32_t kw = (uint32_t)key[1];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = -1;
  int got = 0;
  for (uint32_t blk = 0; got < 8; ++blk) {
    const uint4 r = philox(make_uint4((uint32_t)hyp, (uint32_t)b, blk, kw), k);
    const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = (int)__umulhi(words[u], (uint32_t)nv);
      bool dup = got >= 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) dup = dup || (j < got && s[j] == c);
      if (!dup) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j == got) s[j] = c;
        ++got;
      }
    }
  }
}

// The eight-point fit of positions pos: Hartley normalisation (unit
// weights), the Gram matrix of the 8 rows, then fit_from_gram.
__device__ bool fit_eight(const float2* __restrict__ p1, const float2* __restrict__ p2,
                          const int (&pos)[8], float (&f)[9]) {
  float a[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 u = __ldg(p1 + pos[j]), v = __ldg(p2 + pos[j]);
    a[j][0] = u.x;
    a[j][1] = u.y;
    a[j][2] = v.x;
    a[j][3] = v.y;
  }
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[q] += a[j][q];
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] = c[q] / 8.0f;
  float d1 = 0.0f, d2 = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float dx1 = a[j][0] - c[0], dy1 = a[j][1] - c[1];
    const float dx2 = a[j][2] - c[2], dy2 = a[j][3] - c[3];
    d1 += sqrtf(fmaf(dy1, dy1, dx1 * dx1));
    d2 += sqrtf(fmaf(dy2, dy2, dx2 * dx2));
  }
  const float s1 = 1.41421356237309515f / clamp_min(d1 / 8.0f, 1e-12f);
  const float s2 = 1.41421356237309515f / clamp_min(d2 / 8.0f, 1e-12f);
  float g[45];
#pragma unroll
  for (int i = 0; i < 45; ++i) g[i] = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    add_row(g, (a[j][0] - c[0]) * s1, (a[j][1] - c[1]) * s1, (a[j][2] - c[2]) * s2,
            (a[j][3] - c[3]) * s2, 1.0f);
  return fit_from_gram(g, c[0], c[1], s1, c[2], c[3], s2, f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Writes the valid positions of one pair, in order, to list; returns their
// count (on every thread).
template <int T>
__device__ int list_valid(const unsigned char* __restrict__ valid, int n, int* list,
                          int* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int base = 0;
  for (int c0 = 0; c0 < n; c0 += T) {
    const int i = c0 + tid;
    const bool v = i < n && valid[i] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, v);
    if (lane == 0) warp_tot[warp] = __popc(bal);
    __syncthreads();
    int before = base, chunk = 0;
#pragma unroll
    for (int w = 0; w < T / 32; ++w) {
      const int t = warp_tot[w];
      before += w < warp ? t : 0;
      chunk += t;
    }
    if (v) list[before + __popc(bal & ((1u << lane) - 1u))] = i;
    base += chunk;
    __syncthreads();
  }
  return base;
}

template <bool SAMPLED>
__global__ void __launch_bounds__(SCORE_THREADS)
twoview_score(const float2* __restrict__ xy1, const float2* __restrict__ xy2,
              const unsigned char* __restrict__ valid, int n, int h,
              const unsigned long long* __restrict__ key, const long long* __restrict__ sample_idx,
              const int* __restrict__ list_g, float thr2, float* __restrict__ slabs,
              float* __restrict__ msac_all, int* __restrict__ idx_out) {
  extern __shared__ float4 stage[];  // [min(n, TILE)] matches
  __shared__ float warp_m[SCORE_THREADS / 32];
  __shared__ int warp_h[SCORE_THREADS / 32];
  __shared__ int win_h;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int tile = n < TILE ? n : TILE;
  const float2* p1 = xy1 + (size_t)b * n;
  const float2* p2 = xy2 + (size_t)b * n;
  // twoview_list's: the pair's valid positions, then every pair's count.
  const int* list = list_g + (size_t)b * n;
  const int nv = list_g[(size_t)gridDim.x * n + b];

  const int hyp = blockIdx.y * SCORE_THREADS + tid;
  float f[9];
  bool ok = false;
  if (hyp < h) {
    int pos[8];
    bool have = true;
    if (SAMPLED) {
      if (nv >= 8) {
        int s[8];
        draw_eight(key, b, hyp, nv, s);
#pragma unroll
        for (int j = 0; j < 8; ++j) pos[j] = list[s[j]];
      } else {
        have = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) pos[j] = -1;
      }
    } else {
      const long long* si = sample_idx + ((size_t)b * h + hyp) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long q = si[j];
        have = have && q >= 0 && q < n;
        pos[j] = (q >= 0 && q < n) ? (int)q : -1;
      }
    }
    if (idx_out != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) idx_out[((size_t)b * h + hyp) * 8 + j] = pos[j];
    }
    if (have) ok = fit_eight(p1, p2, pos, f);
  }

  // MSAC over the valid matches, TILE at a time; padding adds thr2 each.
  float total = 0.0f;
  for (int t0 = 0; t0 < nv; t0 += tile) {
    const int cnt = nv - t0 < tile ? nv - t0 : tile;
    __syncthreads();
    for (int j = tid; j < cnt; j += SCORE_THREADS) {
      const int q = list[t0 + j];
      const float2 u = __ldg(p1 + q), v = __ldg(p2 + q);
      stage[j] = make_float4(u.x, u.y, v.x, v.y);
    }
    __syncthreads();
    if (ok) {
      int j = 0;
      for (; j + 32 <= cnt; j += 32) {  // partial sums of 32 terms
        float part = 0.0f;
#pragma unroll 8
        for (int k = 0; k < 32; ++k) {
          const float4 m = stage[j + k];
          part += msac_term(sampson(f, m.x, m.y, m.z, m.w), thr2);
        }
        total += part;
      }
      float part = 0.0f;
      for (; j < cnt; ++j) {
        const float4 m = stage[j];
        part += msac_term(sampson(f, m.x, m.y, m.z, m.w), thr2);
      }
      total += part;
    }
  }
  float msac = ok ? total + (float)(n - nv) * thr2 : INF;
  if (msac_all != nullptr && hyp < h) msac_all[(size_t)b * h + hyp] = msac;

  // Argmin over the CTA: the lowest MSAC, the lowest hypothesis on ties.
  int mh = hyp < h ? hyp : 0x7fffffff;
  float mm = hyp < h ? msac : INF;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, mm, o);
    const int oh = __shfl_xor_sync(0xffffffffu, mh, o);
    if (om < mm || (om == mm && oh < mh)) {
      mm = om;
      mh = oh;
    }
  }
  if ((tid & 31) == 0) {
    warp_m[tid >> 5] = mm;
    warp_h[tid >> 5] = mh;
  }
  __syncthreads();
  if (tid == 0) {
    float bm = warp_m[0];
    int bh = warp_h[0];
    for (int w = 1; w < SCORE_THREADS / 32; ++w)
      if (warp_m[w] < bm || (warp_m[w] == bm && warp_h[w] < bh)) {
        bm = warp_m[w];
        bh = warp_h[w];
      }
    win_h = bh;
    slabs[((size_t)b * gridDim.y + blockIdx.y) * SLAB] = bm;
  }
  __syncthreads();
  if (hyp == win_h) {
    float* out = slabs + ((size_t)b * gridDim.y + blockIdx.y) * SLAB + 1;
#pragma unroll
    for (int i = 0; i < 9; ++i) out[i] = ok ? f[i] : __int_as_float(0x7fc00000);
  }
}

// Each pair's valid list [n] into list_g, its count into list_g[b * n + pair].
__global__ void __launch_bounds__(SCORE_THREADS)
twoview_list(const unsigned char* __restrict__ valid, int n, int* __restrict__ list_g) {
  __shared__ int warp_tot[SCORE_THREADS / 32];
  const int b = blockIdx.x;
  const int nv = list_valid<SCORE_THREADS>(valid + (size_t)b * n, n, list_g + (size_t)b * n,
                                           warp_tot);
  if (threadIdx.x == 0) list_g[(size_t)gridDim.x * n + b] = nv;
}

// Block-wide sums of K values, on every thread, in one fixed order.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (*red)[48], float* tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp][k] = v[k];
  }
  __syncthreads();
  if (tid < K) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < REFINE_THREADS / 32; ++w) s += red[w][tid];
    tot[tid] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = tot[k];
}

// The local optimisation's weight of one match under F: 1 / (1 + e / thr2)
// on a valid inlier, else 0.
__device__ __forceinline__ float lo_weight(const float (&f)[9], float2 u, float2 v, bool ok,
                                           float thr2) {
  const float e = sampson(f, u.x, u.y, v.x, v.y);
  return (ok && e <= thr2) ? 1.0f / (1.0f + e / thr2) : 0.0f;
}

__device__ float block_msac(const float (&f)[9], const float2* __restrict__ p1,
                            const float2* __restrict__ p2, const unsigned char* __restrict__ valid,
                            int n, float thr2, float (*red)[48], float* tot) {
  float s[1] = {0.0f};
  for (int i = threadIdx.x; i < n; i += REFINE_THREADS) {
    const float2 u = __ldg(p1 + i), v = __ldg(p2 + i);
    s[0] += valid[i] ? msac_term(sampson(f, u.x, u.y, v.x, v.y), thr2) : thr2;
  }
  block_sum<1>(s, red, tot);
  return s[0];
}

__global__ void __launch_bounds__(REFINE_THREADS)
twoview_refine(const float2* __restrict__ xy1, const float2* __restrict__ xy2,
               const unsigned char* __restrict__ valid, int n, int n_slabs, float thr2,
               int min_inliers, float min_ratio, const float* __restrict__ slabs,
               float* __restrict__ f_out, int* __restrict__ num_out,
               unsigned char* __restrict__ packed, float* __restrict__ lo_msac) {
  __shared__ float red[REFINE_THREADS / 32][48];
  __shared__ float tot[48];
  __shared__ float sf[9];
  __shared__ int s_ok;
  const int b = blockIdx.x, tid = threadIdx.x;
  const float2* p1 = xy1 + (size_t)b * n;
  const float2* p2 = xy2 + (size_t)b * n;
  const unsigned char* val = valid + (size_t)b * n;
  unsigned char* out = packed + (size_t)b * (n + 1);

  if (tid == 0) {  // the slabs in order: the first lowest MSAC wins
    const float* sl = slabs + (size_t)b * n_slabs * SLAB;
    int best = 0;
    for (int k = 1; k < n_slabs; ++k)
      if (sl[k * SLAB] < sl[best * SLAB]) best = k;
    s_ok = sl[best * SLAB] < INF;
#pragma unroll
    for (int i = 0; i < 9; ++i) sf[i] = sl[best * SLAB + 1 + i];
  }
  float cntv[1] = {0.0f};
  for (int i = tid; i < n; i += REFINE_THREADS) cntv[0] += val[i] ? 1.0f : 0.0f;
  block_sum<1>(cntv, red, tot);  // its syncs publish s_ok and sf
  const int nvalid = (int)cntv[0];
  if (!s_ok) {  // no finite hypothesis: no inliers, no success
    for (int i = tid; i <= n; i += REFINE_THREADS) out[i] = 0;
    if (tid == 0) num_out[b] = 0;
    if (tid < 9) f_out[(size_t)b * 9 + tid] = __int_as_float(0x7fc00000);
    if (tid == 0 && lo_msac != nullptr) lo_msac[b] = INF;
    return;
  }
  float f[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) f[i] = sf[i];
  float cur = block_msac(f, p1, p2, val, n, thr2, red, tot);

  // Local optimisation: 4 weighted re-fits, each taken where MSAC improves.
#pragma unroll 1
  for (int it = 0; it < 4; ++it) {
    float a[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = tid; i < n; i += REFINE_THREADS) {
      const float2 u = __ldg(p1 + i), v = __ldg(p2 + i);
      const float w = lo_weight(f, u, v, val[i], thr2);
      a[0] += w;
      a[1] += u.x * w;
      a[2] += u.y * w;
      a[3] += v.x * w;
      a[4] += v.y * w;
    }
    block_sum<5>(a, red, tot);
    const float wsum = clamp_min(a[0], 1e-12f);
    const float c1x = a[1] / wsum, c1y = a[2] / wsum, c2x = a[3] / wsum, c2y = a[4] / wsum;
    float d[2] = {0.0f, 0.0f};
    for (int i = tid; i < n; i += REFINE_THREADS) {
      const float2 u = __ldg(p1 + i), v = __ldg(p2 + i);
      const float w = lo_weight(f, u, v, val[i], thr2);
      const float dx1 = u.x - c1x, dy1 = u.y - c1y, dx2 = v.x - c2x, dy2 = v.y - c2y;
      d[0] += sqrtf(fmaf(dy1, dy1, dx1 * dx1)) * w;
      d[1] += sqrtf(fmaf(dy2, dy2, dx2 * dx2)) * w;
    }
    block_sum<2>(d, red, tot);
    const float s1 = 1.41421356237309515f / clamp_min(d[0] / wsum, 1e-12f);
    const float s2 = 1.41421356237309515f / clamp_min(d[1] / wsum, 1e-12f);
    float g[45];
#pragma unroll
    for (int k = 0; k < 45; ++k) g[k] = 0.0f;
    for (int i = tid; i < n; i += REFINE_THREADS) {
      const float2 u = __ldg(p1 + i), v = __ldg(p2 + i);
      add_row(g, (u.x - c1x) * s1, (u.y - c1y) * s1, (v.x - c2x) * s2, (v.y - c2y) * s2,
              lo_weight(f, u, v, val[i], thr2));
    }
    block_sum<45>(g, red, tot);
    if (tid == 0) {
      float fl[9];
      s_ok = fit_from_gram(g, c1x, c1y, s1, c2x, c2y, s2, fl);
#pragma unroll
      for (int i = 0; i < 9; ++i) sf[i] = fl[i];
    }
    __syncthreads();
    float fl[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) fl[i] = sf[i];
    // Uniform across the CTA: block_msac's syncs are reached by all or none.
    const float cand = s_ok ? block_msac(fl, p1, p2, val, n, thr2, red, tot) : INF;
    if (cand < cur) {
#pragma unroll
      for (int i = 0; i < 9; ++i) f[i] = fl[i];
    }
    cur = fminf(cand, cur);
    __syncthreads();  // sf and s_ok are rewritten by the next step
  }

  float cnt[1] = {0.0f};
  for (int i = tid; i < n; i += REFINE_THREADS) {
    const float2 u = __ldg(p1 + i), v = __ldg(p2 + i);
    const bool in = val[i] && sampson(f, u.x, u.y, v.x, v.y) <= thr2;
    out[1 + i] = in ? 1 : 0;
    cnt[0] += in ? 1.0f : 0.0f;
  }
  block_sum<1>(cnt, red, tot);
  if (tid == 0) {
    const int num = (int)cnt[0];
    const float ratio = (float)num / (float)(nvalid > 1 ? nvalid : 1);
    out[0] = (num >= min_inliers && ratio >= min_ratio) ? 1 : 0;
    num_out[b] = num;
    if (lo_msac != nullptr) lo_msac[b] = cur;
  }
  if (tid < 9) f_out[(size_t)b * 9 + tid] = f[tid];
}

size_t score_smem(int n) { return (size_t)(n < TILE ? n : TILE) * 16; }

int launch_refine(const float2* a, const float2* c, const unsigned char* valid, int b, int n,
                  int n_slabs, float thr2, int min_inliers, float min_ratio, const float* slabs,
                  float* f_out, int* num_out, unsigned char* packed, float* lo_msac,
                  cudaStream_t st) {
  twoview_refine<<<b, REFINE_THREADS, 0, st>>>(a, c, valid, n, n_slabs, thr2, min_inliers,
                                               min_ratio, slabs, f_out, num_out, packed, lo_msac);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sfd2_twoview_threads() { return SCORE_THREADS; }

// F-RANSAC of b pairs of n padded matches with h hypotheses each: key (2
// uint64 on the device) draws the samples in the kernel, or sample_idx
// [b, h, 8] int64 gives them. slabs: [b, ceil(h / SCORE_THREADS), 10]
// scratch; list: b * n + b int32 scratch (the valid lists, then counts).
// Out: f_out [b, 9], num_out [b], packed [b, 1 + n] (success, then the
// inlier mask). msac_all [b, h] and idx_out [b, h, 8] int32 are optional
// (null): every hypothesis' MSAC and its sample.
extern "C" int sfd2_twoview_ransac(const float* xy1, const float* xy2, const unsigned char* valid,
                                   int b, int n, int h, const unsigned long long* key,
                                   const long long* sample_idx, float thr2, int min_inliers,
                                   float min_ratio, float* slabs, int* list, float* f_out,
                                   int* num_out, unsigned char* packed, float* msac_all,
                                   int* idx_out, void* stream) {
  if (b <= 0 || n < 0 || h <= 0) return (int)cudaErrorInvalidValue;
  if ((key == nullptr) == (sample_idx == nullptr)) return (int)cudaErrorInvalidValue;
  if (list == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int n_slabs = (h + SCORE_THREADS - 1) / SCORE_THREADS;
  const dim3 grid(b, n_slabs);
  const float2* a = reinterpret_cast<const float2*>(xy1);
  const float2* c = reinterpret_cast<const float2*>(xy2);
  twoview_list<<<b, SCORE_THREADS, 0, st>>>(valid, n, list);
  if (key != nullptr)
    twoview_score<true><<<grid, SCORE_THREADS, score_smem(n), st>>>(
        a, c, valid, n, h, key, nullptr, list, thr2, slabs, msac_all, idx_out);
  else
    twoview_score<false><<<grid, SCORE_THREADS, score_smem(n), st>>>(
        a, c, valid, n, h, nullptr, sample_idx, list, thr2, slabs, msac_all, idx_out);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_refine(a, c, valid, b, n, n_slabs, thr2, min_inliers, min_ratio, slabs, f_out,
                       num_out, packed, nullptr, st);
}

// twoview_refine alone: b pairs from given slabs [b, n_slabs, 10] (the
// lowest MSAC's F starts the local optimisation). Out as sfd2_twoview_ransac,
// and lo_msac [b] (optional): the MSAC after the local optimisation.
extern "C" int sfd2_twoview_refine(const float* xy1, const float* xy2, const unsigned char* valid,
                                   int b, int n, int n_slabs, float thr2, int min_inliers,
                                   float min_ratio, const float* slabs, float* f_out,
                                   int* num_out, unsigned char* packed, float* lo_msac,
                                   void* stream) {
  if (b <= 0 || n < 0 || n_slabs <= 0) return (int)cudaErrorInvalidValue;
  return launch_refine(reinterpret_cast<const float2*>(xy1), reinterpret_cast<const float2*>(xy2),
                       valid, b, n, n_slabs, thr2, min_inliers, min_ratio, slabs, f_out, num_out,
                       packed, lo_msac, reinterpret_cast<cudaStream_t>(stream));
}

extern "C" const char* sfd2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
