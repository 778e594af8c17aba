// The matchers on Hopper's tensor cores, sm_90a only (wgmma): one kernel
// template for all four. K5 (nn_argmax.cu) and K2 (match.cu) take it
// without, K6 (nn_top2.cu) and K4 (match_ratio.cu) with the second values
// (TOP2); they differ only in their last pass over the merged keys (K5/K6
// unpack them, K2/K4 decide the matches).
//
// S = D0·D1ᵀ is cut into 128 × 128 tiles: the work items of all B pairs,
// walked in groups of GROUP_M row tiles so that the blocks running at once
// share their operands in L2. One persistent block per SM takes every
// gridDim.x-th item. It computes a whole tile over all of C and reduces it
// both ways; the tiles of one row (or column) of S merge by atomics on
// O(B·(N1 + N2)) scratch that the wrapper allocates, exactly and in any
// order:
// - a (value, index) pair is one 64-bit key, (enc(v) ^ 0x80000000) << 32 |
//   (0xFFFFFFFF − index): atomicMax keeps the largest value and, among
//   equal values, the lowest index;
// - TOP2's second value follows the loser rule: a tile pushes its key with
//   old = atomicMax(key, new), then atomicMax(second, enc(max(its own
//   second, value(min(old, new))))), old skipped while it is still the zero
//   sentinel. Every key but the final winner loses exactly once (on arrival
//   or when displaced), so `second` ends as the largest of all entries
//   but the winner's: the multiset second, and a max reached twice gives
//   second == max.
//
// The product. Operands come from a pre-pass that pads C with zeros to a
// multiple of one 128-byte row chunk (32 f32 or 64 bf16) and, for f32,
// splits x = hi + lo with hi = tf32(x), lo = tf32(x − hi) (cvt.rna). The
// main loop streams 128-byte chunks of the A and B tiles with cp.async into
// a ring of 2 (f32) or 3 (bf16) buffers in the 128-byte swizzled layout
// that wgmma reads, so the next chunks load while this one multiplies; the
// loads run on across work items, so the next tile's first chunk loads
// under this tile's epilogue. Each of the
// two warpgroups owns 64 rows: wgmma m64n128k16 bf16 × bf16 → f32, or for
// f32 3×TF32 with m64n128k8, lo·hi + hi·lo, then hi·hi, into one f32
// accumulator (≈ f32 accuracy, where one TF32 pass keeps ~1e-3). Both
// reductions read the same accumulator, so the two directions of one
// similarity cannot disagree, and identical descriptors give bit-identical
// similarities wherever they sit (the same instructions in the same order).
//
// The epilogue works on wgmma's accumulator layout: thread (warp w, lane
// 4g + t) holds rows 16w + g and 16w + g + 8, columns 8i + 2t + {0, 1}, at
// d[4i + 2h + c]. Biases are added first (+0 or −1e9 on invalid rows or
// columns, −inf outside N1 × N2, which also turns a −0 into +0 before enc).
// Rows: a strictly-greater scan in ascending column order in registers,
// then the four lanes of a quad (ties to the lower index). Columns: the
// biased tile goes to shared memory, two threads scan each column (rows
// ascending, one half each), and the halves merge. Then one atomic per row
// and per column (TOP2: two, the second after the first's value returns).
#pragma once

#include <math.h>
#include <stdint.h>

#include "match_common.cuh"  // enc, dec, NEG, grid_for

namespace {

constexpr int TILE = 128;                     // rows and columns of S per block
constexpr int TC_THREADS = 256;               // two warpgroups of 64 rows each
constexpr int ROW_BYTES = 128;                // one k-chunk of a row: the swizzle atom's row
constexpr int TILE_BYTES = TILE * ROW_BYTES;  // one operand tile of one chunk, 16 KB
constexpr int GROUP_M = 16;                   // row tiles per group of the tile order
constexpr float NEG2 = -2e9f;                 // the reference's masked / initial second value

// Depth of the cp.async ring: 2 stages of 64 KB for f32, 3 of 32 KB for
// bf16, beside the epilogue's tile in one block per SM.
template <bool F32>
__host__ __device__ constexpr int stages() {
  return F32 ? 2 : 3;
}

template <bool F32>
__host__ __device__ constexpr int stage_bytes() {
  return (F32 ? 4 : 2) * TILE_BYTES;
}

constexpr int TP = TILE + 8;  // row pitch (floats) of the epilogue's tile: float2 stores
                              // of a quad's 8 rows and a warp's column reads hit 32 banks

// Dynamic shared memory of nn_tc_kernel: 1024 bytes of alignment slack, the
// ring, the epilogue's [TILE][TP] tile, the row and column biases.
template <bool F32>
__host__ __device__ constexpr int tc_smem_bytes() {
  return 1024 + stages<F32>() * stage_bytes<F32>() + (TILE * TP + 2 * TILE) * 4;
}

// C padded to whole 128-byte row chunks (ops/cuda_match.py::nn_tc_scratch
// sizes the scratch by the same rule).
inline int nn_tc_padded_width(int C, int esize) {
  const int per = ROW_BYTES / esize;
  return (C + per - 1) / per * per;
}

__device__ __forceinline__ unsigned long long pack_key(float v, int index) {
  const unsigned hi = static_cast<unsigned>(enc(v)) ^ 0x80000000u;
  return (static_cast<unsigned long long>(hi) << 32) | (0xFFFFFFFFu - static_cast<unsigned>(index));
}

__device__ __forceinline__ float key_value(unsigned long long k) {
  return dec(static_cast<int>(static_cast<unsigned>(k >> 32) ^ 0x80000000u));
}

__device__ __forceinline__ int key_index(unsigned long long k) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(k & 0xFFFFFFFFu));
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// ---- the pre-pass: pad C, split f32 into TF32 hi and lo ----------------

// Four columns k..k+3 of one row of src [Bs, N, C] (batch stride sd
// elements) → hi [Bs·N, Cp] (and, for f32, lo [Bs·N, Cp]), zeros in columns
// C..Cp-1; t indexes (row, k / 4).
template <typename T>
__device__ __forceinline__ void pad_split4(const T* __restrict__ src, long long sd, int N, int C,
                                           int Cp, size_t t, T* __restrict__ hi,
                                           float* __restrict__ lo) {
  const size_t row = t / (Cp / 4);
  const int k = (int)(t % (Cp / 4)) * 4;
  const T* p = src + (long long)(row / N) * sd + (row % N) * C + k;
  if constexpr (sizeof(T) == 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < C) x = __ldg(reinterpret_cast<const float4*>(p));
    const float4 h = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
    const float4 l = make_float4(tf32_rna(x.x - h.x), tf32_rna(x.y - h.y), tf32_rna(x.z - h.z),
                                 tf32_rna(x.w - h.w));
    *reinterpret_cast<float4*>(hi + row * Cp + k) = h;
    *reinterpret_cast<float4*>(lo + row * Cp + k) = l;
  } else {
    uint2 x = make_uint2(0u, 0u);
    if (k < C) x = __ldg(reinterpret_cast<const uint2*>(p));
    *reinterpret_cast<uint2*>(hi + row * Cp + k) = x;
  }
}

// One launch before the main kernel: both operands padded (and split), the
// keys set to 0 (below every pushed key), the encoded seconds to
// enc(−2e9). B0 (B1) batch entries of d0 (d1): 1 for a stride-0 operand.
template <typename T>
__global__ void prep_kernel(const T* __restrict__ d0, long long sd0, int B0, int N1,
                            const T* __restrict__ d1, long long sd1, int B1, int N2, int C,
                            int Cp, T* __restrict__ a_hi,
                            float* __restrict__ a_lo, T* __restrict__ b_hi,
                            float* __restrict__ b_lo, unsigned long long* __restrict__ rkey,
                            size_t nr, unsigned long long* __restrict__ ckey, size_t nc,
                            int* __restrict__ rsec, int* __restrict__ csec) {
  const size_t na = (size_t)B0 * N1 * (Cp / 4), nb = (size_t)B1 * N2 * (Cp / 4);
  const int e = enc(NEG2);
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < na + nb + nr + nc;
       t += (size_t)gridDim.x * blockDim.x) {
    if (t < na) {
      pad_split4(d0, sd0, N1, C, Cp, t, a_hi, a_lo);
    } else if (t < na + nb) {
      pad_split4(d1, sd1, N2, C, Cp, t - na, b_hi, b_lo);
    } else if (t < na + nb + nr) {
      rkey[t - na - nb] = 0ull;
      if (rsec) rsec[t - na - nb] = e;
    } else {
      ckey[t - na - nb - nr] = 0ull;
      if (csec) csec[t - na - nb - nr] = e;
    }
  }
}

// ---- shared-memory copies and wgmma -------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Chunk kc (128 bytes) of rows row0..row0+127 of a [n, pitch-byte] operand
// into a 16 KB tile at dst (1024-byte aligned), 128-byte swizzled: the
// 16-byte piece c of row r goes to r·128 + ((c ^ (r mod 8))·16). Rows past
// n are zero-filled.
__device__ __forceinline__ void load_tile(uint32_t dst, const uint8_t* src, int row0, int n,
                                          int pitch, int kc) {
#pragma unroll
  for (int q = 0; q < TILE * 8 / TC_THREADS; ++q) {
    const int idx = threadIdx.x + q * TC_THREADS;
    const int r = idx >> 3, c = idx & 7;
    const bool in = row0 + r < n;
    const uint8_t* g = in ? src + (size_t)(row0 + r) * pitch + kc * ROW_BYTES + c * 16 : src;
    cp_async16(dst + r * ROW_BYTES + ((c ^ (r & 7)) << 4), g, in ? 16u : 0u);
  }
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address, leading offset 16 B (unused for this layout),
// stride 1024 B between 8-row groups, layout 1 (128B swizzle).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define NN_TC_D64                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),            \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),            \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),            \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),            \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),            \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),            \
      "+f"(d[62]), "+f"(d[63])

#define NN_TC_REGS                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "     \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, " \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64×128 tile of this warpgroup] += A (64 × 8 tf32) · B (128 × 8 tf32)ᵀ.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " NN_TC_REGS
      ", %64, %65, p, 1, 1;\n}\n"
      : NN_TC_D64
      : "l"(da), "l"(db), "r"(1));
}

// d += A (64 × 16 bf16) · B (128 × 16 bf16)ᵀ, both K-major.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " NN_TC_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : NN_TC_D64
      : "l"(da), "l"(db), "r"(1));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma group.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Work item w of a block (one 128 × 128 tile of one batch entry) →
// (b, row0, col0), in grouped order: GROUP_M row tiles walk the column
// tiles together, so the blocks that run at once share their operands in L2.
__device__ __forceinline__ void tile_coords(int w, int tiles_m, int tiles_n, int& b, int& row0,
                                            int& col0) {
  const int per_pair = tiles_m * tiles_n;
  b = w / per_pair;
  const int p = w % per_pair, per_group = GROUP_M * tiles_n;
  const int first_m = p / per_group * GROUP_M;
  const int gsz = min(tiles_m - first_m, GROUP_M);
  row0 = (first_m + p % per_group % gsz) * TILE;
  col0 = p % per_group / gsz * TILE;
}

// The operand loads of one block: its work items' chunks in order, one
// commit group each, issued stages() − 1 chunks ahead of the MMA, across
// work items (the next tile's first chunks load under this one's
// epilogue). Stage tiles: A hi, B hi, then (f32) A lo, B lo.
template <bool F32>
struct Loader {
  const uint8_t *a_hi, *a_lo, *b_hi, *b_lo;
  long long sa, sb;
  int N1, N2, pitch, nk, tiles_m, tiles_n, total;
  uint32_t ring;
  int w, k, q;  // the next load: work item, chunk, sequence number

  __device__ __forceinline__ void issue() {
    if (w < total) {
      int b, row0, col0;
      tile_coords(w, tiles_m, tiles_n, b, row0, col0);
      constexpr int AB = 2 * TILE_BYTES;
      const uint32_t s = ring + (q % stages<F32>()) * stage_bytes<F32>();
      load_tile(s, a_hi + b * sa, row0, N1, pitch, k);
      load_tile(s + TILE_BYTES, b_hi + b * sb, col0, N2, pitch, k);
      if constexpr (F32) {
        load_tile(s + AB, a_lo + b * sa, row0, N1, pitch, k);
        load_tile(s + AB + TILE_BYTES, b_lo + b * sb, col0, N2, pitch, k);
      }
      if (++k == nk) {
        k = 0;
        w += gridDim.x;
      }
    }
    ++q;
    cp_async_commit();
  }
};

// d = this warpgroup's 64 rows of one tile over all nk chunks, the chunks
// numbered q0, q0 + 1, ... in the block's load sequence.
template <bool F32>
__device__ __forceinline__ void mma_tile(float (&d)[64], Loader<F32>& ld, int q0, int nk) {
  constexpr int STAGES = stages<F32>(), AB = 2 * TILE_BYTES;
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();  // chunk q0 + kc has landed (this thread's copies)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();  // everyone's copies, and the last chunk's wgmma is done with its stage
    ld.issue();
    const uint32_t s = ld.ring + ((q0 + kc) % STAGES) * stage_bytes<F32>();
    const uint32_t a = s + wg * 64 * ROW_BYTES, b = s + TILE_BYTES;
    fence_operands(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < ROW_BYTES / 32; ++k) {  // one wgmma depth (32 bytes) at a time
      if constexpr (F32) {
        wgmma_tf32(d, desc_sw128(a + AB + 32 * k), desc_sw128(b + 32 * k));
        wgmma_tf32(d, desc_sw128(a + 32 * k), desc_sw128(b + AB + 32 * k));
        wgmma_tf32(d, desc_sw128(a + 32 * k), desc_sw128(b + 32 * k));
      } else {
        wgmma_bf16(d, desc_sw128(a + 32 * k), desc_sw128(b + 32 * k));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(d);
  }
}

// ---- the epilogue's merges ----------------------------------------------

// (v, vi) ← the larger of (v, vi) and (ov, oi), the lower index on a tie.
__device__ __forceinline__ void take_max(float& v, int& vi, float ov, int oi) {
  if (ov > v || (ov == v && oi < vi)) {
    v = ov;
    vi = oi;
  }
}

// Multiset top-2 with index: (v, vi, v2) ⊕ (ov, oi, ov2).
__device__ __forceinline__ void take_top2(float& v, int& vi, float& v2, float ov, int oi,
                                          float ov2) {
  v2 = fmaxf(fminf(v, ov), fmaxf(v2, ov2));
  take_max(v, vi, ov, oi);
}

// Merge across the lanes `off` apart for off in masks (shuffles).
template <bool TOP2>
__device__ __forceinline__ void lane_merge(float& v, int& vi, float& v2, int off) {
  const float ov = __shfl_xor_sync(0xffffffffu, v, off);
  const int oi = __shfl_xor_sync(0xffffffffu, vi, off);
  if (TOP2) {
    const float ov2 = __shfl_xor_sync(0xffffffffu, v2, off);
    take_top2(v, vi, v2, ov, oi, ov2);
  } else {
    take_max(v, vi, ov, oi);
  }
}

// TOP2's second value of one push: the tile's own second and whichever key
// lost the atomicMax (none while `old` is the zero sentinel).
__device__ __forceinline__ void push_second(int* second, unsigned long long mine,
                                            unsigned long long old, float v2) {
  if (old != 0ull) v2 = fmaxf(v2, key_value(old < mine ? old : mine));
  atomicMax(second, enc(v2));
}

// Push one tile's (max, argmax[, second]) of a row or column.
template <bool TOP2>
__device__ __forceinline__ void push(unsigned long long* key, int* second, float v, int index,
                                     float v2) {
  const unsigned long long mine = pack_key(v, index);
  const unsigned long long old = atomicMax(key, mine);
  if (TOP2) push_second(second, mine, old, v2);
}

// A persistent block: work items blockIdx.x, + gridDim.x, ... (tiles of S
// of every batch entry), each the product, both reductions and their
// atomics. rsec/csec (TOP2 only) hold encoded second values until the
// last pass decodes them.
template <bool F32, bool TOP2>
__global__ void __launch_bounds__(TC_THREADS, 1)
nn_tc_kernel(const uint8_t* __restrict__ a_hi, const uint8_t* __restrict__ a_lo, long long sa,
             const uint8_t* __restrict__ b_hi, const uint8_t* __restrict__ b_lo, long long sb,
             const uint8_t* __restrict__ v0, const uint8_t* __restrict__ v1, long long sv0,
             long long sv1, int N1, int N2, int pitch, int nk, int tiles_m, int tiles_n, int B,
             unsigned long long* __restrict__ rkey, unsigned long long* __restrict__ ckey,
             int* __restrict__ rsec, int* __restrict__ csec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle atoms need 1024-byte alignment
  float* tile_s = reinterpret_cast<float*>(smem_raw + (ring - raw) +
                                           stages<F32>() * stage_bytes<F32>());  // [TILE][TP]
  float* rb_s = tile_s + TILE * TP;                                            // [TILE]
  float* cb_s = rb_s + TILE;                                                   // [TILE]
  const int tid = threadIdx.x;
  const int total = B * tiles_m * tiles_n;

  Loader<F32> ld{a_hi, a_lo, b_hi, b_lo, sa, sb, N1, N2, pitch, nk, tiles_m, tiles_n, total,
                 ring, (int)blockIdx.x, 0, 0};
#pragma unroll
  for (int s = 0; s < stages<F32>() - 1; ++s) ld.issue();

  int q0 = 0;
  for (int w = blockIdx.x; w < total; w += gridDim.x, q0 += nk) {
    int b, row0, col0;
    tile_coords(w, tiles_m, tiles_n, b, row0, col0);

    // Biases (+0 / −1e9 on invalid rows and columns, −inf outside N1 ×
    // N2): one per thread, loaded now and stored after the product, so the
    // load waits under the MMA.
    static_assert(2 * TILE == TC_THREADS, "one bias per thread");
    const bool is_row = tid < TILE;
    const int bi = is_row ? row0 + tid : col0 + tid - TILE;
    const bool in = bi < (is_row ? N1 : N2);
    const bool valid = in && (is_row ? v0[b * sv0 + bi] : v1[b * sv1 + bi]);

    float d[64];
    mma_tile<F32>(d, ld, q0, nk);

    rb_s[tid] = in ? (valid ? 0.f : NEG) : -INFINITY;  // cb_s follows rb_s
    __syncthreads();

    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16 + g;  // rows r0 (h = 0) and r0 + 8 (h = 1) of the tile

    // Rows: s + column bias over the tile's columns, ascending, in registers.
    // K6 finishes the rows' second values after the columns' scan, so the
    // key atomics' round trips overlap it.
    unsigned long long rmine[2], rold[2];
    float rsec2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = -INFINITY, v2 = NEG2;
      int vi = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = 8 * i + 2 * t + c;
          const float s = d[4 * i + 2 * h + c] + cb_s[j];
          if (s > v) {  // ascending j: strict > keeps the first
            if (TOP2) v2 = fmaxf(v2, v);
            v = s;
            vi = j;
          } else if (TOP2) {
            v2 = fmaxf(v2, s);
          }
        }
      lane_merge<TOP2>(v, vi, v2, 1);
      lane_merge<TOP2>(v, vi, v2, 2);
      const int gi = row0 + r0 + 8 * h;
      rmine[h] = pack_key(v, col0 + vi);
      rsec2[h] = v2;
      if (t == 0 && gi < N1) rold[h] = atomicMax(rkey + (size_t)b * N1 + gi, rmine[h]);
    }

    // Columns: s + row bias, written to shared memory and scanned down each
    // column, rows ascending: thread (j, half) scans rows 64·half ..
    // 64·half + 63 of column j, then the halves merge.
    const float rb0 = rb_s[r0], rb1 = rb_s[r0 + 8];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = 8 * i + 2 * t;
      float2* lo = reinterpret_cast<float2*>(tile_s + r0 * TP + j);
      float2* hi = reinterpret_cast<float2*>(tile_s + (r0 + 8) * TP + j);
      *lo = make_float2(d[4 * i] + rb0, d[4 * i + 1] + rb0);
      *hi = make_float2(d[4 * i + 2] + rb1, d[4 * i + 3] + rb1);
    }
    __syncthreads();
    const int j = tid % TILE, half = tid / TILE;
    float v = -INFINITY, v2 = NEG2;
    int vi = 0;
#pragma unroll 8
    for (int r = half * (TILE / 2); r < (half + 1) * (TILE / 2); ++r) {
      const float x = tile_s[r * TP + j];
      if (x > v) {  // ascending rows: strict > keeps the first
        if (TOP2) v2 = fmaxf(v2, v);
        v = x;
        vi = r;
      } else if (TOP2) {
        v2 = fmaxf(v2, x);
      }
    }
    if (TOP2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gi = row0 + r0 + 8 * h;
        if (t == 0 && gi < N1) push_second(rsec + (size_t)b * N1 + gi, rmine[h], rold[h], rsec2[h]);
      }
    }
    __syncthreads();  // the tile is read: its first rows take the upper halves' partials
    float* part_v = tile_s;
    int* part_i = reinterpret_cast<int*>(tile_s + TILE);
    float* part_2 = tile_s + 2 * TILE;
    if (half == 1) {
      part_v[j] = v;
      part_i[j] = vi;
      if (TOP2) part_2[j] = v2;
    }
    __syncthreads();
    if (half == 0 && col0 + j < N2) {
      const float ov = part_v[j];
      if (TOP2) v2 = fmaxf(fminf(v, ov), fmaxf(v2, part_2[j]));
      if (ov > v) {  // the upper half's rows come later: strict >
        v = ov;
        vi = part_i[j];
      }
      const int gj = col0 + j;
      push<TOP2>(ckey + (size_t)b * N2 + gj, TOP2 ? csec + (size_t)b * N2 + gj : nullptr, v,
                 row0 + vi, v2);
    }
  }
}

// Keys to (max, argmax); encoded seconds to floats, in place.
__global__ void unpack_kernel(const unsigned long long* __restrict__ rkey, size_t nr,
                              float* __restrict__ rmax, int* __restrict__ ridx, float* rsec,
                              const unsigned long long* __restrict__ ckey, size_t nc,
                              float* __restrict__ cmax, int* __restrict__ cidx, float* csec) {
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < nr + nc;
       t += (size_t)gridDim.x * blockDim.x) {
    const bool row = t < nr;
    const size_t u = row ? t : t - nr;
    const unsigned long long k = row ? rkey[u] : ckey[u];
    (row ? rmax : cmax)[u] = key_value(k);
    (row ? ridx : cidx)[u] = key_index(k);
    float* sec = row ? rsec : csec;
    if (sec) sec[u] = dec(reinterpret_cast<int*>(sec)[u]);
  }
}

// The part every matcher (K2, K4, K5, K6) shares: the pre-pass and the
// persistent main kernel, which leave the merged keys in rkey [B, N1] and
// ckey [B, N2] and, for TOP2, the encoded second values in rsec/csec (null
// otherwise). Each kernel's .cu then launches its own last pass over them.
// Batch strides (sd*, sv*) in elements; 0 broadcasts one operand to every
// batch entry. op0/op1: the padded (and, for f32, split) operands, sized by
// the wrapper: [B or 1, N, Cp] elements of T, twice for f32 (hi, then lo).
template <typename T, bool TOP2>
int nn_tc_run(const T* d0, const T* d1, const uint8_t* v0, const uint8_t* v1, long long sd0,
              long long sd1, long long sv0, long long sv1, int B, int N1, int N2, int C,
              void* op0, void* op1, unsigned long long* rkey, unsigned long long* ckey, int* rsec,
              int* csec, cudaStream_t stream) {
  constexpr bool F32 = sizeof(T) == 4;
  const int Cp = nn_tc_padded_width(C, (int)sizeof(T));
  const int pitch = Cp * (int)sizeof(T);
  const int B0 = sd0 ? B : 1, B1 = sd1 ? B : 1;
  T* a_hi = static_cast<T*>(op0);
  T* b_hi = static_cast<T*>(op1);
  float* a_lo = F32 ? reinterpret_cast<float*>(a_hi + (size_t)B0 * N1 * Cp) : nullptr;
  float* b_lo = F32 ? reinterpret_cast<float*>(b_hi + (size_t)B1 * N2 * Cp) : nullptr;
  const size_t nr = (size_t)B * N1, nc = (size_t)B * N2;

  const size_t rows = (size_t)B0 * N1 + (size_t)B1 * N2;
  prep_kernel<T><<<grid_for(rows * Cp / 4 + nr + nc), 256, 0, stream>>>(
      d0, sd0, B0, N1, d1, sd1, B1, N2, C, Cp, a_hi, a_lo, b_hi, b_lo, rkey, nr, ckey, nc, rsec,
      csec);

  constexpr int smem = tc_smem_bytes<F32>();
  // Per launch, not once per process: the attribute belongs to the current
  // device.
  cudaError_t err = cudaFuncSetAttribute(nn_tc_kernel<F32, TOP2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles_m = (N1 + TILE - 1) / TILE, tiles_n = (N2 + TILE - 1) / TILE;
  const long long total = (long long)B * tiles_m * tiles_n;  // one block per SM, persistent
  const auto* ah = reinterpret_cast<const uint8_t*>(a_hi);
  const auto* bh = reinterpret_cast<const uint8_t*>(b_hi);
  nn_tc_kernel<F32, TOP2><<<(unsigned)(total < sms ? total : sms), TC_THREADS, smem, stream>>>(
      ah, reinterpret_cast<const uint8_t*>(a_lo), sd0 ? (long long)N1 * pitch : 0, bh,
      reinterpret_cast<const uint8_t*>(b_lo), sd1 ? (long long)N2 * pitch : 0, v0, v1, sv0, sv1,
      N1, N2, pitch, pitch / ROW_BYTES, tiles_m, tiles_n, B, rkey, ckey, rsec, csec);
  return (int)cudaGetLastError();
}

// K5's and K6's last pass: nn_tc_run, then the keys unpacked to (max,
// argmax) and, for K6, the seconds decoded in place (rsec/csec are the
// float outputs, holding encoded ints until unpack_kernel; null for K5).
template <typename T, bool TOP2>
int nn_tc_launch(const T* d0, const T* d1, const uint8_t* v0, const uint8_t* v1, long long sd0,
                 long long sd1, long long sv0, long long sv1, int B, int N1, int N2, int C,
                 void* op0, void* op1, unsigned long long* rkey, unsigned long long* ckey,
                 float* rmax, int* ridx, float* rsec, float* cmax, int* cidx, float* csec,
                 cudaStream_t stream) {
  const int err = nn_tc_run<T, TOP2>(d0, d1, v0, v1, sd0, sd1, sv0, sv1, B, N1, N2, C, op0, op1,
                                     rkey, ckey, reinterpret_cast<int*>(rsec),
                                     reinterpret_cast<int*>(csec), stream);
  if (err != 0) return err;
  const size_t nr = (size_t)B * N1, nc = (size_t)B * N2;
  unpack_kernel<<<grid_for(nr + nc), 256, 0, stream>>>(rkey, nr, rmax, ridx, rsec, ckey, nc, cmax,
                                                        cidx, csec);
  return (int)cudaGetLastError();
}

}  // namespace
