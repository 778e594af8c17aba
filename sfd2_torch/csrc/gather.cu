// K3 — row gather for Hopper (sm_90a), plain C interface.
//
// Replaces: sfd2_tpu/ops/pallas_gather.py::gather_rows_pallas (_make_kernel,
// _group_bounds), reached from sfd2_tpu/sfm/ba.py's camera and point block
// gathers.
// Contract: sfd2_torch/ops/gather.py::gather_rows_plain —
//   out[m, k] = table[idx[m], k] for a float32 table [N, C], C <= 16, and
//   int32 idx [M]; an index outside [0, N) gives NaN (no read out of bounds).
//
// What bounds it on this card: bytes, and at bundle-adjustment sizes the
// launch itself. BA gathers ~1.4e5 observations at C in {1, 3, 6, 8, 9}:
// about 2 MB in and out, under a microsecond of HBM traffic.
//
// Design: the TPU kernel walked the table in 128-row chunks because Mosaic
// gathers only inside one vector register; Hopper gathers from any address,
// so this is one pass with one thread per output element (M×C of them, in
// a grid-stride loop). Neighbouring threads write neighbouring outputs
// (coalesced stores); the C threads of one row read the same index and
// neighbouring table words through the read-only cache. Sorted indices
// (BA's point gathers) make the table reads nearly sequential; nothing in
// the kernel depends on it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

__global__ void __launch_bounds__(THREADS)
gather_kernel(const float* __restrict__ table, const int* __restrict__ idx, long long n,
              long long total, int c, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long t = blockIdx.x * (long long)THREADS + threadIdx.x; t < total; t += stride) {
    const long long m = t / c;
    const int k = (int)(t - m * c);
    const int r = __ldg(idx + m);
    out[t] = (r >= 0 && r < n) ? __ldg(table + (long long)r * c + k) : __int_as_float(0x7fc00000);
  }
}

}  // namespace

extern "C" int sfd2_gather_rows(const float* table, const int* idx, long long n, long long m,
                                int c, float* out, void* stream) {
  const long long total = m * c;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  gather_kernel<<<(unsigned)blocks, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      table, idx, n, total, c, out);
  return (int)cudaGetLastError();
}

extern "C" const char* sfd2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
