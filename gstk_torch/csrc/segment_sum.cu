// Segment sums at sorted boundaries (kernel K4).
//
// Replaces gstk_tpu/ops/segment_kernel.py::_segsum_kernel, launched there by
// segment_sum_sorted. For segment ends hi (N,) nondecreasing and clipped to
// Np (hi[-1] = 0):
//
//     out[c, g] = sum_{hi[g-1] <= j < hi[g]} vals[c, j],   vals (rows, Np)
//
// The backward pass uses it to sum each Gaussian's per-intersection
// gradients, which are contiguous in expansion (Gaussian-major) order.
//
// Design: one warp per segment. The lanes stride the segment's entries
// (neighbouring lanes on neighbouring addresses of one row) and sum up to 16
// rows at a time in f32 registers; then a shuffle tree in fixed order
// reduces the 32 lanes and lane 0 writes the segment's column. No atomics
// and a fixed order, so the result is the same bit for bit on every run.
// Empty segments (dead or invisible Gaussians) write zeros.
//
// Bound: bytes. The function reads each covered value once (4 rows Np B at
// most), hi once (4 N B) and writes 4 rows N B; it does one add per value.
// This first design does nothing about the bound yet: a segment averages a
// few entries, so most lanes of a warp idle, and each row is a separate
// strided read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerPass = 16;  // f32 sums held in registers per pass
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const float* __restrict__ vals,  // (rows, np)
    int rows, int np,
    const int32_t* __restrict__ hi,  // (n,) nondecreasing segment ends
    int n,
    float* __restrict__ out) {       // (rows, n)
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= n) return;  // g is uniform across the warp
  const int lo = g > 0 ? min(max(__ldg(hi + g - 1), 0), np) : 0;
  const int end = min(__ldg(hi + g), np);
  for (int r0 = 0; r0 < rows; r0 += kRowsPerPass) {
    float acc[kRowsPerPass];
#pragma unroll
    for (int r = 0; r < kRowsPerPass; ++r) acc[r] = 0.0f;
    for (int j = lo + lane; j < end; j += 32) {
#pragma unroll
      for (int r = 0; r < kRowsPerPass; ++r) {
        if (r0 + r < rows) acc[r] += __ldg(vals + (size_t)(r0 + r) * np + j);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerPass; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[r] += __shfl_down_sync(kFull, acc[r], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRowsPerPass; ++r) {
        if (r0 + r < rows) out[(size_t)(r0 + r) * n + g] = acc[r];
      }
    }
  }
}

}  // namespace

extern "C" int gstk_segment_sum(const void* vals, int rows, int np,
                                const void* hi, int n, void* out,
                                void* stream) {
  if (n <= 0 || rows <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n + kWarps - 1) / kWarps;
  segment_sum_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), rows, np,
      static_cast<const int32_t*>(hi), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
