// Segment sums at sorted boundaries (kernel K4).
//
// Replaces gstk_tpu/ops/segment_kernel.py::_segsum_kernel, launched there by
// segment_sum_sorted. For segment ends hi (N,) nondecreasing and clipped to
// [0, Np] (hi[-1] = 0):
//
//     out[c, g] = sum_{hi[g-1] <= j < hi[g]} vals[j, c],   vals (Np, rows)
//
// The values are entry-major: entry j's `rows` values are contiguous, the
// layout of the backward's per-intersection rows once they are gathered into
// expansion (Gaussian-major) order. A Gaussian's segment is then one
// contiguous span of len * rows floats, and so is a run of consecutive
// Gaussians.
//
// Bound: bytes. The function reads each covered value once (4 rows Np B at
// most), hi once (4 N B) and writes 4 rows N B; it does one add per value.
// At the training point a segment averages about 7 entries (280 B at
// rows = 10), too short to give a warp's lanes one entry each.
//
// Design: a CTA of kThreads threads takes as many consecutive Gaussians. It
// copies their whole span into shared memory with 16-B cp.async, every
// thread issuing all of its copies before any of them waits, so the CTA has
// its span in flight at once and every load is a full, aligned 16 B. Then
// each thread sums its own Gaussian's segment from shared memory, row by
// row in entry order, and each row's 32 sums of a warp leave as one 128-B
// store. A segment longer than kShort entries goes to its warp instead: the
// lanes stride its entries, sum in registers and reduce by a fixed shuffle
// tree, so no thread runs a long serial sum while its warp waits and no sum
// runs more than about kShort terms in sequence on the short path. A span
// larger than the staging buffer is read from global memory by the same two
// paths. Every sum has a fixed order and there are no atomics: the result is
// the same bit for bit on every run. Empty segments write zeros.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

constexpr int kThreads = 128;  // Gaussians per CTA, one a thread
constexpr int kShort = 32;     // the longest segment a thread sums alone
constexpr int kStageBytes = 64 * 1024;  // dynamic shared memory per CTA
constexpr long long kStageFloats = kStageBytes / 4;
constexpr int kRowsPerPass = 16;  // f32 sums a lane holds in registers
constexpr unsigned kFull = 0xffffffffu;

// One thread: the `rows` sums of the segment of `len` entries at `src`.
__device__ __forceinline__ void thread_sums(const float* src, int len,
                                            int rows, float* out, int n,
                                            int g) {
  for (int r = 0; r < rows; ++r) {
    const float* p = src + r;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = 0; k < len; ++k, p += rows) acc += *p;
    out[(size_t)r * n + g] = acc;
  }
}

// One warp: the lanes stride the segment's entries, then a shuffle tree in
// fixed order reduces each row and lane 0 writes it.
__device__ __forceinline__ void warp_sums(const float* src, int len,
                                          int rows, float* out, int n, int g,
                                          int lane) {
  for (int r0 = 0; r0 < rows; r0 += kRowsPerPass) {
    float acc[kRowsPerPass];
#pragma unroll
    for (int r = 0; r < kRowsPerPass; ++r) acc[r] = 0.0f;
    for (int k = lane; k < len; k += 32) {
      const float* e = src + (size_t)k * rows + r0;
#pragma unroll
      for (int r = 0; r < kRowsPerPass; ++r) {
        if (r0 + r < rows) acc[r] += e[r];
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

__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const float* __restrict__ vals,  // (np, rows), entry-major
    int rows, int np,
    const int32_t* __restrict__ hi,  // (n,) nondecreasing, in [0, np]
    int n,
    float* __restrict__ out) {       // (rows, n)
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int g0 = blockIdx.x * kThreads;
  const int g = g0 + t;
  const int lo = g > 0 && g < n ? __ldg(hi + g - 1) : 0;
  const int len = g < n ? max(__ldg(hi + g) - lo, 0) : 0;
  const int base = g0 > 0 ? __ldg(hi + g0 - 1) : 0;
  const int top = __ldg(hi + min(g0 + kThreads, n) - 1);

  // The CTA's span is floats [fs, fe) of vals. A float f starts a 16-B
  // vector where (f + mis) % 4 == 0; a0 is the last such float at or before
  // fs, and float f is staged at stage[f - a0], so vectors land aligned.
  const long long fs = (long long)base * rows;
  const long long fe = (long long)max(top, base) * rows;
  const int mis = (int)((reinterpret_cast<uintptr_t>(vals) >> 2) & 3);
  const long long a0 = ((fs + mis) & ~3LL) - mis;
  const bool staged = fe - a0 <= kStageFloats;  // uniform over the CTA
  if (staged) {
    const long long vs = a0 < fs ? a0 + 4 : a0;      // first vector >= fs
    const long long ve = ((fe + mis) & ~3LL) - mis;  // vectors end <= fe
    if (vs <= ve) {
      const int nvec = (int)((ve - vs) >> 2);
      const float4* src = reinterpret_cast<const float4*>(vals + vs);
      float4* dst = reinterpret_cast<float4*>(stage + (vs - a0));
      for (int v = t; v < nvec; v += kThreads) {
        gstk::cp_async16(dst + v, src + v, true);
      }
      if (t < vs - fs) stage[fs + t - a0] = vals[fs + t];
      if (t < fe - ve) stage[ve + t - a0] = vals[ve + t];
    } else {  // fewer than 4 floats, inside one vector
      if (t < fe - fs) stage[fs + t - a0] = vals[fs + t];
    }
    gstk::cp_async_commit();
    gstk::cp_async_wait<0>();
    __syncthreads();
  }
  // a thread reads the staged copy only where its segment lies in the span
  const bool here = staged && lo >= base && lo + len <= top;

  if (g < n && len <= kShort) {
    if (here) {
      thread_sums(stage + ((long long)lo * rows - a0), len, rows, out, n, g);
    } else {
      thread_sums(vals + (size_t)lo * rows, len, rows, out, n, g);
    }
  }
  unsigned longs = __ballot_sync(kFull, g < n && len > kShort);
  while (longs) {
    const int i = __ffs(longs) - 1;
    longs &= longs - 1;
    const int gl = g0 + (t & ~31) + i;
    const int llo = __shfl_sync(kFull, lo, i);
    const int llen = __shfl_sync(kFull, len, i);
    if (__shfl_sync(kFull, here, i)) {
      warp_sums(stage + ((long long)llo * rows - a0), llen, rows, out, n, gl,
                lane);
    } else {
      warp_sums(vals + (size_t)llo * rows, llen, rows, out, n, gl, lane);
    }
  }
}

}  // namespace

extern "C" int gstk_segment_sum(const void* vals, int rows, int np,
                                const void* hi, int n, void* out,
                                void* stream) {
  if (n <= 0 || rows <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaFuncSetAttribute(
      segment_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStageBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  segment_sum_kernel<<<blocks, kThreads, kStageBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), rows, np,
      static_cast<const int32_t*>(hi), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
