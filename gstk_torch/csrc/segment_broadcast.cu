// Sorted-boundary segment broadcast (kernel K3).
//
// Replaces gstk_tpu/ops/segment_kernel.py::_seg_kernel, launched there by
// segment_broadcast. For boundaries b sorted nondecreasing it computes
//
//     out_c[j] = sum_{i : b[i] <= j} d_c[i]   (mod 2^32),   j in [0, length)
//
// for up to three int32 columns. The wrapper passes the inclusive prefix
// prefix_c[i] = d_c[0] + ... + d_c[i] (mod 2^32), so the sum above is
// prefix_c[i* - 1] with i* = #{i : b[i] <= j}, or 0 when i* = 0. Binning uses
// it to give every intersection slot the id of the Gaussian that owns it.
//
// Design: one thread per output slot; an upper-bound binary search over b
// (clamped to length, as the TPU wrapper clamps) finds i*, and the thread
// writes that entry of each prefix column. Every slot is written, so the
// output needs no zero fill. All arithmetic is uint32: the values wrap
// modulo 2^32 on purpose, and signed overflow is undefined in C++.
//
// Bound: bytes. The function reads b and the columns once (4 B each per
// boundary) and writes 4 B per slot and column; it does a log2(N)-step
// search per slot and no other arithmetic. This first design does nothing
// about the bound yet: the searches re-read b through L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) segment_broadcast_kernel(
    const int32_t* __restrict__ b, int n,
    const uint32_t* __restrict__ prefix,  // (ncols, n)
    int ncols,
    uint32_t* __restrict__ out,  // (ncols, length)
    int length) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= length) return;
  int lo = 0, hi = n;  // first i with min(b[i], length) > j
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int bm = min(__ldg(b + mid), length);
    if (bm <= j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  for (int c = 0; c < ncols; ++c) {
    const uint32_t v = lo > 0 ? __ldg(prefix + (size_t)c * n + lo - 1) : 0u;
    out[(size_t)c * length + j] = v;
  }
}

}  // namespace

extern "C" int gstk_segment_broadcast(const void* b, int n, const void* prefix,
                                      int ncols, void* out, int length,
                                      void* stream) {
  if (length <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (length + kThreads - 1) / kThreads;
  segment_broadcast_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(b), n,
      static_cast<const uint32_t*>(prefix), ncols,
      static_cast<uint32_t*>(out), length);
  return static_cast<int>(cudaGetLastError());
}
