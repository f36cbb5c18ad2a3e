// Sorted-boundary segment broadcast (kernel K3).
//
// Replaces gstk_tpu/ops/segment_kernel.py::_seg_kernel, launched there by
// segment_broadcast. For boundaries b sorted nondecreasing it computes
//
//     out_c[j] = sum_{i : b[i] <= j} d_c[i]   (mod 2^32),   j in [0, length)
//
// for up to three int32 columns. The wrapper passes the inclusive prefix
// prefix_c[i] = d_c[0] + ... + d_c[i] (mod 2^32), so the sum above is
// prefix_c[p(j) - 1] with p(j) = #{i : b[i] <= j}, or 0 when p(j) = 0.
// Binning uses it to give every intersection slot the id of the Gaussian
// that owns it. b is clamped to [0, length], as the TPU wrapper clamps it
// to length (b >= 0 is the contract).
//
// Bound: bytes. The function reads b and the columns once (4 B each per
// boundary) and writes 4 B per slot and column; the count p(j) is a search,
// and no other arithmetic.
//
// Design: the work is cut by boundaries, not by slots, so no CTA searches
// global memory. A CTA owns a run of kBounds consecutive boundaries
// [i0, i0 + m) and so the slots [b[i0 - 1], b[i0 + m - 1]) (b[-1] = 0):
// every slot there has p(j) = i0 + #{k < m : b[i0 + k] <= j}. The CTA
// loads its run of b and of each prefix column into shared memory, one
// coalesced round, then each thread counts four consecutive slots against
// the run by a branch-free search, the four interleaved, and writes each
// column's four values as one 16-B store (single stores where the slots'
// group straddles a run's end). The slots past the last boundary belong to
// tail CTAs of kTailSlots slots each, which search nothing: they all take
// prefix_c[n - 1], and the tail CTAs short of the last boundary exit at
// once. So every CTA's path is one load round and a search of at most
// log2(kBounds) steps in shared memory. All arithmetic is uint32: the
// values wrap modulo 2^32 on purpose, and signed overflow is undefined in
// C++.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBounds = 64;       // boundaries a CTA owns
constexpr int kTailSlots = 4096;  // slots a tail CTA covers
constexpr int kMaxCols = 3;

__global__ void __launch_bounds__(kThreads) segment_broadcast_kernel(
    const int32_t* __restrict__ b, int n,
    const uint32_t* __restrict__ prefix,  // (ncols, n)
    int ncols,
    uint32_t* __restrict__ out,  // (ncols, length)
    int length, int runs) {
  // the run b[i0 - 1 .. i0 + m - 1], clamped, and prefix_c[i0 - 1 + k]
  __shared__ int32_t run_b[kBounds + 1];
  __shared__ uint32_t run_prefix[kMaxCols][kBounds + 1];
  const int t = threadIdx.x;
  int m, s0, s1;  // the CTA's boundaries and its slots [s0, s1)
  if (blockIdx.x < runs) {
    const int i0 = blockIdx.x * kBounds;
    m = min(kBounds, n - i0);
    for (int k = t; k <= m; k += kThreads) {
      const int i = i0 - 1 + k;
      run_b[k] = i >= 0 ? min(max(__ldg(b + i), 0), length) : 0;
      for (int c = 0; c < ncols; ++c) {
        run_prefix[c][k] = i >= 0 ? __ldg(prefix + (size_t)c * n + i) : 0u;
      }
    }
    __syncthreads();
    s0 = run_b[0];
    s1 = run_b[m];
  } else {
    const int j0 = (blockIdx.x - runs) * kTailSlots;
    s0 = max(j0, n > 0 ? min(__ldg(b + n - 1), length) : 0);  // j0 >= 0
    s1 = j0 + min(kTailSlots, length - j0);
    if (s0 >= s1) return;  // uniform over the CTA
    m = 0;
    if (t < ncols) {
      run_prefix[t][0] = n > 0 ? __ldg(prefix + (size_t)t * n + n - 1) : 0u;
    }
    __syncthreads();
  }

  const int32_t* bounds = run_b + 1;
  const int top = m > 0 ? 1 << (31 - __clz(m)) : 0;
  for (int j = (s0 & ~3) + 4 * t; j < s1; j += 4 * kThreads) {
    int p[4] = {0, 0, 0, 0};  // p(j + q) - i0
    for (int step = top; step > 0; step >>= 1) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int at = p[q] + step;
        if (at <= m && bounds[at - 1] <= j + q) p[q] = at;
      }
    }
    const bool whole = j >= s0 && j + 4 <= s1;
    for (int c = 0; c < ncols; ++c) {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = run_prefix[c][p[q]];
      uint32_t* row = out + (size_t)c * length;
      if (whole && ((size_t)c * length) % 4 == 0) {
        *reinterpret_cast<uint4*>(row + j) = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (j + q >= s0 && j + q < s1) row[j + q] = v[q];
        }
      }
    }
  }
}

}  // namespace

extern "C" int gstk_segment_broadcast(const void* b, int n, const void* prefix,
                                      int ncols, void* out, int length,
                                      void* stream) {
  if (length <= 0) return static_cast<int>(cudaSuccess);
  if (ncols < 1 || ncols > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int runs = (n + kBounds - 1) / kBounds;
  const int tails = (length + kTailSlots - 1) / kTailSlots;
  segment_broadcast_kernel<<<runs + tails, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(b), n,
      static_cast<const uint32_t*>(prefix), ncols,
      static_cast<uint32_t*>(out), length, runs);
  return static_cast<int>(cudaGetLastError());
}
